"""Quantized (compressed) vector search (port of
``weaviate_tpu/ops/quantized.py``).

- **BQ**: hamming(q, x) = |q| + |x| - 2 q.x over {0,1} bit planes; corpus
  bits stay packed (uint32 words, held as int32 tensors) in device memory.
- **SQ**: asymmetric float-query x byte-code distance: decode(c) = a + s*c,
  so q.decode(c) = s*(q.c) + a*sum(q), one product + an affine epilogue.
- **PQ**: the codes are decoded through the codebooks and multiplied:
  bf16(q) . bf16(decode(c)) with float32 sums.
- **RQ**: rotated query x per-row affine byte codes: q.decode(c) =
  step_x*(q.c) + lower_x*sum(q).

Every scan has a hand-written CUDA kernel (``csrc/quantized.cu``) on the
tensor cores: Q1, the BQ scan (``bq_search``), Q2, the SQ scan
(``sq_search``), Q3, the PQ scan (``pq_search``), and Q4, the RQ scan
(``rq_search``); Q2-Q4 are one warp-specialized ``wgmma`` template that
holds 256 queries a CTA. Each keeps an exact top-``k`` in its epilogue: a
CTA walks a split of the rows for a tile of queries and leaves each
query's ``k`` smallest (order key, row) of the split in a list, [splits,
B, cap] (``scan_plan``; Q2-Q4 take only rows below a bound the splits
share, which drops no row of the answer: ``split_partials_bounded_plain``
models it); the merge (``merge_partials``) takes the [splits, k] partials
of each query down to ``k``. A search is one scan launch and one
merge launch, whatever its B (``search_launches``). Each search returns
the exact top-``k`` of its distances by (distance, id), the order the JAX
package's chunked ``lax.top_k`` + ``merge_topk`` gives: lower id first on
ties, masked rows at ``MASK_DISTANCE`` with id -1, and rows past the corpus
padded the same way. The plain PyTorch versions (``_bq_search_plain``,
``_sq_search_plain``, ``_pq_search_plain``, ``_rq_search_plain``) are the
JAX programs step for step; each wrapper takes
its plain version for CPU tensors only, and on the card launches the kernel
or raises. BQ distances are exact integers in float32 on both sides: the
plain version unpacks the bits and multiplies, as JAX does (torch has no
popcount), the kernel multiplies the packed bits. The frontier gathers stay
torch ops: they serve the host walk, the fallback tier of the HNSW index.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import re
from pathlib import Path
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from weaviate_tpu_torch.ops.distance import MASK_DISTANCE
from weaviate_tpu_torch.ops.topk import merge_topk, smallest_k

KERNEL = "quantized"
# the metrics of the SQ, PQ and RQ scans
SQ_METRICS = ("l2-squared", "dot", "cosine")
# the widest rows and the largest k the kernels take
MAX_DIMS = 4096
MAX_K = 4096


# ---------------------------------------------------------------------------
# bit packing
# ---------------------------------------------------------------------------


def pack_bits_host(bits: np.ndarray) -> np.ndarray:
    """[N, D] {0,1} -> [N, ceil(D/32)] uint32 (little-endian bit order)."""
    bits = np.asarray(bits, np.uint32)
    n, d = bits.shape
    w = (d + 31) // 32
    padded = np.zeros((n, w * 32), np.uint32)
    padded[:, :d] = bits
    shifts = np.arange(32, dtype=np.uint32)
    return (padded.reshape(n, w, 32) << shifts[None, None, :]).sum(
        axis=-1, dtype=np.uint32
    )


def unpack_bits(packed: torch.Tensor, dims: int) -> torch.Tensor:
    """[..., W] int32 words -> [..., dims] bf16 {0,1}."""
    shifts = torch.arange(32, dtype=torch.int32, device=packed.device)
    bits = (packed.to(torch.int32)[..., None] >> shifts) & 1
    flat = bits.reshape(*packed.shape[:-1], packed.shape[-1] * 32)
    return flat[..., :dims].to(torch.bfloat16)


# ---------------------------------------------------------------------------
# the plain chunked top-k
# ---------------------------------------------------------------------------


def _chunked_topk(
    score_fn: Callable[[int, int], torch.Tensor],
    n: int,
    b: int,
    k: int,
    chunk: int,
    mask: Optional[torch.Tensor],
    device,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k smallest of score_fn over [0, n) evaluated in chunks (JAX
    ``_chunked_topk``; selections are stable sorts, so ties keep the lower
    id). ``score_fn(start, size)`` -> [B, size] distances."""

    def block(start, size):
        d = score_fn(start, size)
        if mask is not None:
            d = torch.where(mask[start:start + size][None, :], d,
                            MASK_DISTANCE)
        kk = min(k, size)
        vals, idx = smallest_k(d, kk)
        ids = idx.to(torch.int32) + start
        if kk < k:
            pad = k - kk
            vals = torch.cat([vals, torch.full((b, pad), MASK_DISTANCE,
                                               device=device)], dim=1)
            ids = torch.cat([ids, torch.full((b, pad), -1, dtype=torch.int32,
                                             device=device)], dim=1)
        return vals, ids

    if chunk <= 0 or chunk >= n:
        vals, ids = block(0, n)
    else:
        n_full = (n // chunk) * chunk
        vals = torch.full((b, k), MASK_DISTANCE, device=device)
        ids = torch.full((b, k), -1, dtype=torch.int32, device=device)
        for start in range(0, n_full, chunk):
            v, i = block(start, chunk)
            vals, ids = merge_topk(vals, ids, v, i, k)
        if n_full < n:
            v, i = block(n_full, n - n_full)
            vals, ids = merge_topk(vals, ids, v, i, k)
    ids = torch.where(vals >= MASK_DISTANCE, -1, ids)
    return vals, ids


def _bf16_ip(q: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """[B, D] x [C, D] -> [B, C] inner product, bf16 in / fp32 sums."""
    return q.to(torch.bfloat16).float() @ c.to(torch.bfloat16).float().T


# ---------------------------------------------------------------------------
# BQ: packed hamming
# ---------------------------------------------------------------------------


def _bq_search_plain(q_packed, packed, popcounts, mask, dims: int, k: int,
                     chunk: int = 131072):
    """Hamming top-k over packed sign bits: |q| + |x| - 2 q.x (JAX
    ``bq_search``)."""
    n, b = packed.shape[0], q_packed.shape[0]
    q_bits = unpack_bits(q_packed, dims)  # [B, D] bf16
    q_pop = q_bits.float().sum(-1)  # [B]

    def score(start, size):
        bits = unpack_bits(packed[start:start + size], dims)  # [size, D]
        ip = _bf16_ip(q_bits, bits)
        return q_pop[:, None] + popcounts[start:start + size][None, :] \
            - 2.0 * ip

    return _chunked_topk(score, n, b, k, chunk, mask, packed.device)


def bq_search(q_packed, packed, popcounts, mask, dims: int, k: int,
              chunk: int = 131072):
    """Exact hamming top-``k`` over packed bits: (dists [B, k] float32,
    ids [B, k] int32), ascending by (distance, id), -1/MASK padded. CUDA
    tensors go to kernel Q1, CPU tensors to the plain version; ``chunk``
    bounds the plain version's working set (the kernel's result does not
    depend on it). The ``launches`` attribute counts Q1's launches, one a
    search (``merge_partials.launches`` counts the merge's)."""
    dev = packed.device
    if dev.type == "cuda":
        return bq_search_cuda(q_packed, packed, popcounts, mask, dims, k)
    if dev.type == "cpu":
        return _bq_search_plain(q_packed, packed, popcounts, mask, dims, k,
                                chunk)
    raise ValueError(f"no BQ scan for device {dev}")


bq_search.launches = 0


# ---------------------------------------------------------------------------
# SQ: asymmetric float-query x byte-codes
# ---------------------------------------------------------------------------


def _metric_distance(q_dot_dec, q_sq, dsq, metric: str):
    """Distances from q.decode(x) ([B, C]): l2-squared clamped at 0, dot
    negated, cosine 1 - x (stored vectors were normalized)."""
    if metric == "l2-squared":
        return torch.clamp(q_sq[:, None] - 2.0 * q_dot_dec + dsq, min=0.0)
    if metric == "dot":
        return -q_dot_dec
    return 1.0 - q_dot_dec


def _sq_epilogue(ip_codes, q_sum, q_sq, dsq, a, s, metric: str):
    """Distances from q.codes ([B, C]): the JAX programs' affine epilogue."""
    return _metric_distance(s * ip_codes + (a * q_sum)[:, None], q_sq, dsq,
                            metric)


def _sq_search_plain(queries, codes, dec_sqnorms, a, s, mask, metric: str,
                     k: int, chunk: int = 131072):
    """distance(q, decode(code)) with decode(c) = a + s*c, one product per
    chunk (JAX ``sq_search``)."""
    n, b = codes.shape[0], queries.shape[0]
    a = torch.as_tensor(a, dtype=torch.float32, device=codes.device)
    s = torch.as_tensor(s, dtype=torch.float32, device=codes.device)
    q_sum = torch.sum(queries, dim=-1)
    q_sq = torch.sum(queries * queries, dim=-1)

    def score(start, size):
        ip_codes = _bf16_ip(queries, codes[start:start + size])
        return _sq_epilogue(ip_codes, q_sum, q_sq,
                            dec_sqnorms[start:start + size][None, :], a, s,
                            metric)

    return _chunked_topk(score, n, b, k, chunk, mask, codes.device)


def sq_search(queries, codes, dec_sqnorms, a, s, mask, metric: str, k: int,
              chunk: int = 131072):
    """Exact SQ top-``k``: (dists [B, k], ids [B, k] int32) ascending by
    (distance, id), -1/MASK padded. ``queries`` [B, D] float32 (normalized
    already for cosine), ``codes`` [N, D] uint8, ``a``/``s`` the quantizer's
    offset and step. CUDA tensors go to kernel Q2, CPU tensors to the plain
    version. The ``launches`` attribute counts Q2's launches, one a
    search, as ``bq_search``'s."""
    if metric not in SQ_METRICS:
        raise ValueError(f"SQ scan has no metric {metric!r}")
    dev = codes.device
    if dev.type == "cuda":
        return sq_search_cuda(queries, codes, dec_sqnorms, float(a), float(s),
                              mask, metric, k)
    if dev.type == "cpu":
        return _sq_search_plain(queries, codes, dec_sqnorms, a, s, mask,
                                metric, k, chunk)
    raise ValueError(f"no SQ scan for device {dev}")


sq_search.launches = 0


# ---------------------------------------------------------------------------
# PQ: decode-and-multiply
# ---------------------------------------------------------------------------


def _pq_decode(codes, codebooks, d: int):
    """[..., M] codes -> [..., d] rows of their centroids (the codebooks'
    dtype)."""
    m = codebooks.shape[0]
    seg = torch.arange(m, device=codes.device)
    decoded = codebooks[seg, codes.long()]  # [..., M, dsub]
    return decoded.reshape(*codes.shape[:-1], -1)[..., :d]


def _pq_search_plain(queries, codes, codebooks, dec_sqnorms, mask,
                     metric: str, k: int, chunk: int = 32768):
    """Exact distance to PQ-decoded rows: a chunk decoded (a codebook
    gather), then one product (JAX ``pq_search``)."""
    n, b = codes.shape[0], queries.shape[0]
    q_sq = torch.sum(queries * queries, dim=-1)

    def score(start, size):
        decoded = _pq_decode(codes[start:start + size], codebooks,
                             queries.shape[1])
        ip = _bf16_ip(queries, decoded)
        return _metric_distance(ip, q_sq,
                                dec_sqnorms[start:start + size][None, :],
                                metric)

    return _chunked_topk(score, n, b, k, chunk, mask, codes.device)


def pq_search(queries, codes, codebooks, dec_sqnorms, mask, metric: str,
              k: int, chunk: int = 32768):
    """Exact PQ top-``k``: (dists [B, k], ids [B, k] int32) ascending by
    (distance, id), -1/MASK padded. ``queries`` [B, D] float32 (normalized
    already for cosine), ``codes`` [N, M] uint8, ``codebooks`` [M, C,
    D/M] float32 or their bfloat16 copy (the products round the decoded
    rows to bf16 either way, so both give the same distances). CUDA
    tensors go to kernel Q3, CPU tensors to the plain version. The
    ``launches`` attribute counts Q3's launches, one a search."""
    if metric not in SQ_METRICS:
        raise ValueError(f"PQ scan has no metric {metric!r}")
    dev = codes.device
    if dev.type == "cuda":
        return pq_search_cuda(queries, codes, codebooks, dec_sqnorms, mask,
                              metric, k)
    if dev.type == "cpu":
        return _pq_search_plain(queries, codes, codebooks, dec_sqnorms, mask,
                                metric, k, chunk)
    raise ValueError(f"no PQ scan for device {dev}")


pq_search.launches = 0


# ---------------------------------------------------------------------------
# RQ: rotated query x per-row affine byte codes
# ---------------------------------------------------------------------------


def _rq_epilogue(ip_codes, q_sum, q_sq, lo, st, dsq, metric: str):
    """Distances from q.codes ([B, C]) with each row's lower and step."""
    return _metric_distance(st * ip_codes + q_sum[:, None] * lo, q_sq, dsq,
                            metric)


def _rq_search_plain(q_rot, codes, lower, step, dec_sqnorms, mask,
                     metric: str, k: int, chunk: int = 131072):
    """decode_x(c) = lower_x + step_x*c; q.decoded = step_x*(q.c) +
    lower_x*sum(q) (JAX ``rq_search``)."""
    n, b = codes.shape[0], q_rot.shape[0]
    q_sum = torch.sum(q_rot, dim=-1)
    q_sq = torch.sum(q_rot * q_rot, dim=-1)

    def score(start, size):
        ip_codes = _bf16_ip(q_rot, codes[start:start + size])
        sl = slice(start, start + size)
        return _rq_epilogue(ip_codes, q_sum, q_sq, lower[sl][None, :],
                            step[sl][None, :], dec_sqnorms[sl][None, :],
                            metric)

    return _chunked_topk(score, n, b, k, chunk, mask, codes.device)


def rq_search(q_rot, codes, lower, step, dec_sqnorms, mask, metric: str,
              k: int, chunk: int = 131072):
    """Exact RQ top-``k``, as ``sq_search``: ``q_rot`` [B, D'] float32
    (rotated, normalized for cosine), ``codes`` [N, D'] uint8, ``lower``,
    ``step``, ``dec_sqnorms`` [N] float32. CUDA tensors go to kernel Q4,
    CPU tensors to the plain version. The ``launches`` attribute counts
    Q4's launches, one a search."""
    if metric not in SQ_METRICS:
        raise ValueError(f"RQ scan has no metric {metric!r}")
    dev = codes.device
    if dev.type == "cuda":
        return rq_search_cuda(q_rot, codes, lower, step, dec_sqnorms, mask,
                              metric, k)
    if dev.type == "cpu":
        return _rq_search_plain(q_rot, codes, lower, step, dec_sqnorms, mask,
                                metric, k, chunk)
    raise ValueError(f"no RQ scan for device {dev}")


rq_search.launches = 0


# ---------------------------------------------------------------------------
# code-space frontier gathers (the HNSW host walk)
# ---------------------------------------------------------------------------


def sq_gather_distance(queries, codes, candidate_ids, dec_sqnorms, a, s,
                       metric: str):
    """Per-query candidate distances in SQ code space. ids [B, C] -> [B, C]."""
    ids = candidate_ids.long()
    blk = codes[ids]  # [B, C, D]
    dsq = dec_sqnorms[ids]  # [B, C]
    ip = torch.einsum("bd,bcd->bc", queries.to(torch.bfloat16).float(),
                      blk.to(torch.bfloat16).float())
    a = torch.as_tensor(a, dtype=torch.float32, device=codes.device)
    s = torch.as_tensor(s, dtype=torch.float32, device=codes.device)
    q_sum = torch.sum(queries, dim=-1)
    q_sq = torch.sum(queries * queries, dim=-1) if metric == "l2-squared" \
        else None
    return _sq_epilogue(ip, q_sum, q_sq, dsq, a, s, metric)


def pq_gather_distance(queries, codes, codebooks, candidate_ids, dec_sqnorms,
                       metric: str):
    """Per-query candidate distances in PQ code space. ids [B, C] -> [B, C]."""
    ids = candidate_ids.long()
    decoded = _pq_decode(codes[ids], codebooks, queries.shape[1])
    dsq = dec_sqnorms[ids]
    ip = torch.einsum("bd,bcd->bc", queries.to(torch.bfloat16).float(),
                      decoded.to(torch.bfloat16).float())
    q_sq = torch.sum(queries * queries, dim=-1)
    return _metric_distance(ip, q_sq, dsq, metric)


def rq_gather_distance(q_rot, codes, candidate_ids, lower, step, dec_sqnorms,
                       metric: str):
    """Per-query candidate distances in RQ code space. ids [B, C] -> [B, C]."""
    ids = candidate_ids.long()
    ip = torch.einsum("bd,bcd->bc", q_rot.to(torch.bfloat16).float(),
                      codes[ids].to(torch.bfloat16).float())
    q_sum = torch.sum(q_rot, dim=-1)
    q_sq = torch.sum(q_rot * q_rot, dim=-1)
    return _rq_epilogue(ip, q_sum, q_sq, lower[ids], step[ids],
                        dec_sqnorms[ids], metric)


def bq_gather_distance(q_packed, packed, candidate_ids, popcounts, dims: int):
    """Per-query candidate hamming distances over packed bits. ids [B, C]."""
    ids = candidate_ids.long()
    q_bits = unpack_bits(q_packed, dims)  # [B, D]
    bits = unpack_bits(packed[ids], dims)  # [B, C, D]
    pop = popcounts[ids]
    ip = torch.einsum("bd,bcd->bc", q_bits.float(), bits.float())
    q_pop = q_bits.float().sum(-1)
    return q_pop[:, None] + pop - 2.0 * ip


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------


def _check(name, t, dtype, shape, dev):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {dtype} {tuple(shape)}, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, the corpus on {dev}")


def _check_scan(b: int, n: int, d: int):
    if b < 1 or n < 1:
        raise ValueError(f"empty scan: B={b}, N={n}")
    if not 1 <= d <= MAX_DIMS:
        raise ValueError(f"D={d} outside the kernel's [1, {MAX_DIMS}]")


def _check_k(k: int):
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k={k} outside the kernel's [1, {MAX_K}]")


def _raise_on(lib, err: int, what: str):
    if err < 0:
        raise ValueError(f"{what} refused its arguments: "
                         f"{lib.quantized_error_string(err).decode()} "
                         f"(code {err})")
    if err > 0:
        raise RuntimeError(f"{what} launch failed: "
                           f"{lib.quantized_error_string(err).decode()} "
                           f"(code {err})")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()



def _source_ints(path: Path) -> dict:
    """The ``constexpr int`` constants that a kernel source defines."""
    return {name: int(v) for name, v in re.findall(
        r"^constexpr int (k\w+) = (\d+);", path.read_text(), re.M)}


# the kernels' tiles and occupancy, read from their source so the plan
# follows it: queries a CTA, rows a tile, CTAs an SM holds. Q2, Q3 and Q4
# are one kernel template (`wg_scan_kernel`): they share its tiles
_TILES = _source_ints(Path(__file__).resolve().parents[1] / "csrc"
                      / f"{KERNEL}.cu")
QUERY_TILE = {"bq": _TILES["kQT"], **dict.fromkeys(("sq", "pq", "rq"),
                                                   _TILES["kWgQT"])}
ROWS_TILE = {"bq": _TILES["kBqR"], **dict.fromkeys(("sq", "pq", "rq"),
                                                   _TILES["kWgR"])}
CTAS_PER_SM = {"bq": _TILES["kBqCtasPerSm"],
               **dict.fromkeys(("sq", "pq", "rq"), _TILES["kWgCtasPerSm"])}
# the merge: the shared memory a CTA stages keys in, the splits it takes
MERGE_SMEM = _TILES["kMergeSmem"]
MERGE_MAX_SPLITS = _TILES["kMergeMaxSplits"]
# the candidate lists of a search stay under this many bytes, by taking
# fewer splits (never fewer than one)
LIST_BYTES = 1 << 29
# the key of a row that is never taken (masked, past the corpus) and of a
# list's padding, as int32
NONE_KEY = -1


class ScanPlan(NamedTuple):
    """How a scan cuts its rows: ``splits`` contiguous ranges of
    ``split_rows`` rows (whole tiles), each query's candidate list of
    ``cap`` entries a split."""
    splits: int
    split_rows: int
    cap: int


def scan_plan(kind: str, b: int, n: int, k: int, sms: int = 132) -> ScanPlan:
    """The splits of a Q1 (``kind`` "bq"), Q2 ("sq"), Q3 ("pq") or Q4
    ("rq") scan of ``b`` queries over ``n`` rows keeping ``k``: enough CTAs to fill ``sms`` SMs
    (splits x query tiles), fewer when the lists [splits, b, cap] would pass
    ``LIST_BYTES``, at most one a tile of rows. A list holds 2k (rounded to
    32) plus a tile, so a compaction frees room for at least k more; a code
    scan's list at least three tiles, so a split's first tile never fills
    it. Raises ``ValueError`` on a shape or ``k`` no kernel takes."""
    if b < 1 or n < 1:
        raise ValueError(f"empty scan: B={b}, N={n}")
    _check_k(k)
    rows = ROWS_TILE[kind]
    cap = max(-(-2 * k // 32) * 32, 0 if kind == "bq" else 2 * rows) + rows
    tiles = -(-n // rows)
    want = max(1, -(-sms * CTAS_PER_SM[kind] // -(-b // QUERY_TILE[kind])))
    fit = max(1, LIST_BYTES // (b * cap * 8))
    per_split = -(-tiles // min(want, fit, tiles))
    return ScanPlan(-(-tiles // per_split), per_split * rows, cap)


def search_launches() -> dict:
    """Kernel launches one search makes, whatever its shape: one scan over
    every query and every split of ``scan_plan``, and one merge."""
    return {"scan": 1, "merge": 1}


def _key_order(keys: torch.Tensor) -> torch.Tensor:
    """int64 values ordering int32-held uint32 keys as unsigned."""
    k = keys.long()
    return torch.where(k < 0, k + (1 << 32), k)


def _as_u32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) as int32 tensors with the same low bits."""
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def keys_to_dists(keys: torch.Tensor) -> torch.Tensor:
    """float32 distances from the kernels' order keys (the inverse of the
    transform in ``csrc/quantized.cu``: negative floats are bit-flipped,
    the others carry the sign bit)."""
    k = _key_order(keys)
    bits = torch.where(k >= (1 << 31), k - (1 << 31), (~k) & 0xFFFFFFFF)
    return _as_u32(bits).view(torch.float32)


def split_partials_plain(keys: torch.Tensor, k: int, plan: ScanPlan):
    """What a scan leaves in its lists, from the order keys [B, N] of every
    (query, row) (``NONE_KEY`` for a row never taken): (keys, rows) [splits,
    B, k], each split's k smallest by (key, row) in row order, padded with
    ``NONE_KEY`` / -1."""
    b, n = keys.shape
    out_k = torch.full((plan.splits, b, k), NONE_KEY, dtype=torch.int32,
                       device=keys.device)
    out_r = torch.full_like(out_k, -1)
    for sp in range(plan.splits):
        lo = sp * plan.split_rows
        part = keys[:, lo:lo + plan.split_rows]
        order = torch.sort(_key_order(part), dim=1, stable=True).indices
        taken = torch.gather(part, 1, order[:, :k]) != NONE_KEY
        rows = torch.where(taken, order[:, :k], part.shape[1])
        rows = torch.sort(rows, dim=1).values  # back to row order
        kk = rows.shape[1]
        live = rows < part.shape[1]
        safe = rows.clamp(max=part.shape[1] - 1)
        out_k[sp, :, :kk] = torch.where(live, torch.gather(part, 1, safe),
                                        NONE_KEY)
        out_r[sp, :, :kk] = torch.where(live, safe + lo, -1).to(torch.int32)
    return out_k, out_r


def split_partials_bounded_plain(keys: torch.Tensor, k: int, plan: ScanPlan,
                                 rows_tile: int = 128):
    """``split_partials_plain`` under the bound the code scans' splits share
    (``wg_scan_kernel``): the splits walk their rows in tiles of
    ``rows_tile`` together; each half of a split's tiles (a warpgroup's
    rows) is a sub-stream that publishes the least (key, row) pair it has
    taken, and after tiles 1, 2, 4, 8, ... a query's bound becomes the
    largest published pair (none while a sub-stream has taken nothing).
    A row is taken only if its key is below its split's threshold (the
    k-th key it has taken, once it has k) and its (key, row) pair below the
    bound; with fewer than k sub-streams there is no bound. Each split's
    partial: the k smallest (key, row) it took, in row order, padded. The
    kernel reads the bound whenever its helpers get to it; any reading is
    valid, so the merged answer is the same."""
    b, n = keys.shape
    order = _key_order(keys)  # int64, the uint32 key's order
    rows = torch.arange(n, device=keys.device).expand(b, n)
    none = 1 << 32  # a key above every key: no pair taken, no bound
    half = rows_tile // 2
    subs = 2 * plan.splits
    # pairs as (key, row) in two int64 tensors, compared in that order
    smin_k = torch.full((subs, b), none, dtype=torch.int64)
    smin_r = torch.zeros((subs, b), dtype=torch.int64)
    bound_k = torch.full((b,), none, dtype=torch.int64)
    bound_r = torch.zeros((b,), dtype=torch.int64)
    taken = torch.zeros((b, n), dtype=torch.bool, device=keys.device)
    thr = torch.full((plan.splits, b), none, dtype=torch.int64)
    for t in range(-(-plan.split_rows // rows_tile)):
        for sp in range(plan.splits):
            start = sp * plan.split_rows
            lo, hi = start + t * rows_tile, min(n, start + plan.split_rows,
                                                start + (t + 1) * rows_tile)
            if lo >= hi:
                continue
            key, row = order[:, lo:hi], rows[:, lo:hi]
            below = (key < bound_k[:, None]) | (
                (key == bound_k[:, None]) & (row < bound_r[:, None]))
            taken[:, lo:hi] = (key < thr[sp][:, None]) & below & (
                keys[:, lo:hi] != NONE_KEY)
            for c in range(2):
                part = slice(lo + c * half, min(hi, lo + (c + 1) * half))
                if part.start >= part.stop:
                    continue
                got = torch.where(taken[:, part], order[:, part], none)
                # the least pair: the least key, then its least row
                least = got.min(1).values
                at = torch.where(got == least[:, None], rows[:, part], n)
                least_r = at.min(1).values
                sid = 2 * sp + c
                better = (least < smin_k[sid]) | (
                    (least == smin_k[sid]) & (least_r < smin_r[sid]))
                smin_k[sid] = torch.where(better, least, smin_k[sid])
                smin_r[sid] = torch.where(better, least_r, smin_r[sid])
            mine = torch.where(taken[:, start:start + plan.split_rows],
                               order[:, start:start + plan.split_rows], none)
            if mine.shape[1] >= k:
                thr[sp] = torch.kthvalue(mine, k, dim=1).values
        if subs >= k and t & (t + 1) == 0:
            # the largest pair: the largest key, then its largest row
            top = smin_k.max(0).values
            bound_r = torch.where(smin_k == top[None, :], smin_r,
                                  -1).max(0).values
            bound_k = top
    bounded = torch.where(taken, keys, NONE_KEY)
    return split_partials_plain(bounded, k, plan)


def merge_partials_plain(cand_keys: torch.Tensor, cand_rows: torch.Tensor,
                         k: int):
    """The plain version of the merge: a stable sort by unsigned key of each
    query's [splits x k] partials (split order is row order), its first
    ``k`` as (dists [B, k], ids [B, k]); nothing taken gives
    MASK_DISTANCE / -1."""
    s, b, _ = cand_keys.shape
    keys = cand_keys[..., :k].permute(1, 0, 2).reshape(b, s * k)
    rows = cand_rows[..., :k].permute(1, 0, 2).reshape(b, s * k)
    order = torch.sort(_key_order(keys), dim=1, stable=True).indices[:, :k]
    sk = torch.gather(keys, 1, order)
    d = torch.where(sk == NONE_KEY, MASK_DISTANCE, keys_to_dists(sk))
    ids = torch.where(d >= MASK_DISTANCE, -1, torch.gather(rows, 1, order))
    return d, ids.to(torch.int32)


def merge_places(counts) -> int:
    """The places the merge kernel gives a query's taken entries: each
    split's ``counts`` rounded up to 4."""
    return sum(-(-int(c) // 4) * 4 for c in counts)


def merge_stage_cap(splits: int, k: int) -> int:
    """The places (``merge_places``) a query may take for the merge kernel
    to stage its keys in shared memory (``merge_stage_cap`` of
    ``csrc/quantized.cu``); a query with more takes its streaming path."""
    fixed = -(-(splits + 1) * 8 // 16) * 16 + -(-8 * k // 16) * 16
    return min(splits * (-(-k // 4) * 4), (MERGE_SMEM - fixed) // 16 * 4)


def merge_partials(cand_keys: torch.Tensor, cand_rows: torch.Tensor,
                   k: int):
    """Each query's ``k`` smallest (distance, row) over the first ``k``
    entries of its lists [splits, B, cap] (int32; keys are the kernels'
    uint32 order keys): (dists [B, k] float32, ids [B, k] int32), ascending,
    MASK_DISTANCE / -1 where nothing was taken. Each list holds its taken
    entries first, then ``NONE_KEY`` / -1 padding, as the scans leave them
    (``split_partials_plain``): the kernel reads only the taken prefix.
    CUDA tensors go to the merge kernel, one launch counted in
    ``launches``; CPU tensors to the plain version."""
    if cand_keys.device.type == "cpu":
        return merge_partials_plain(cand_keys, cand_rows, k)
    s, b, cap = cand_keys.shape
    dev = cand_keys.device
    _check("cand_keys", cand_keys, torch.int32, (s, b, cap), dev)
    _check("cand_rows", cand_rows, torch.int32, (s, b, cap), dev)
    _check_k(k)
    if not 1 <= s <= MERGE_MAX_SPLITS:
        raise ValueError(f"{s} splits outside the merge's [1, "
                         f"{MERGE_MAX_SPLITS}]")
    lib = _library()
    out_d = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
    # the launch takes the current device: switched only where it differs
    # (the switch costs the search a few microseconds of host time)
    with contextlib.nullcontext() if dev.index == torch.cuda.current_device() \
            else torch.cuda.device(dev):
        err = lib.topk_merge(cand_keys.data_ptr(), cand_rows.data_ptr(),
                             out_d.data_ptr(), out_i.data_ptr(), s, b, cap,
                             k, torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, err, "topk_merge")
    merge_partials.launches += 1
    return out_d, out_i


merge_partials.launches = 0


def _lists(plan: ScanPlan, b: int, dev):
    """Empty candidate lists (keys, rows) [splits, b, cap] of a scan."""
    shape = (plan.splits, b, plan.cap)
    return (torch.empty(shape, dtype=torch.int32, device=dev),
            torch.empty(shape, dtype=torch.int32, device=dev))


def _bound_exchange(plan: ScanPlan, b: int, dev) -> torch.Tensor:
    """A code scan's exchange for the bound its splits share: each
    warpgroup's least (key, row) taken of each query, [b, 2 splits], all
    ones (nothing taken yet)."""
    return torch.full((b, 2 * plan.splits), -1, dtype=torch.int64,
                      device=dev)


def _check_lists(plan: ScanPlan, b: int, cand_keys, cand_rows, dev):
    shape = (plan.splits, b, plan.cap)
    _check("cand_keys", cand_keys, torch.int32, shape, dev)
    _check("cand_rows", cand_rows, torch.int32, shape, dev)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def device_plan(kind: str, b: int, n: int, k: int, dev) -> ScanPlan:
    """``scan_plan`` for the card holding ``dev``."""
    return scan_plan(kind, b, n, k, _sm_count(torch.device(dev).index or 0))


def _check_bq(q_packed, packed, popcounts, mask, dims: int, k: int):
    dev = packed.device
    b, w = q_packed.shape
    n = packed.shape[0]
    if w != (dims + 31) // 32:
        raise ValueError(f"{w} words cannot hold {dims} bits")
    _check("q_packed", q_packed, torch.int32, (b, w), dev)
    _check("packed", packed, torch.int32, (n, w), dev)
    _check("popcounts", popcounts, torch.float32, (n,), dev)
    if mask is not None:
        _check("mask", mask, torch.bool, (n,), dev)
    _check_scan(b, n, dims)
    _check_k(k)


def bq_scan_cuda(q_packed, packed, popcounts, mask, dims: int, k: int,
                 plan: ScanPlan, cand_keys: torch.Tensor,
                 cand_rows: torch.Tensor) -> None:
    """Kernel Q1 on the current stream, one launch: each query's ``k``
    smallest (order key, row) of each split of ``plan`` into the first
    ``k`` entries of its list (``cand_keys``/``cand_rows`` [splits, B, cap]
    int32, in row order, padded with ``NONE_KEY`` / -1). ``q_packed`` [B, W]
    and ``packed`` [N, W] int32 words, ``popcounts`` [N] float32, ``mask``
    [N] bool or None. Raises ``ValueError`` on arguments outside the
    kernel's contract and ``RuntimeError`` on a failed launch; each launch
    adds one to ``bq_search.launches``."""
    _check_bq(q_packed, packed, popcounts, mask, dims, k)
    _check_lists(plan, q_packed.shape[0], cand_keys, cand_rows, packed.device)
    _bq_launch(q_packed, packed, popcounts, mask, dims, k, plan, cand_keys,
               cand_rows)


def _bq_launch(q_packed, packed, popcounts, mask, dims: int, k: int,
               plan: ScanPlan, cand_keys, cand_rows) -> None:
    """``bq_scan_cuda`` on arguments already checked."""
    dev = packed.device
    b, w = q_packed.shape
    n = packed.shape[0]
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.bq_scan(q_packed.data_ptr(), packed.data_ptr(),
                          popcounts.data_ptr(), _ptr(mask),
                          cand_keys.data_ptr(), cand_rows.data_ptr(), b, n,
                          w, dims, k, plan.splits, plan.split_rows, plan.cap,
                          torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, err, "bq_scan")
    bq_search.launches += 1


def sq_scan_cuda(qb, codes, dec_sqnorms, mask, q_sum, q_sq, a: float,
                 s: float, metric: str, k: int, plan: ScanPlan,
                 cand_keys: torch.Tensor, cand_rows: torch.Tensor) -> None:
    """Kernel Q2 on the current stream, one launch, into the lists as
    ``bq_scan_cuda``. ``qb`` [B, Dp] the bf16-rounded queries zero-padded to
    the next multiple of 64 (``sq_query_terms``), ``q_sum``/``q_sq`` [B]
    float32 the unrounded queries' sums and sums of squares, ``codes``
    [N, D] uint8. Raises as ``bq_scan_cuda``; each launch adds one to
    ``sq_search.launches``."""
    dev = codes.device
    n, d = codes.shape
    b = qb.shape[0]
    _check_code_scan("SQ", qb, codes, dec_sqnorms, mask, d, metric, k, plan,
                     cand_keys, cand_rows)
    _check("q_sum", q_sum, torch.float32, (b,), dev)
    _check("q_sq", q_sq, torch.float32, (b,), dev)
    blocks = code_query_blocks(qb)
    pub = _bound_exchange(plan, b, dev)
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.sq_scan(blocks.data_ptr(), codes.data_ptr(),
                          dec_sqnorms.data_ptr(), _ptr(mask), q_sum.data_ptr(),
                          q_sq.data_ptr(), a, s, SQ_METRICS.index(metric),
                          cand_keys.data_ptr(), cand_rows.data_ptr(),
                          pub.data_ptr(), b, n, d,
                          _padded(d), k, plan.splits, plan.split_rows,
                          plan.cap, torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, err, "sq_scan")
    sq_search.launches += 1


def _padded(d: int) -> int:
    """Q2's query width: ``d`` rounded up to the ring's step of 64."""
    return -(-d // 64) * 64


def sq_query_terms(queries: torch.Tensor):
    """Q2's query operands: (the queries rounded to bf16 and zero-padded to
    ``_padded(D)`` columns, their float32 sums and sums of squares taken
    from the unrounded queries)."""
    b, d = queries.shape
    qb = torch.zeros((b, _padded(d)), dtype=torch.bfloat16,
                     device=queries.device)
    qb[:, :d] = queries
    return (qb, torch.sum(queries, dim=-1).contiguous(),
            torch.sum(queries * queries, dim=-1).contiguous())


def code_query_blocks(qb: torch.Tensor) -> torch.Tensor:
    """The code scans' query operand: the bf16 queries [B, Dp] laid out as
    [ceil(B / 256)][Dp / 8][256][8] (zero past B), so that a CTA's 64
    dimensions of a step are one contiguous 32 KB block whose 8 x 8 pieces
    are the core matrices of the tensor-core product."""
    b, dp = qb.shape
    tile = QUERY_TILE["sq"]
    tiles = -(-b // tile)
    out = torch.zeros((tiles * tile, dp), dtype=torch.bfloat16,
                      device=qb.device)
    out[:b] = qb
    return out.view(tiles, tile, dp // 8, 8).transpose(1, 2).contiguous()


def bq_search_cuda(q_packed, packed, popcounts, mask, dims: int, k: int):
    """Kernels Q1 and the merge on the current stream: the contract of
    ``bq_search``, one ``bq_scan_cuda`` over every query and one
    ``merge_partials``."""
    dev = packed.device
    b = q_packed.shape[0]
    _check_bq(q_packed, packed, popcounts, mask, dims, k)
    plan = device_plan("bq", b, packed.shape[0], k, dev)
    cand_keys, cand_rows = _lists(plan, b, dev)
    _bq_launch(q_packed, packed, popcounts, mask, dims, k, plan, cand_keys,
               cand_rows)
    return merge_partials(cand_keys, cand_rows, k)


def sq_search_cuda(queries, codes, dec_sqnorms, a: float, s: float, mask,
                   metric: str, k: int):
    """Kernels Q2 and the merge on the current stream: the contract of
    ``sq_search``, as ``bq_search_cuda``. The queries are rounded to bf16
    here (as ``_bf16_ip`` rounds them); their sums and sums of squares are
    taken in float32 from the unrounded queries, as the plain version
    takes them (``sq_query_terms``)."""
    dev = codes.device
    b, d = queries.shape
    n = codes.shape[0]
    _check("queries", queries, torch.float32, (b, d), dev)
    qb, q_sum, q_sq = sq_query_terms(queries)
    plan = device_plan("sq", b, n, k, dev)
    cand_keys, cand_rows = _lists(plan, b, dev)
    sq_scan_cuda(qb, codes, dec_sqnorms, mask, q_sum, q_sq, a, s, metric, k,
                 plan, cand_keys, cand_rows)
    return merge_partials(cand_keys, cand_rows, k)


def _check_code_scan(name, qb, codes, dec_sqnorms, mask, d: int, metric: str,
                     k: int, plan: ScanPlan, cand_keys, cand_rows):
    """The checks Q2, Q3 and Q4 share: queries [B, _padded(d)] bf16, codes
    [N, w] uint8, norms [N], mask, metric, k and the lists."""
    dev = codes.device
    n, w = codes.shape
    b = qb.shape[0]
    _check("queries", qb, torch.bfloat16, (b, _padded(d)), dev)
    _check("codes", codes, torch.uint8, (n, w), dev)
    _check("dec_sqnorms", dec_sqnorms, torch.float32, (n,), dev)
    if mask is not None:
        _check("mask", mask, torch.bool, (n,), dev)
    if metric not in SQ_METRICS:
        raise ValueError(f"{name} scan has no metric {metric!r}")
    _check_scan(b, n, d)
    _check_k(k)
    _check_lists(plan, b, cand_keys, cand_rows, dev)


def pq_scan_cuda(qb, codes, codebooks, dec_sqnorms, mask, q_sq, metric: str,
                 k: int, plan: ScanPlan, cand_keys: torch.Tensor,
                 cand_rows: torch.Tensor) -> None:
    """Kernel Q3 on the current stream, one launch, into the lists as
    ``bq_scan_cuda``. ``qb`` [B, Dp] the bf16-rounded queries zero-padded
    (``sq_query_terms``), ``q_sq`` [B] float32 their unrounded sums of
    squares, ``codes`` [N, M] uint8, ``codebooks`` [M, C, D/M] the bfloat16
    copy (16-byte aligned, as torch allocates). Raises as ``bq_scan_cuda``;
    each launch adds one to ``pq_search.launches``."""
    dev = codes.device
    m, c, dsub = codebooks.shape
    d = m * dsub
    b = qb.shape[0]
    if codes.shape[1] != m:
        raise ValueError(f"codes have {codes.shape[1]} segments, the "
                         f"codebooks {m}")
    _check_code_scan("PQ", qb, codes, dec_sqnorms, mask, d, metric, k, plan,
                     cand_keys, cand_rows)
    _check("codebooks", codebooks, torch.bfloat16, (m, c, dsub), dev)
    _check("q_sq", q_sq, torch.float32, (b,), dev)
    blocks = code_query_blocks(qb)
    pub = _bound_exchange(plan, b, dev)
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.pq_scan(blocks.data_ptr(), codes.data_ptr(),
                          codebooks.data_ptr(), dec_sqnorms.data_ptr(),
                          _ptr(mask), q_sq.data_ptr(),
                          SQ_METRICS.index(metric), cand_keys.data_ptr(),
                          cand_rows.data_ptr(), pub.data_ptr(), b,
                          codes.shape[0], d,
                          _padded(d), m, dsub, c, k, plan.splits,
                          plan.split_rows, plan.cap,
                          torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, err, "pq_scan")
    pq_search.launches += 1


def rq_scan_cuda(qb, codes, lower, step, dec_sqnorms, mask, q_sum, q_sq,
                 metric: str, k: int, plan: ScanPlan,
                 cand_keys: torch.Tensor, cand_rows: torch.Tensor) -> None:
    """Kernel Q4 on the current stream, one launch, into the lists as
    ``bq_scan_cuda``: ``sq_scan_cuda``'s operands with each row's
    ``lower`` and ``step`` [N] float32 in place of ``a`` and ``s``; the
    rotated codes [N, D'] have D' a multiple of 64 and start on 16 bytes.
    Each launch adds one to ``rq_search.launches``."""
    dev = codes.device
    n, d = codes.shape
    b = qb.shape[0]
    _check_code_scan("RQ", qb, codes, dec_sqnorms, mask, d, metric, k, plan,
                     cand_keys, cand_rows)
    _check("lower", lower, torch.float32, (n,), dev)
    _check("step", step, torch.float32, (n,), dev)
    _check("q_sum", q_sum, torch.float32, (b,), dev)
    _check("q_sq", q_sq, torch.float32, (b,), dev)
    blocks = code_query_blocks(qb)
    pub = _bound_exchange(plan, b, dev)
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.rq_scan(blocks.data_ptr(), codes.data_ptr(),
                          dec_sqnorms.data_ptr(), lower.data_ptr(),
                          step.data_ptr(), _ptr(mask), q_sum.data_ptr(),
                          q_sq.data_ptr(), SQ_METRICS.index(metric),
                          cand_keys.data_ptr(), cand_rows.data_ptr(),
                          pub.data_ptr(), b, n, d,
                          _padded(d), k, plan.splits, plan.split_rows,
                          plan.cap, torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, err, "rq_scan")
    rq_search.launches += 1


def pq_search_cuda(queries, codes, codebooks, dec_sqnorms, mask, metric: str,
                   k: int):
    """Kernels Q3 and the merge on the current stream: the contract of
    ``pq_search``, one ``pq_scan_cuda`` over every query and one
    ``merge_partials``. Float32 codebooks are rounded to bf16 here (the
    quantizer hands over its bf16 copy, made once per fit)."""
    dev = codes.device
    b, d = queries.shape
    _check("queries", queries, torch.float32, (b, d), dev)
    if codebooks.dtype != torch.bfloat16:
        codebooks = codebooks.to(torch.bfloat16).contiguous()
    qb, _, q_sq = sq_query_terms(queries)
    plan = device_plan("pq", b, codes.shape[0], k, dev)
    cand_keys, cand_rows = _lists(plan, b, dev)
    pq_scan_cuda(qb, codes, codebooks, dec_sqnorms, mask, q_sq, metric, k,
                 plan, cand_keys, cand_rows)
    return merge_partials(cand_keys, cand_rows, k)


def rq_search_cuda(q_rot, codes, lower, step, dec_sqnorms, mask, metric: str,
                   k: int):
    """Kernels Q4 and the merge on the current stream: the contract of
    ``rq_search``, as ``sq_search_cuda``."""
    dev = codes.device
    b, d = q_rot.shape
    _check("queries", q_rot, torch.float32, (b, d), dev)
    qb, q_sum, q_sq = sq_query_terms(q_rot)
    plan = device_plan("rq", b, codes.shape[0], k, dev)
    cand_keys, cand_rows = _lists(plan, b, dev)
    rq_scan_cuda(qb, codes, lower, step, dec_sqnorms, mask, q_sum, q_sq,
                 metric, k, plan, cand_keys, cand_rows)
    return merge_partials(cand_keys, cand_rows, k)


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declares the C signatures of the built library (pointers and the
    stream as c_void_p: undeclared, ctypes would pass 32-bit ints)."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.bq_scan.argtypes = [p] * 6 + [i] * 8 + [p]
    lib.sq_scan.argtypes = [p] * 6 + [f, f, i, p, p, p] + [i] * 8 + [p]
    lib.rq_scan.argtypes = [p] * 8 + [i] + [p] * 3 + [i] * 8 + [p]
    lib.pq_scan.argtypes = [p] * 6 + [i] + [p] * 3 + [i] * 11 + [p]
    lib.topk_merge.argtypes = [p] * 4 + [i] * 4 + [p]
    lib.topk_merge_stage_cap.argtypes = [i, i]
    lib.topk_merge_stage_cap.restype = i
    for fn in (lib.bq_scan, lib.sq_scan, lib.rq_scan, lib.pq_scan,
               lib.topk_merge):
        fn.restype = i
    lib.quantized_error_string.argtypes = [i]
    lib.quantized_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The kernels' library, built on first use, with its C signatures
    declared."""
    from weaviate_tpu_torch import _build

    return declare(_build.load(KERNEL))
