"""Quantized (compressed) vector search (port of the BQ and SQ half of
``weaviate_tpu/ops/quantized.py``).

- **BQ**: hamming(q, x) = |q| + |x| - 2 q.x over {0,1} bit planes; corpus
  bits stay packed (uint32 words, held as int32 tensors) in device memory.
- **SQ**: asymmetric float-query x byte-code distance: decode(c) = a + s*c,
  so q.decode(c) = s*(q.c) + a*sum(q), one product + an affine epilogue.

Two scans have hand-written CUDA kernels (``csrc/quantized.cu``): Q1, the
BQ scan (``bq_search``), and Q2, the SQ scan (``sq_search``). Each writes a
[queries, rows] block of order keys, one launch a chunk of queries, and the
selection (``select_topk``: three radix histograms, a count, a collect; five
launches a chunk) takes its top-``k``. Each search returns
the exact top-``k`` of its distances by (distance, id), the order the JAX
package's chunked ``lax.top_k`` + ``merge_topk`` gives: lower id first on
ties, masked rows at ``MASK_DISTANCE`` with id -1, and rows past the corpus
padded the same way. The plain PyTorch versions (``_bq_search_plain``,
``_sq_search_plain``) are the JAX programs step for step; each wrapper takes
its plain version for CPU tensors only, and on the card launches the kernel
or raises. BQ distances are exact integers in float32 on both routes: the
plain version unpacks the bits and multiplies, as JAX does (torch has no
popcount), the kernel counts with ``__popc``. The frontier gathers stay
torch ops: they serve the host walk, the fallback tier of the HNSW index.

PQ and RQ come with slice 4b and raise.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, Optional

import numpy as np
import torch

from weaviate_tpu_torch.ops.distance import MASK_DISTANCE
from weaviate_tpu_torch.ops.topk import merge_topk, smallest_k

KERNEL = "quantized"
SQ_METRICS = ("l2-squared", "dot", "cosine")
# the widest rows and the largest k the kernels take
MAX_DIMS = 4096
MAX_K = 4096
# the kernels stage a [queries, rows] key block in device memory; queries go
# through in chunks that keep it under this many bytes
SCRATCH_BYTES = 1 << 31
_SLICE_4B = ("{}: not ported yet (ROADMAP queue A, slice 4b: PQ and RQ)")


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
    depend on it). The ``launches`` attribute counts Q1's launches: one a
    chunk of ``query_chunk`` queries (``select_topk.launches`` counts the
    selection's, SELECT_LAUNCHES a chunk)."""
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


def _sq_epilogue(ip_codes, q_sum, q_sq, dsq, a, s, metric: str):
    """Distances from q.codes ([B, C]): the JAX programs' affine epilogue."""
    q_dot_dec = s * ip_codes + (a * q_sum)[:, None]
    if metric == "l2-squared":
        return torch.clamp(q_sq[:, None] - 2.0 * q_dot_dec + dsq, min=0.0)
    if metric == "dot":
        return -q_dot_dec
    return 1.0 - q_dot_dec  # cosine (stored vectors were normalized)


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
    version. The ``launches`` attribute counts Q2's launches, one a chunk
    of queries, as ``bq_search``'s."""
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
# PQ / RQ: slice 4b
# ---------------------------------------------------------------------------


def pq_search(*args, **kwargs):
    raise NotImplementedError(_SLICE_4B.format("PQ scan"))


def rq_search(*args, **kwargs):
    raise NotImplementedError(_SLICE_4B.format("RQ scan"))


def pq_gather_distance(*args, **kwargs):
    raise NotImplementedError(_SLICE_4B.format("PQ frontier gather"))


def rq_gather_distance(*args, **kwargs):
    raise NotImplementedError(_SLICE_4B.format("RQ frontier gather"))


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


def query_chunk(b: int, n: int) -> int:
    """Queries a kernel scans at once: the [chunk, N] int32 key block stays
    under ``SCRATCH_BYTES``."""
    return max(1, min(b, SCRATCH_BYTES // (4 * n)))


def select_topk(keys: torch.Tensor, k: int):
    """Exact top-``k`` of each row of ``keys`` [B, N] (int32 holding the
    kernels' uint32 order keys), lower column first on ties: (keys [B, k],
    columns [B, k]) ascending. Three radix-histogram passes find each row's
    k-th key, one counting pass and one collecting pass take the keys below
    it and the first of those equal to it in column order; ``k`` <= N. Five
    launches on the current stream, each counted in ``launches``; CPU
    tensors take the plain version."""
    if keys.device.type == "cpu":
        return select_topk_plain(keys, k)
    b, n = keys.shape
    dev = keys.device
    _check("keys", keys, torch.int32, (b, n), dev)
    lib = _library()
    segs = _segments(n)
    prefix = torch.zeros(b, dtype=torch.int64, device=dev)
    need = torch.full((b,), k, dtype=torch.int64, device=dev)
    hist = torch.empty((b, 1 << 11), dtype=torch.int32, device=dev)
    # every tensor a launch reads stays bound to a local until the launch is
    # enqueued: a temporary freed earlier could go to another search's
    # allocation on the same stream
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        for shift, bits in ((21, 11), (10, 11), (0, 10)):
            hist.zero_()
            prefix32 = _as_u32(prefix)
            err = lib.topk_radix_hist(
                keys.data_ptr(), prefix32.data_ptr(), hist.data_ptr(),
                b, n, segs, shift, bits, stream)
            _raise_on(lib, err, "topk_radix_hist")
            select_topk.launches += 1
            cum = hist[:, :1 << bits].long().cumsum(1)
            digit = (cum < need[:, None]).sum(1)
            below = torch.where(
                digit > 0,
                cum.gather(1, (digit - 1).clamp(min=0)[:, None])[:, 0], 0)
            need = need - below
            prefix = prefix | (digit << shift)
        thresh = _as_u32(prefix)
        counts = torch.empty((b, segs, 2), dtype=torch.int32, device=dev)
        err = lib.topk_count(keys.data_ptr(), thresh.data_ptr(),
                             counts.data_ptr(), b, n, segs, stream)
        _raise_on(lib, err, "topk_count")
        select_topk.launches += 1
        offsets = (counts.long().cumsum(1) - counts.long()).to(torch.int32)
        need32 = need.to(torch.int32)
        out_keys = torch.empty((b, k), dtype=torch.int32, device=dev)
        out_cols = torch.empty((b, k), dtype=torch.int32, device=dev)
        err = lib.topk_collect(keys.data_ptr(), thresh.data_ptr(),
                               need32.data_ptr(), offsets.data_ptr(),
                               out_keys.data_ptr(), out_cols.data_ptr(), b, n,
                               segs, k, stream)
        _raise_on(lib, err, "topk_collect")
        select_topk.launches += 1
    # the collected entries are in column order: a stable sort by key gives
    # the (key, column) order
    order = torch.sort(_key_order(out_keys), dim=1, stable=True).indices
    return (torch.gather(out_keys, 1, order), torch.gather(out_cols, 1, order))


select_topk.launches = 0
# launches of the selection a scan's chunk of queries takes
SELECT_LAUNCHES = 5


def select_topk_plain(keys: torch.Tensor, k: int):
    """The plain version of ``select_topk``: a stable sort of each row by
    its unsigned key, its first ``k`` entries."""
    order = torch.sort(_key_order(keys), dim=1, stable=True).indices[:, :k]
    return torch.gather(keys, 1, order), order.to(torch.int32)


def _segments(n: int) -> int:
    """Column segments a row is split into for the count and collect passes
    (each a block's work)."""
    return max(1, min(256, n // 16384))


def _as_u32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) as int32 tensors with the same low bits."""
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def _key_order(keys: torch.Tensor) -> torch.Tensor:
    """int64 values ordering int32-held uint32 keys as unsigned."""
    k = keys.long()
    return torch.where(k < 0, k + (1 << 32), k)


def keys_to_dists(keys: torch.Tensor) -> torch.Tensor:
    """float32 distances from the kernels' order keys (the inverse of the
    transform in ``csrc/quantized.cu``: negative floats are bit-flipped,
    the others carry the sign bit)."""
    k = _key_order(keys)
    bits = torch.where(k >= (1 << 31), k - (1 << 31), (~k) & 0xFFFFFFFF)
    return _as_u32(bits).view(torch.float32)


def _finish(keys, cols, k: int, b: int, dev):
    """Selected (keys, columns) [B, kk] -> (dists [B, k], ids [B, k]) with
    masked entries and the tail past the corpus at MASK / -1."""
    d = keys_to_dists(keys)
    out_d = torch.full((b, k), MASK_DISTANCE, device=dev)
    out_i = torch.full((b, k), -1, dtype=torch.int32, device=dev)
    kk = keys.shape[1]
    out_d[:, :kk] = d
    out_i[:, :kk] = torch.where(d >= MASK_DISTANCE, -1, cols)
    return out_d, out_i


def bq_scan_cuda(q_packed, packed, popcounts, mask, dims: int,
                 keys: torch.Tensor) -> None:
    """Kernel Q1's scan on the current stream, one launch: the order key of
    every (query, row) hamming distance into ``keys`` [B, N] int32 (masked
    rows at MASK_DISTANCE's key; ``keys_to_dists`` inverts the keys).
    ``q_packed`` [B, W] and ``packed`` [N, W] int32 words, ``popcounts``
    [N] float32, ``mask`` [N] bool or None. Raises ``ValueError`` on
    arguments outside the kernel's contract and ``RuntimeError`` on a
    failed launch; each launch adds one to ``bq_search.launches``."""
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
    _check("keys", keys, torch.int32, (b, n), dev)
    _check_scan(b, n, dims)
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.bq_scan(q_packed.data_ptr(), packed.data_ptr(),
                          popcounts.data_ptr(), _ptr(mask), keys.data_ptr(),
                          b, n, w, dims,
                          torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, err, "bq_scan")
    bq_search.launches += 1


def sq_scan_cuda(qb, codes, dec_sqnorms, mask, q_sum, q_sq, a: float,
                 s: float, metric: str, keys: torch.Tensor) -> None:
    """Kernel Q2's scan on the current stream, one launch: the order key of
    every (query, row) SQ distance into ``keys`` [B, N] int32. ``qb`` [B, D]
    the bf16-rounded queries, ``q_sum``/``q_sq`` [B] float32 the unrounded
    queries' sums and sums of squares, ``codes`` [N, D] uint8. Raises as
    ``bq_scan_cuda``; each launch adds one to ``sq_search.launches``."""
    dev = codes.device
    b, d = qb.shape
    n = codes.shape[0]
    _check("queries", qb, torch.bfloat16, (b, d), dev)
    _check("codes", codes, torch.uint8, (n, d), dev)
    _check("dec_sqnorms", dec_sqnorms, torch.float32, (n,), dev)
    if mask is not None:
        _check("mask", mask, torch.bool, (n,), dev)
    _check("q_sum", q_sum, torch.float32, (b,), dev)
    _check("q_sq", q_sq, torch.float32, (b,), dev)
    _check("keys", keys, torch.int32, (b, n), dev)
    if metric not in SQ_METRICS:
        raise ValueError(f"SQ scan has no metric {metric!r}")
    _check_scan(b, n, d)
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.sq_scan(qb.data_ptr(), codes.data_ptr(),
                          dec_sqnorms.data_ptr(), _ptr(mask), q_sum.data_ptr(),
                          q_sq.data_ptr(), a, s, SQ_METRICS.index(metric),
                          keys.data_ptr(), b, n, d,
                          torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, err, "sq_scan")
    sq_search.launches += 1


def sq_query_terms(queries: torch.Tensor):
    """Q2's query operands: (the queries rounded to bf16, their float32 sums
    and sums of squares taken from the unrounded queries)."""
    return (queries.to(torch.bfloat16).contiguous(),
            torch.sum(queries, dim=-1).contiguous(),
            torch.sum(queries * queries, dim=-1).contiguous())


def scan_launches(b: int, n: int) -> int:
    """Scan launches one search of ``b`` queries over ``n`` rows makes (one
    a chunk of queries; each chunk's selection makes SELECT_LAUNCHES)."""
    return -(-b // query_chunk(b, n))


def bq_search_cuda(q_packed, packed, popcounts, mask, dims: int, k: int):
    """Kernels Q1 and the selection on the current stream: the contract of
    ``bq_search``, the queries in chunks of ``query_chunk``, each chunk one
    ``bq_scan_cuda`` and one ``select_topk``."""
    dev = packed.device
    b = q_packed.shape[0]
    n = packed.shape[0]
    _check_scan(b, n, dims)
    _check_k(k)
    kk = min(k, n)
    out_d = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
    bc = query_chunk(b, n)
    keys = torch.empty((bc, n), dtype=torch.int32, device=dev)
    for s in range(0, b, bc):
        nb = min(bc, b - s)
        bq_scan_cuda(q_packed[s:s + nb], packed, popcounts, mask, dims,
                     keys[:nb])
        sk, sc = select_topk(keys[:nb], kk)
        out_d[s:s + nb], out_i[s:s + nb] = _finish(sk, sc, k, nb, dev)
    return out_d, out_i


def sq_search_cuda(queries, codes, dec_sqnorms, a: float, s: float, mask,
                   metric: str, k: int):
    """Kernels Q2 and the selection on the current stream: the contract of
    ``sq_search``, in chunks as ``bq_search_cuda``. The queries are rounded
    to bf16 here (as ``_bf16_ip`` rounds them); their sums and sums of
    squares are taken in float32 from the unrounded queries, as the plain
    version takes them (``sq_query_terms``)."""
    dev = codes.device
    b, d = queries.shape
    n = codes.shape[0]
    _check("queries", queries, torch.float32, (b, d), dev)
    _check_scan(b, n, d)
    _check_k(k)
    kk = min(k, n)
    qb, q_sum, q_sq = sq_query_terms(queries)
    out_d = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
    bc = query_chunk(b, n)
    keys = torch.empty((bc, n), dtype=torch.int32, device=dev)
    for s0 in range(0, b, bc):
        nb = min(bc, b - s0)
        sq_scan_cuda(qb[s0:s0 + nb], codes, dec_sqnorms, mask,
                     q_sum[s0:s0 + nb], q_sq[s0:s0 + nb], a, s, metric,
                     keys[:nb])
        sk, sc = select_topk(keys[:nb], kk)
        out_d[s0:s0 + nb], out_i[s0:s0 + nb] = _finish(sk, sc, k, nb, dev)
    return out_d, out_i


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declares the C signatures of the built library (pointers and the
    stream as c_void_p: undeclared, ctypes would pass 32-bit ints)."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.bq_scan.argtypes = [p] * 5 + [i] * 4 + [p]
    lib.sq_scan.argtypes = [p] * 6 + [f, f, i, p, i, i, i, p]
    lib.topk_radix_hist.argtypes = [p] * 3 + [i] * 5 + [p]
    lib.topk_count.argtypes = [p] * 3 + [i] * 3 + [p]
    lib.topk_collect.argtypes = [p] * 6 + [i] * 4 + [p]
    for fn in (lib.bq_scan, lib.sq_scan, lib.topk_radix_hist,
               lib.topk_count, lib.topk_collect):
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
