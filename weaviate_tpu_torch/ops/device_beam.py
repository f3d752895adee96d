"""Device-resident HNSW search: one launch per batch (port of the
single-device raw-corpus walk of ``weaviate_tpu/ops/device_beam.py``).

The whole walk of a query batch, the greedy descent over the upper layers
from the entrypoint and then the layer-0 best-first beam, runs in one
hand-written CUDA kernel (``csrc/device_beam.cu``) over an incrementally
synced device mirror of the host graph (``DeviceAdjacency``). The host
pays one launch and one fetch per batch instead of one round trip per hop.

``_fused_search`` is the plain PyTorch version of that kernel: a Python
loop over the JAX program's steps (``argmin`` takes the first index on
ties, the merges are stable sorts). ``fused_search`` takes it for tensors
on the CPU, as the tests do; for tensors on the card it launches the
kernel or raises, with no fallback. ``chip_smoke.py`` holds the kernel
against the plain version on the card.

Semantics are the JAX program's: lockstep best-first expansion, an
ef-bounded beam, a stop when no unexpanded entry is left (or after
``max_steps``). Tombstoned nodes stay traversable; results are filtered
after the walk. A filtered walk passes ``allow``/``keep_k``: the walk
itself is unchanged, and a second track keeps the best allowed nodes seen
along it; with ``expand`` > 0 the closest blocked neighbours of a hop
open their own adjacency rows in the same hop (two-hop widening).

Distance evaluation is pluggable, as in JAX: a scorer maps (queries,
candidate ids, operands) to distances. ``RawScorer`` gather-scores the
float32 corpus; ``BQScorer`` the packed bits and popcounts of a binary
quantizer (exact integer distances, so a BQ walk equals the plain
version's); ``SQScorer`` the byte codes of a scalar quantizer; ``RQScorer``
a rotational quantizer's byte codes with each row's lower and step;
``PQScorer`` a product quantizer's codes through its codebooks. The kernel
takes the row type of each.

Two stages ride after a walk, each its own hand-written kernel launched on
the walk's stream with no host sync between them:

- the rerank stage (``_rerank_stage``; kernel B7a, ``ops/rerank.py``,
  ``csrc/rerank.cu``): the walk's candidates rescored by a device rerank
  module against their token planes. ``fused_flat_rerank`` puts it after a
  flat scan instead: the multivector index's serving program.
- the multi-target join (``mt_join_topk``; kernel B7b, ``mt_join_kernel``
  in ``csrc/device_beam.cu``): after one walk a target, the union of the
  targets' pools scored under every target's row type, joined and cut to
  the best ``fetch`` (``device_multi_search``).

The mesh forms of the walk, the rerank stage and the multi-target search
raise ``NotImplementedError`` (slice 11).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import struct
from typing import NamedTuple, Optional

import numpy as np
import torch

from weaviate_tpu_torch.ops.distance import MASK_DISTANCE, METRICS, gather_distance
from weaviate_tpu_torch.ops.launch import bad_operand, launch_on, raw_stream
from weaviate_tpu_torch.ops.quantized import (
    SQ_METRICS,
    bq_gather_distance,
    pq_gather_distance,
    rq_gather_distance,
    sq_gather_distance,
)

KERNEL = "device_beam"
_INF = MASK_DISTANCE

# what the kernel takes (its C side refuses the same): the beam, the
# adjacency widths, D and the hop's frontier M0 * (1 + expand). The C side
# alone also refuses a query whose state passes the card's shared memory.
MAX_EF = 512
MAX_WIDTH = 128
MAX_DIMS = 4096
MAX_FRONTIER = 640
# per-query counters of ``stats``
STATS = ("expansions", "scored", "adjacency_rows", "upper_rows",
         "speculative_rows", "read_ahead_lost")

# Test/ops hook: fused-walk dispatches made by this process (the
# one-dispatch-per-batch contract is asserted against it).
_dispatch_count = 0


def dispatch_count() -> int:
    return _dispatch_count


@dataclasses.dataclass(frozen=True)
class RawScorer:
    """Full-precision gather-score. operands = (corpus [N, D],)."""

    metric: str
    precision: str

    def __call__(self, q, ids, operands):
        (corpus,) = operands
        return gather_distance(q, corpus, ids, self.metric,
                               precision=self.precision)


@dataclasses.dataclass(frozen=True)
class SQScorer:
    """operands = (codes [N, D] uint8, dec_sqnorms [N], a, s); q is the
    float32 query (normalized for cosine)."""

    metric: str

    def __call__(self, q, ids, operands):
        codes, dsq, a, s = operands
        return sq_gather_distance(q, codes, ids, dsq, a, s, self.metric)


@dataclasses.dataclass(frozen=True)
class BQScorer:
    """operands = (packed [N, W] int32 words, popcounts [N]); q is packed
    bits."""

    dims: int

    def __call__(self, q, ids, operands):
        packed, popcounts = operands
        return bq_gather_distance(q, packed, ids, popcounts, self.dims)


@dataclasses.dataclass(frozen=True)
class PQScorer:
    """operands = (codes [N, M] uint8, codebooks [M, C, dsub] float32 or
    their bfloat16 copy, dec_sqnorms [N]); q is the float32 query
    (normalized for cosine)."""

    metric: str

    def __call__(self, q, ids, operands):
        codes, codebooks, dsq = operands
        return pq_gather_distance(q, codes, codebooks, ids, dsq, self.metric)


@dataclasses.dataclass(frozen=True)
class RQScorer:
    """operands = (codes [N, D'] uint8, lower [N], step [N], dec_sqnorms
    [N]); q is the rotated float32 query [B, D']."""

    metric: str

    def __call__(self, q, ids, operands):
        codes, lower, step, dsq = operands
        return rq_gather_distance(q, codes, ids, lower, step, dsq,
                                  self.metric)


def _masked_scores(scorer, q, ids, operands):
    """[B, C] distances for candidate ids (-1 -> MASK) via the scorer."""
    d = scorer(q, ids.clamp(min=0), operands)
    return torch.where(ids >= 0, d, _INF)


def _rerank_stage(rerank, out_k, cand, tokens, tmask, rq, rqmask):
    """The rerank tail of a walk or a flat scan: module scores and a top-k,
    -> (ids [B, out_k], neg_scores [B, out_k]); on the card one launch of
    B7a, on CPU tensors its plain version (``ops/rerank.py``, where
    ``_module_scores`` is JAX's ``_rerank_module_scores``)."""
    from weaviate_tpu_torch.ops.rerank import rerank_topk

    return rerank_topk(cand, tokens, tmask, rq, rqmask, rerank, out_k)


def _walk_reranked(out, track: bool, rerank, rerank_k: int, rerank_q,
                   rerank_qmask, rerank_tokens, rerank_tmask):
    """A walk's outputs with the rerank stage over its first ``rerank_k``
    candidates (the kept track when ``track``, the beam otherwise): ->
    (beam_ids, beam_d, rerank_ids, neg_scores)."""
    pool = (out[2] if track else out[0])[:, :rerank_k]
    r_ids, r_d = _rerank_stage(rerank, rerank_k,
                               pool.to(torch.int32).contiguous(),
                               rerank_tokens, rerank_tmask, rerank_q,
                               rerank_qmask)
    return out[0], out[1], r_ids, r_d


_NO_UPPER: dict = {}


def _empty_upper(device):
    """Empty upper tables (layer-0-only walks): [0, 1, 1] and [0, 1]."""
    key = torch.device(device)
    if key not in _NO_UPPER:
        _NO_UPPER[key] = (torch.zeros((0, 1, 1), dtype=torch.int32, device=key),
                          torch.zeros((0, 1), dtype=torch.int32, device=key))
    return _NO_UPPER[key]


# ---------------------------------------------------------------------------
# plain PyTorch version of the kernel
# ---------------------------------------------------------------------------


def _two_hop_widen(adjacency, present, allow, queries, operands, scorer,
                   nbrs, nd, visited, rows, expand: int):
    """ACORN-style two-hop widening (JAX ``_two_hop_widen``): the
    ``expand`` closest blocked (disallowed) one-hop neighbours open their
    own adjacency rows in the same hop. Second-hop ids repeated inside the
    hop keep their first occurrence; visited or absent ones drop; the rest
    are marked visited (in place) and scored. -> (nbrs, nd) with the
    second hop appended."""
    b, m0 = nbrs.shape[0], adjacency.shape[1]
    blocked_d = torch.where((nbrs >= 0) & ~allow[nbrs.clamp(min=0)], nd, _INF)
    # lax.top_k(-blocked_d, expand): the smallest, lower index first on ties
    psel = torch.sort(blocked_d, dim=1, stable=True).indices[:, :expand]
    pvalid = torch.gather(blocked_d, 1, psel) < _INF
    parents = torch.where(pvalid, torch.gather(nbrs, 1, psel), -1)
    hop2 = adjacency[parents.clamp(min=0)].long()
    hop2 = torch.where(pvalid[:, :, None], hop2, -1).reshape(b, expand * m0)
    eq = hop2[:, :, None] == hop2[:, None, :]
    first = eq.to(torch.uint8).argmax(dim=2) == torch.arange(
        expand * m0, device=hop2.device)
    safe2 = hop2.clamp(min=0)
    seen2 = torch.gather(visited, 1, safe2)
    ok2 = (hop2 >= 0) & first & ~seen2 & present[safe2]
    hop2 = torch.where(ok2, hop2, -1)
    visited[rows[:, None].expand_as(hop2)[ok2], safe2[ok2]] = True
    nd2 = _masked_scores(scorer, queries, hop2, operands)
    return torch.cat([nbrs, hop2], dim=1), torch.cat([nd, nd2], dim=1)


def _fused_search(scorer, queries, operands, adjacency, present, eps,
                  upper_adj, upper_slots, ef: int, max_steps: int,
                  allow=None, keep_k: int = 0, expand: int = 0,
                  rerank=None, rerank_k: int = 0, rerank_q=None,
                  rerank_qmask=None, rerank_tokens=None, rerank_tmask=None):
    """The JAX program's walk as a Python loop over torch ops: ->
    (ids [B, ef] int32, dists [B, ef] float32) ascending, -1/MASK padded.
    With ``allow`` ([N] bool) and ``keep_k`` > 0 also (kept_ids [B,
    keep_k] int32, kept_d): the best allowed nodes seen along the walk,
    -1/MASK padded. With a ``rerank`` module the walk's first ``rerank_k``
    candidates (the kept track when filtered, the beam otherwise) go
    through the rerank stage, and the returns become (beam_ids, beam_d,
    rerank_ids [B, rerank_k], neg_scores)."""
    b = queries.shape[0]
    n = adjacency.shape[0]
    dev = adjacency.device
    rows = torch.arange(b, device=dev)
    eps = eps.to(torch.int64)
    track = allow is not None and keep_k > 0
    d0 = _masked_scores(scorer, queries, eps[:, None], operands)[:, 0]

    # upper-layer greedy descent, index 0 = top level
    for li in range(upper_adj.shape[0]):
        adj_l, slot_l = upper_adj[li], upper_slots[li]
        live = torch.ones(b, dtype=torch.bool, device=dev)
        step = 0
        while step < max_steps and bool(live.any()):
            slot = slot_l[eps].long()
            nbrs = adj_l[slot.clamp(min=0)].long()
            ok = ((slot >= 0) & live)[:, None] & (nbrs >= 0)
            ok &= present[nbrs.clamp(min=0)]
            nbrs = torch.where(ok, nbrs, -1)
            d = _masked_scores(scorer, queries, nbrs, operands)
            j = torch.argmin(d, dim=1)  # first index on ties
            bd = d[rows, j]
            upd = live & (bd < d0)
            eps = torch.where(upd, nbrs[rows, j], eps)
            d0 = torch.where(upd, bd, d0)
            live = upd
            step += 1

    # layer-0 best-first beam
    beam_ids = torch.full((b, ef), -1, dtype=torch.int64, device=dev)
    beam_ids[:, 0] = eps
    beam_d = torch.full((b, ef), _INF, dtype=torch.float32, device=dev)
    beam_d[:, 0] = d0
    expanded = torch.zeros((b, ef), dtype=torch.bool, device=dev)
    visited = torch.zeros((b, n), dtype=torch.bool, device=dev)
    visited[rows, eps.clamp(min=0)] = eps >= 0
    if track:
        allow = allow.to(device=dev, dtype=torch.bool)
        seed_ok = (eps >= 0) & allow[eps.clamp(min=0)]
        kept_ids = torch.full((b, keep_k), -1, dtype=torch.int64, device=dev)
        kept_ids[:, 0] = torch.where(seed_ok, eps, -1)
        kept_d = torch.full((b, keep_k), _INF, dtype=torch.float32,
                            device=dev)
        kept_d[:, 0] = torch.where(seed_ok, d0, _INF)
    step, alive = 0, True
    while step < max_steps and alive:
        cand_d = torch.where(expanded | (beam_ids < 0), _INF, beam_d)
        j = torch.argmin(cand_d, dim=1)
        cd = cand_d[rows, j]
        active = cd < _INF
        expanded[rows, j] |= active
        cur = torch.where(active, beam_ids[rows, j], 0)
        nbrs = adjacency[cur].long()
        nbrs = torch.where(active[:, None], nbrs, -1)
        safe = nbrs.clamp(min=0)
        seen = torch.gather(visited, 1, safe)
        ok = (nbrs >= 0) & ~seen & present[safe]
        nbrs = torch.where(ok, nbrs, -1)
        rr = rows[:, None].expand_as(nbrs)
        visited[rr[ok], safe[ok]] = True
        nd = _masked_scores(scorer, queries, nbrs, operands)
        if track and expand > 0:
            nbrs, nd = _two_hop_widen(adjacency, present, allow, queries,
                                      operands, scorer, nbrs, nd, visited,
                                      rows, expand)
        all_ids = torch.cat([beam_ids, nbrs], dim=1)
        all_d = torch.cat([beam_d, nd], dim=1)
        all_exp = torch.cat(
            [expanded, torch.zeros_like(nbrs, dtype=torch.bool)], dim=1)
        order = torch.sort(all_d, dim=1, stable=True).indices[:, :ef]
        beam_ids = torch.gather(all_ids, 1, order)
        beam_d = torch.gather(all_d, 1, order)
        expanded = torch.gather(all_exp, 1, order)
        if track:
            # this hop's allowed neighbours join the kept track; the walk
            # itself stays unfiltered
            nd_k = torch.where((nbrs >= 0) & allow[nbrs.clamp(min=0)], nd,
                               _INF)
            ka = torch.cat([kept_ids, nbrs], dim=1)
            kd = torch.cat([kept_d, nd_k], dim=1)
            korder = torch.sort(kd, dim=1, stable=True).indices[:, :keep_k]
            kept_ids = torch.gather(ka, 1, korder)
            kept_d = torch.gather(kd, 1, korder)
        alive = bool(active.any())
        step += 1
    out = (beam_ids.to(torch.int32), beam_d)
    if track:
        kept_ids = torch.where(kept_d >= _INF, -1, kept_ids)
        out += (kept_ids.to(torch.int32), kept_d)
    if rerank is not None and rerank_k > 0:
        return _walk_reranked(out, track, rerank, rerank_k, rerank_q,
                              rerank_qmask, rerank_tokens, rerank_tmask)
    return out


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------


# the kernel's row types (its C side's ``row_kind``)
_ROW_KINDS = {RawScorer: 0, BQScorer: 1, SQScorer: 2, RQScorer: 3,
              PQScorer: 4}


def _row_operands(scorer, operands):
    """(row tensor, the rows' aux tensor or None, the query width d, [(name,
    tensor, dtype, shape)] to check, the query dtype) of a scorer's
    operands."""
    if type(scorer) not in _ROW_KINDS:
        raise TypeError(f"no kernel row type for scorer {scorer!r}")
    if isinstance(scorer, RawScorer):
        if scorer.metric not in METRICS:
            raise ValueError(f"unknown metric {scorer.metric!r}")
        (corpus,) = operands
        d = corpus.shape[1]
        return corpus, None, d, [
            ("corpus", corpus, torch.float32, (corpus.shape[0], d))], \
            torch.float32
    if isinstance(scorer, BQScorer):
        packed, pop = operands
        w = packed.shape[1]
        if w != (scorer.dims + 31) // 32:
            raise ValueError(f"{w} words cannot hold {scorer.dims} bits")
        rows = packed.shape[0]
        return packed, pop, w, [
            ("packed", packed, torch.int32, (rows, w)),
            ("popcounts", pop, torch.float32, (rows,))], torch.int32
    if scorer.metric not in SQ_METRICS:
        raise ValueError(f"{type(scorer).__name__} walk has no metric "
                         f"{scorer.metric!r}")
    codes = operands[0]
    dsq = operands[{SQScorer: 1, RQScorer: 3, PQScorer: 2}[type(scorer)]]
    rows, w = codes.shape
    want = [("codes", codes, torch.uint8, (rows, w)),
            ("dec_sqnorms", dsq, torch.float32, (rows,))]
    if isinstance(scorer, PQScorer):
        cb = operands[1]
        if cb.ndim != 3 or cb.shape[0] != w or not 1 <= cb.shape[1] <= 256:
            raise ValueError(f"codebooks must be [{w}, <=256, dsub], got "
                             f"{tuple(cb.shape)}")
        if cb.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"codebooks must be float32 or bfloat16, got "
                             f"{cb.dtype}")
        want.append(("codebooks", cb, cb.dtype, tuple(cb.shape)))
        return codes, dsq, w * cb.shape[2], want, torch.float32
    if isinstance(scorer, RQScorer):
        want += [("lower", operands[1], torch.float32, (rows,)),
                 ("step", operands[2], torch.float32, (rows,))]
    return codes, dsq, w, want, torch.float32


def _check_kernel_args(scorer, queries, operands, adjacency, present, eps,
                       upper_adj, upper_slots, ef: int, max_steps: int,
                       allow=None, keep_k: int = 0, expand: int = 0):
    corpus, _aux, d, rows_want, q_dtype = _row_operands(scorer, operands)
    # the graph's rows (adjacency, present, slots) and the corpus rows may
    # differ: each grows by its own rule, and every node id is a corpus row
    n = adjacency.shape[0]
    b = queries.shape[0]
    want = [
        ("queries", queries, q_dtype, (b, d)),
        *rows_want,
        ("adjacency", adjacency, torch.int32, (n, adjacency.shape[1])),
        ("present", present, torch.bool, (n,)),
        ("eps", eps, torch.int32, (b,)),
        ("upper_adj", upper_adj, torch.int32, tuple(upper_adj.shape)),
        ("upper_slots", upper_slots, torch.int32,
         (upper_adj.shape[0], n) if upper_adj.shape[0] else
         tuple(upper_slots.shape)),
    ]
    if allow is not None:
        want.append(("allow", allow, torch.bool, (n,)))
    for name, t, dtype, shape in want:
        if t.dtype != dtype or tuple(t.shape) != shape or t.ndim != len(shape):
            raise ValueError(f"{name} must be {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != corpus.device:
            raise ValueError(f"{name} is on {t.device}, corpus on {corpus.device}")
    if b < 1:
        raise ValueError("empty query batch")
    if not 1 <= ef <= MAX_EF:
        raise ValueError(f"ef {ef} outside the kernel's [1, {MAX_EF}]")
    if max_steps < 0:
        raise ValueError(f"max_steps {max_steps} < 0")
    m0 = adjacency.shape[1]
    if not 1 <= m0 <= MAX_WIDTH:
        raise ValueError(f"layer-0 width {m0} outside [1, {MAX_WIDTH}]")
    m = upper_adj.shape[2] if upper_adj.shape[0] else 1
    if upper_adj.shape[0] and not 1 <= m <= MAX_WIDTH:
        raise ValueError(f"upper width {m} outside [1, {MAX_WIDTH}]")
    if not 1 <= d <= MAX_DIMS:
        raise ValueError(f"D={d} outside [1, {MAX_DIMS}]")
    track = allow is not None and keep_k > 0
    if not track:
        keep_k = expand = 0
    if not 0 <= keep_k <= ef:
        raise ValueError(f"keep_k {keep_k} outside [0, ef={ef}]")
    if not 0 <= expand <= m0 or m0 * (1 + expand) > MAX_FRONTIER:
        raise ValueError(f"frontier M0 * (1 + expand) = {m0} * (1 + {expand}) "
                         f"outside the kernel's {MAX_FRONTIER}")


def fused_search_cuda(scorer, queries, operands, adjacency, present, eps,
                      upper_adj, upper_slots, ef: int, max_steps: int,
                      allow: Optional[torch.Tensor] = None, keep_k: int = 0,
                      expand: int = 0, stats: Optional[torch.Tensor] = None):
    """Launches the kernel on the current stream: the contract of
    ``_fused_search`` (``operands`` the scorer's tuple: ``(corpus,)`` raw,
    ``(packed, popcounts)`` BQ, ``(codes, dec_sqnorms, a, s)`` SQ,
    ``(codes, lower, step, dec_sqnorms)`` RQ, ``(codes, codebooks,
    dec_sqnorms)`` PQ, whose float32 codebooks are rounded to the bfloat16
    copy the kernel reads (the quantizer hands that copy over); the code
    rows' queries' sums and sums of squares are taken here in float32, as
    the plain version takes them). ``stats``, an int32
    [B, 6] tensor, receives per query the counters named in ``STATS``:
    layer-0 expansions, rows scored and kept, layer-0 adjacency rows the
    walk expands (one a hop and the second hop's parents), upper rows read,
    rows scored before the visited test and then dropped, and adjacency
    rows read ahead for a node that the next hop did not expand. Raises
    ``ValueError`` on arguments outside the kernel's contract (the C side's
    refusals included) and ``RuntimeError`` on a failed launch."""
    _check_kernel_args(scorer, queries, operands, adjacency, present, eps,
                       upper_adj, upper_slots, ef, max_steps, allow, keep_k,
                       expand)
    corpus, aux, d, _, _ = _row_operands(scorer, operands)
    n = adjacency.shape[0]
    row_kind = _ROW_KINDS[type(scorer)]
    qaux, sq_a, sq_s = None, 0.0, 0.0
    row_lo = row_step = cb = None
    segs = dsub = centroids = 0
    if row_kind >= 2:
        qaux = torch.stack([torch.sum(queries, dim=-1),
                            torch.sum(queries * queries, dim=-1)],
                           dim=1).contiguous()
    if row_kind == 2:
        sq_a, sq_s = float(operands[2]), float(operands[3])
    elif row_kind == 3:
        row_lo, row_step = operands[1], operands[2]
    elif row_kind == 4:
        cb = operands[1]
        if cb.dtype != torch.bfloat16:
            cb = cb.to(torch.bfloat16)
        segs, centroids, dsub = cb.shape
    metric = getattr(scorer, "metric", "l2-squared")
    b = queries.shape[0]
    dev = corpus.device
    track = allow is not None and keep_k > 0
    if stats is not None and (stats.dtype != torch.int32
                              or tuple(stats.shape) != (b, len(STATS))
                              or stats.device != dev
                              or not stats.is_contiguous()):
        raise ValueError(f"stats must be a contiguous int32 "
                         f"[{b}, {len(STATS)}] on {dev}")
    levels = upper_adj.shape[0]
    s, m = (upper_adj.shape[1], upper_adj.shape[2]) if levels else (1, 1)
    visited = torch.zeros((b, (n + 31) // 32), dtype=torch.int32, device=dev)
    ids = torch.empty((b, ef), dtype=torch.int32, device=dev)
    dists = torch.empty((b, ef), dtype=torch.float32, device=dev)
    kept_ids = kept_d = None
    if track:
        kept_ids = torch.empty((b, keep_k), dtype=torch.int32, device=dev)
        kept_d = torch.empty((b, keep_k), dtype=torch.float32, device=dev)
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.device_beam_search(
            queries.data_ptr(), corpus.data_ptr(), ptr(aux), ptr(qaux),
            adjacency.data_ptr(), present.data_ptr(),
            ptr(allow) if track else None,
            eps.data_ptr(), upper_adj.data_ptr(), upper_slots.data_ptr(),
            visited.data_ptr(), ids.data_ptr(), dists.data_ptr(),
            ptr(kept_ids), ptr(kept_d), ptr(stats),
            b, corpus.shape[0], n, d, adjacency.shape[1], levels, s, m, ef,
            keep_k if track else 0, expand if track else 0, max_steps,
            METRICS.index(metric),
            int(getattr(scorer, "precision", "") == "bf16"), row_kind,
            getattr(scorer, "dims", 0), sq_a, sq_s, ptr(row_lo),
            ptr(row_step), ptr(cb), segs, dsub, centroids, stream)
    if err < 0:
        raise ValueError(
            f"device_beam_search refused its arguments: "
            f"{lib.device_beam_error_string(err).decode()} (code {err})")
    if err > 0:
        raise RuntimeError(
            f"device_beam_search launch failed: "
            f"{lib.device_beam_error_string(err).decode()} (code {err})")
    fused_search.launches += 1
    if track:
        return ids, dists, kept_ids, kept_d
    return ids, dists


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declares the C signatures of the built library (pointers and the
    stream as c_void_p: undeclared, ctypes would pass 32-bit ints)."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.device_beam_search.argtypes = ([p] * 16 + [i] * 16 + [f, f]
                                       + [p] * 3 + [i] * 3 + [p])
    lib.device_beam_search.restype = i
    lib.mt_join_topk.argtypes = [ctypes.c_char_p]
    lib.mt_join_topk.restype = i
    lib.mt_join_device_info.argtypes = [i, p, p]
    lib.mt_join_device_info.restype = i
    lib.device_beam_error_string.argtypes = [i]
    lib.device_beam_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The kernel's library, built on first use, with its C signatures
    declared."""
    from weaviate_tpu_torch import _build

    return declare(_build.load(KERNEL))


def fused_search(scorer, queries, operands, adjacency, present, eps,
                 upper_adj, upper_slots, ef: int, max_steps: int,
                 allow=None, keep_k: int = 0, expand: int = 0, rerank=None,
                 rerank_k: int = 0, rerank_q=None, rerank_qmask=None,
                 rerank_tokens=None, rerank_tmask=None):
    """The fused walk of a batch: -> (ids [B, ef] int32, dists [B, ef]
    float32) ascending, -1/MASK padded; with ``allow`` and ``keep_k`` > 0
    also (kept_ids [B, keep_k], kept_d); with a ``rerank`` module (beam_ids,
    beam_d, rerank_ids, neg_scores), see ``_fused_search``. CUDA tensors go
    to the kernels (B2, then B7a on the same stream), CPU tensors to the
    plain version. The ``launches`` attribute counts B2's launches."""
    dev = adjacency.device
    if dev.type == "cuda":
        out = fused_search_cuda(scorer, queries, operands, adjacency,
                                present, eps, upper_adj, upper_slots, ef,
                                max_steps, allow=allow, keep_k=keep_k,
                                expand=expand)
        if rerank is None or rerank_k <= 0:
            return out
        return _walk_reranked(out, allow is not None and keep_k > 0, rerank,
                              rerank_k, rerank_q, rerank_qmask,
                              rerank_tokens, rerank_tmask)
    if dev.type == "cpu":
        return _fused_search(scorer, queries, operands, adjacency, present,
                             eps, upper_adj, upper_slots, ef, max_steps,
                             allow=allow, keep_k=keep_k, expand=expand,
                             rerank=rerank, rerank_k=rerank_k,
                             rerank_q=rerank_q, rerank_qmask=rerank_qmask,
                             rerank_tokens=rerank_tokens,
                             rerank_tmask=rerank_tmask)
    raise ValueError(f"no fused walk for device {dev}")


fused_search.launches = 0


def _as_device(x, dev, dtype):
    """``x`` (numpy or torch) as a contiguous ``dtype`` tensor on ``dev``."""
    if not torch.is_tensor(x):
        x = np.ascontiguousarray(x)
        x = torch.from_numpy(x if x.flags.writeable else x.copy())
    return x.to(device=dev, dtype=dtype).contiguous()


def device_search(
    scorer,
    queries,
    operands,
    adjacency,
    present,
    eps,
    ef: int,
    max_steps: int,
    upper_adj=None,
    upper_slots=None,
    allow=None,
    keep_k: int = 0,
    expand: int = 0,
    rerank=None,
    rerank_k: int = 0,
    rerank_q=None,
    rerank_qmask=None,
    rerank_tokens=None,
    rerank_tmask=None,
):
    """Dispatch one fused walk (descent + layer-0 beam). Without upper
    tables the walk starts at layer 0 (construction / flat graphs). With
    ``allow`` ([N] bool, numpy or torch) and ``keep_k`` > 0 it also
    returns the kept track of the best allowed nodes; with a ``rerank``
    module the rerank stage follows over the walk's candidates (see
    ``_fused_search``), ``rerank_k`` clamped to the kept track or the beam
    it draws from. Increments the module dispatch counter."""
    global _dispatch_count
    dev = adjacency.device
    if upper_adj is None or upper_adj.shape[0] == 0:
        upper_adj, upper_slots = _empty_upper(dev)
    eps = _as_device(eps, dev, torch.int32)
    if allow is not None:
        allow = _as_device(allow, dev, torch.bool)
    if rerank is not None:
        # the rerank pool is the kept track when filtered, the beam
        # otherwise: never wider than its source
        rerank_k = min(rerank_k, keep_k if (allow is not None
                                            and keep_k > 0) else ef)
        rerank_q = _as_device(rerank_q, dev, torch.float32)
        rerank_qmask = _as_device(rerank_qmask, dev, torch.bool)
    _dispatch_count += 1
    return fused_search(scorer, queries, operands, adjacency, present, eps,
                        upper_adj, upper_slots, ef=ef, max_steps=max_steps,
                        allow=allow, keep_k=keep_k, expand=expand,
                        rerank=rerank, rerank_k=rerank_k, rerank_q=rerank_q,
                        rerank_qmask=rerank_qmask,
                        rerank_tokens=rerank_tokens,
                        rerank_tmask=rerank_tmask)


def device_search_mesh(*args, **kwargs):
    """The mesh-sharded walk (JAX ``device_search_mesh``): not ported."""
    raise NotImplementedError(
        "mesh-sharded device walk: not ported yet (ROADMAP queue A, "
        "slice 11)")


def beam_search_layer0(
    queries,
    corpus,
    adjacency,
    present,
    eps,
    ef: int,
    max_steps: int,
    metric: str = "l2-squared",
    precision: str = "bf16",
    allow=None,
    keep_k: int = 0,
):
    """Layer-0-only raw-corpus walk (compat wrapper over ``device_search``)."""
    return device_search(
        RawScorer(metric, precision), queries, (corpus,), adjacency,
        present, eps, ef=ef, max_steps=max_steps, allow=allow,
        keep_k=keep_k)


# ---------------------------------------------------------------------------
# flat scan + rerank: the multivector (MUVERA) serving program
# ---------------------------------------------------------------------------


def _fused_flat_rerank(module, queries, corpus, valid, q_tokens, q_mask,
                       tokens, tmask, fetch: int, k: int, allow=None,
                       metric: str = "dot", precision: str = "bf16"):
    """Coarse flat scan -> the rerank stage over its ``fetch`` candidates
    (JAX ``_fused_flat_rerank``): -> (ids [B, k] int32, neg_scores [B, k]).
    The scan is ``ops/distance.py flat_search``; on the card the stage is
    one launch of B7a on the scan's stream, the candidate ids never leaving
    the card."""
    from weaviate_tpu_torch.ops.distance import flat_search

    _, ids = flat_search(queries, corpus, k=fetch, metric=metric,
                         valid_mask=valid, allow_mask=allow,
                         precision=precision)
    cand = ids.to(torch.int32)[:, :fetch].contiguous()
    return _rerank_stage(module, k, cand, tokens, tmask, q_tokens, q_mask)


def fused_flat_rerank(module, queries, corpus, valid, q_tokens, q_mask,
                      tokens, tmask, fetch: int, k: int, allow=None,
                      metric: str = "dot", precision: str = "bf16"):
    """Dispatch the flat scan + rerank program; ``k`` is clamped to
    ``fetch`` (the rerank pool). Increments the module dispatch counter."""
    global _dispatch_count
    dev = corpus.device
    _dispatch_count += 1
    if allow is not None:
        allow = _as_device(allow, dev, torch.bool)
    return _fused_flat_rerank(
        module, _as_device(queries, dev, torch.float32), corpus, valid,
        _as_device(q_tokens, dev, torch.float32),
        _as_device(q_mask, dev, torch.bool), tokens, tmask, fetch=fetch,
        k=min(k, fetch), allow=allow, metric=metric, precision=precision)


# ---------------------------------------------------------------------------
# multi-target search: one walk a target, then the join (B7b)
# ---------------------------------------------------------------------------
#
# Join semantics (the host oracle: query/multi_target.combine_multi_target):
#   "weighted"  - sum_t w_t * d_t (sum: w = 1; average: 1/T; manualWeights:
#                 the caller's weights)
#   "minimum"   - min_t d_t
#   "relative"  - each target min-max normalised over the candidate pool,
#                 then sum_t w_t * norm_t (relativeScore)
# A candidate missing any target's vector is masked to MASK_DISTANCE.

_MT_JOINS = ("weighted", "minimum", "relative")


def _mt_dedup(cand):
    """In-row dedup of the cross-target union: an ascending sort clusters
    duplicates (and -1 pads, which sort first); adjacent equals collapse to
    -1."""
    cand = torch.sort(cand, dim=1).values
    dup = (cand[:, 1:] == cand[:, :-1]) & (cand[:, 1:] >= 0)
    return torch.cat([cand[:, :1], torch.where(dup, -1, cand[:, 1:])], dim=1)


def _mt_join(join, weights, stack, valid_all):
    """[B, C, T] per-target distances + [B, C] validity -> [B, C] joined
    distance (invalid slots at MASK_DISTANCE); ``weights`` [B, T]."""
    if join == "minimum":
        combined = stack.amin(dim=-1)
    elif join == "relative":
        vmask = valid_all[:, :, None]
        lo = torch.where(vmask, stack, _INF).amin(dim=1, keepdim=True)
        hi = torch.where(vmask, stack, -torch.inf).amax(dim=1, keepdim=True)
        span = hi - lo
        span = torch.where(span > 0, span, 1.0)
        combined = (((stack - lo) / span) * weights[:, None, :]).sum(dim=-1)
    else:
        combined = (stack * weights[:, None, :]).sum(dim=-1)
    return torch.where(valid_all, combined, _INF)


def _mt_topk(cand, combined, fetch: int):
    """The ``fetch`` least joined distances, ties in union order (the
    stable sort's, as ``lax.top_k`` of the negation); slots at the mask
    distance come out -1."""
    order = torch.sort(combined, dim=1, stable=True)
    d_out = order.values[:, :fetch]
    ids = torch.gather(cand, 1, order.indices[:, :fetch])
    ok = d_out < _INF
    return (torch.where(ok, ids, -1).to(torch.int32),
            torch.where(ok, d_out, _INF).to(torch.float32))


def _mt_joined(scorers, queries, operands, present, pools, weights,
               fetch: int, join: str):
    """The union of the targets' pools cut to ``fetch`` (deduplicated) and
    each member's joined distance: every member scored under every
    target's scorer (a member past a target's capacity or absent from its
    graph is invalid) -> (union [B, T*fetch], joined [B, T*fetch])."""
    cand = _mt_dedup(torch.cat([p[:, :fetch].long() for p in pools], dim=1))
    per_d = []
    valid_all = cand >= 0
    for t in range(len(scorers)):
        cap_t = present[t].shape[0]
        safe = cand.clamp(0, cap_t - 1)
        ok_t = (cand >= 0) & (cand < cap_t) & present[t][safe]
        per_d.append(_masked_scores(scorers[t], queries[t],
                                    torch.where(ok_t, cand, -1),
                                    operands[t]))
        valid_all &= ok_t
    return cand, _mt_join(join, weights.float(), torch.stack(per_d, dim=-1),
                          valid_all)


def mt_join_topk_plain(scorers, queries, operands, present, pools, weights,
                       fetch: int, join: str):
    """B7b in torch ops (the JAX program after its walks): each target's
    pool [B, >= fetch] cut to ``fetch``, the union joined
    (``_mt_joined``), the best ``fetch`` ascending -> (ids [B, fetch]
    int32, joined [B, fetch])."""
    return _mt_topk(*_mt_joined(scorers, queries, operands, present, pools,
                                weights, fetch, join), fetch)


# B7b's limits (its C side refuses the same)
MT_MAX_TARGETS = 8
MT_MAX_UNION = 4096
MT_MAX_CLUSTER = 8
# members a CTA of the cluster is planned for: ceil(union / this) CTAs
MT_MEMBERS_A_CTA = 16


class MtPlan(NamedTuple):
    """One B7b launch: ``ranks`` CTAs a query row (one thread block
    cluster; CTA r scores members [r V / ranks, (r + 1) V / ranks) of the
    V valid ones), the union's padded width, the grid, bit t of
    ``tables`` set where PQ target t reads its ADC table from the
    cluster's shared memory (a slice of ``ceil(segs / ranks)`` segments a
    CTA), and the dynamic shared memory a CTA (bytes)."""

    ranks: int
    upad: int
    grid: int
    tables: int
    smem: int


def _r4(x: int) -> int:
    return (x + 3) & ~3


@functools.lru_cache(maxsize=4096)
def mt_join_plan(b: int, targets: tuple, fetch: int, smem_max: int
                 ) -> MtPlan:
    """The launch of B7b for ``b`` query rows of ``targets`` (each (row
    kind, query width d, PQ segments, PQ centroids)) at ``fetch``, on a
    card whose blocks take ``smem_max`` bytes of dynamic shared memory:
    a CTA every MT_MEMBERS_A_CTA union slots, up to 8; the layout of
    ``mt_layout`` in the source (ids, member ids, joined distances, a
    distance a target and member, validity, the queries), then each PQ
    target's table slice where it still fits, in target order. Raises
    ``ValueError`` where the layout passes the card's shared memory."""
    t_count = len(targets)
    union = t_count * fetch
    upad = 32
    while upad < union:
        upad *= 2
    ranks = max(1, min(MT_MAX_CLUSTER, -(-union // MT_MEMBERS_A_CTA)))
    words = (3 + t_count) * upad + sum(_r4(t[1]) for t in targets)
    nbytes = 4 * words + ((upad + 15) & ~15)
    if nbytes > smem_max:
        raise ValueError(f"B7b needs {nbytes} bytes of shared memory a block "
                         f"({t_count} targets, fetch {fetch}), the card has "
                         f"{smem_max}")
    tables = 0
    for t, (kind, _d, segs, cents) in enumerate(targets):
        if kind != 4:
            continue
        slice_bytes = 4 * _r4(-(-segs // ranks) * cents)
        if nbytes + slice_bytes <= smem_max:
            tables |= 1 << t
            nbytes += slice_bytes
    return MtPlan(ranks, upad, b * ranks, tables, nbytes)


# one launch's arguments as the C entry point reads them (see
# ``mt_join_topk`` in the source): the call's 4 addresses (the stream
# last) and 8 ints, then per target 8 addresses, 11 ints and 2 floats
_MT_CALL = {t: struct.Struct(f"<4Q8i{8 * t}Q{11 * t}i{2 * t}f")
            for t in range(1, MT_MAX_TARGETS + 1)}

_mt_device: dict = {}


def _mt_card(index: int) -> int:
    """The dynamic shared memory a block of B7b can take on device
    ``index``, read once from the library."""
    smem = _mt_device.get(index)
    if smem is None:
        sms, got = ctypes.c_int(), ctypes.c_int()
        lib = _library()
        err = lib.mt_join_device_info(index, ctypes.byref(sms),
                                      ctypes.byref(got))
        if err:
            raise RuntimeError(
                f"mt_join_device_info failed: "
                f"{lib.device_beam_error_string(err).decode()}")
        smem = _mt_device[index] = got.value
    return smem


def mt_join_topk_cuda(scorers, queries, operands, present, pools, weights,
                      fetch: int, join: str):
    """B7b on the card: one launch of ``mt_join_kernel`` on the current
    stream (the plan of ``mt_join_plan``), counted in ``launches``, its
    outputs one allocation; the contract of ``mt_join_topk_plain``
    (``queries`` each target's walk queries: float32 rows, BQ's packed
    int32 words; PQ's float32 codebooks are rounded to the bfloat16 copy
    B2 reads). Raises ``ValueError`` on arguments outside the kernel's
    contract and ``RuntimeError`` on a failed launch."""
    t_count = len(scorers)
    if join not in _MT_JOINS:
        raise ValueError(f"unknown multi-target join {join!r}")
    if not 1 <= t_count <= MT_MAX_TARGETS:
        raise ValueError(f"{t_count} targets outside [1, {MT_MAX_TARGETS}]")
    if not 1 <= fetch <= MAX_EF or t_count * fetch > MT_MAX_UNION:
        raise ValueError(f"fetch {fetch} outside [1, {MAX_EF}] or a union "
                         f"of {t_count * fetch} above {MT_MAX_UNION}")
    dev = pools[0].device
    at = pools[0].get_device()
    b = pools[0].shape[0]
    if bad_operand(weights, torch.float32, (b, t_count), at):
        raise ValueError(f"weights must be contiguous float32 [{b}, "
                         f"{t_count}] on {dev}")
    ptrs, ints, floats, shapes = [], [], [], []
    keep = []  # tensors made here live until the launch is enqueued
    for t in range(t_count):
        scorer, ops, q, pool, pres = (scorers[t], operands[t], queries[t],
                                      pools[t], present[t])
        rows, aux, d, want, q_dtype = _row_operands(scorer, ops)
        want += [("queries", q, q_dtype, (b, d)),
                 ("pool", pool, torch.int32, (b, pool.shape[1])),
                 ("present", pres, torch.bool, (pres.shape[0],))]
        for name, x, dtype, shape in want:
            if bad_operand(x, dtype, shape, at):
                raise ValueError(f"target {t}: {name} must be contiguous "
                                 f"{dtype} {shape} on {dev}, got {x.dtype} "
                                 f"{tuple(x.shape)} on {x.device}")
        if pool.shape[1] < fetch:
            raise ValueError(f"target {t}: pool of {pool.shape[1]} < fetch "
                             f"{fetch}")
        kind = _ROW_KINDS[type(scorer)]
        lo = step = cb = 0
        segs = dsub = cents = 0
        sq_a = sq_s = 0.0
        if kind == 2:
            sq_a, sq_s = float(ops[2]), float(ops[3])
        elif kind == 3:
            lo, step = ops[1].data_ptr(), ops[2].data_ptr()
        elif kind == 4:
            cbt = ops[1] if ops[1].dtype == torch.bfloat16 \
                else ops[1].to(torch.bfloat16)
            keep.append(cbt)
            segs, cents, dsub = cbt.shape
            cb = cbt.data_ptr()
        ptrs += [pool.data_ptr(), q.data_ptr(), rows.data_ptr(),
                 0 if aux is None else aux.data_ptr(), lo, step, cb,
                 pres.data_ptr()]
        ints += [pool.shape[1], pres.shape[0], rows.shape[0], d, kind,
                 METRICS.index(getattr(scorer, "metric", "l2-squared")),
                 int(getattr(scorer, "precision", "") == "bf16"), segs, dsub,
                 cents, getattr(scorer, "dims", 0)]
        floats += [sq_a, sq_s]
        shapes.append((kind, d, segs, cents))
    lib = _library()
    plan = mt_join_plan(b, tuple(shapes), fetch, _mt_card(dev.index))
    out = torch.empty((2, b, fetch), dtype=torch.int32, device=dev)
    ptr = out.data_ptr()
    with launch_on(dev):
        err = lib.mt_join_topk(_MT_CALL[t_count].pack(
            weights.data_ptr(), ptr, ptr + 4 * b * fetch,
            raw_stream(dev.index), t_count, b, fetch, _MT_JOINS.index(join),
            plan.ranks, plan.tables, plan.smem, 0, *ptrs, *ints, *floats))
    if err < 0:
        raise ValueError(
            f"mt_join_topk refused its arguments: "
            f"{lib.device_beam_error_string(err).decode()} (code {err})")
    if err > 0:
        raise RuntimeError(
            f"mt_join_topk launch failed: "
            f"{lib.device_beam_error_string(err).decode()} (code {err})")
    mt_join_topk_cuda.launches += 1
    return out[0], out[1].view(torch.float32)


mt_join_topk_cuda.launches = 0


def mt_join_topk(scorers, queries, operands, present, pools, weights,
                 fetch: int, join: str):
    """The multi-target join: CUDA tensors go to B7b, CPU tensors to its
    plain version."""
    dev = pools[0].device
    if dev.type == "cuda":
        return mt_join_topk_cuda(scorers, queries, operands, present, pools,
                                 weights, fetch, join)
    if dev.type == "cpu":
        return mt_join_topk_plain(scorers, queries, operands, present, pools,
                                  weights, fetch, join)
    raise ValueError(f"no multi-target join for device {dev}")


def _mt_norm_static(t_count, allows, keep_ks, expands):
    allows = tuple(allows) if allows is not None else (None,) * t_count
    keep_ks = tuple(keep_ks) if keep_ks is not None else (0,) * t_count
    expands = tuple(expands) if expands is not None else (0,) * t_count
    return allows, keep_ks, expands


def _fused_multi_search(scorers, weights, queries, operands, adjacency,
                        present, eps, upper_adj, upper_slots, efs,
                        max_steps: int, fetch: int, join: str, allows,
                        keep_ks, expands):
    """One walk a target (each over its own planes, graph and scorer; its
    pool the kept track when filtered, else the beam), then the join ->
    (ids [B, fetch], joined [B, fetch]) ascending, -1/MASK padded. On the
    card: one B2 launch a target and one B7b launch, all on one stream."""
    pools = []
    for t in range(len(scorers)):
        out = fused_search(
            scorers[t], queries[t], operands[t], adjacency[t], present[t],
            eps[t], upper_adj[t], upper_slots[t], ef=efs[t],
            max_steps=max_steps, allow=allows[t], keep_k=keep_ks[t],
            expand=expands[t])
        filtered = allows[t] is not None and keep_ks[t] > 0
        pools.append(out[2] if filtered else out[0])
    return mt_join_topk(scorers, queries, operands, present, pools, weights,
                        fetch, join)


def device_multi_search(
    scorers,
    weights,
    queries,
    operands,
    adjacency,
    present,
    eps,
    upper_adjs,
    upper_slots,
    efs,
    max_steps: int,
    fetch: int,
    join: str,
    allows=None,
    keep_ks=None,
    expands=None,
):
    """Dispatch one multi-target search: per-target walks + the
    cross-scored join + top-k. Increments the module dispatch counter once
    (the JAX program's one dispatch; here T walk launches and one join
    launch)."""
    global _dispatch_count
    t_count = len(scorers)
    if join not in _MT_JOINS:
        raise ValueError(f"unknown multi-target join {join!r}")
    allows, keep_ks, expands = _mt_norm_static(
        t_count, allows, keep_ks, expands)
    ua, us, al, ep = [], [], [], []
    for t in range(t_count):
        dev = adjacency[t].device
        a, s = upper_adjs[t], upper_slots[t]
        if a is None or a.shape[0] == 0:
            a, s = _empty_upper(dev)
        ua.append(a)
        us.append(s)
        ep.append(_as_device(eps[t], dev, torch.int32))
        al.append(None if allows[t] is None
                  else _as_device(allows[t], dev, torch.bool))
    dev = adjacency[0].device
    _dispatch_count += 1
    return _fused_multi_search(
        tuple(scorers), _as_device(weights, dev, torch.float32),
        tuple(queries), tuple(operands), tuple(adjacency), tuple(present),
        tuple(ep), tuple(ua), tuple(us), efs=tuple(efs),
        max_steps=max_steps, fetch=fetch, join=join, allows=tuple(al),
        keep_ks=keep_ks, expands=expands)


def device_multi_search_mesh(*args, **kwargs):
    """The mesh form of the multi-target search: not ported."""
    raise NotImplementedError(
        "mesh-sharded multi-target search: not ported yet (ROADMAP queue A, "
        "slice 11)")


# ---------------------------------------------------------------------------
# device mirror of the host graph
# ---------------------------------------------------------------------------


class DeviceAdjacency:
    """Incrementally synced device mirror of the host graph topology.

    Layer 0: inserts and deletes mutate host rows; the mirror tracks dirty
    rows and scatters only those before a walk. The scatter is out of
    place (``index_copy``): a concurrent walk may still hold the old
    tensor. Capacity growth re-uploads wholesale.

    Upper layers: compact slot-addressed tables ([L, S, M] adjacency and
    [L, N] node -> slot maps, top level first) for the kernel's greedy
    descent, rebuilt wholesale when the host graph's ``upper_version``
    (or its capacity) moves."""

    def __init__(self, graph, device):
        self.graph = graph
        self.device = torch.device(device)
        self._adj = None        # [cap, M0] int32
        self._present = None    # [cap] bool
        self._synced_cap = 0
        self._dirty: set[int] = set()
        self._upper = None      # (upper_adj [L, S, M], upper_slots [L, cap])
        self._upper_version = -1
        self._upper_cap = 0

    def mark_dirty(self, *node_ids) -> None:
        self._dirty.update(int(x) for x in node_ids)

    def drop_device(self) -> int:
        """Release the mirrored tables (warm tier). Returns bytes released;
        the next ``sync`` re-uploads wholesale."""
        freed = self.nbytes
        self._adj = None
        self._present = None
        self._synced_cap = 0
        self._dirty.clear()
        self._upper = None
        self._upper_version = -1
        return freed

    @property
    def nbytes(self) -> int:
        """Device footprint of the mirrored topology (layer 0 + upper)."""
        total = 0
        for a in (self._adj, self._present):
            if a is not None:
                total += a.numel() * a.element_size()
        if self._upper is not None:
            total += sum(a.numel() * a.element_size() for a in self._upper)
        return total

    def sync(self):
        """-> (adjacency, present) device tensors, up to date.

        Inserts may run while this reads the host graph (torn reads, as on
        the host walk): it takes one reference to each host array, and an
        edge to a node past the capacity it read, linked after that read,
        becomes -1, as the host walk skips it. The kernel never reads past
        the mirror."""
        g = self.graph
        layer0, levels = g.layer0, g.levels
        cap = min(len(layer0), len(levels))
        if self._adj is None or self._synced_cap != cap:
            self._adj = torch.from_numpy(_within(layer0[:cap], cap)).to(
                self.device)
            self._present = torch.from_numpy(levels[:cap] >= 0).to(self.device)
            self._synced_cap = cap
            self._dirty.clear()
            return self._adj, self._present
        if self._dirty:
            # swap the set first: construction keeps marking rows while
            # this scatter runs
            dirty, self._dirty = self._dirty, set()
            idx = np.fromiter((i for i in dirty if i < cap), np.int64)
            if len(idx):
                it = torch.from_numpy(idx).to(self.device)
                rows = torch.from_numpy(_within(layer0[idx], cap)).to(
                    self.device)
                pres = torch.from_numpy(levels[idx] >= 0).to(self.device)
                self._adj = self._adj.index_copy(0, it, rows)
                self._present = self._present.index_copy(0, it, pres)
        return self._adj, self._present

    def sync_upper(self):
        """-> (upper_adj, upper_slots) device tables for the descent,
        rebuilt only when the host graph's upper_version (or capacity)
        moved."""
        g = self.graph
        ver = getattr(g, "upper_version", 0)
        cap = g.capacity
        if (self._upper is not None and self._upper_version == ver
                and self._upper_cap == cap):
            return self._upper
        levels = max(0, int(g.max_level))
        if levels == 0:
            self._upper = _empty_upper(self.device)
        else:
            snap = _snap_upper(g, levels)
            if snap is None:
                # pathological churn: serve the previous tables (older
                # edges are a valid graph) and retry on the next search
                return self._upper if self._upper is not None \
                    else _empty_upper(self.device)
            sizes = [len(items) for items in snap]
            # pow2-pad the slot axis, as the JAX mirror does
            s_pad = 1 << max(3, (max(1, max(sizes)) - 1).bit_length())
            adj = np.full((levels, s_pad, g.m), -1, np.int32)
            slots = np.full((levels, cap), -1, np.int32)
            for li, items in enumerate(snap):
                for slot, (node, nbrs) in enumerate(items):
                    if node >= cap:
                        continue  # torn read mid-grow; next sync catches up
                    slots[li, node] = slot
                    nb = nbrs[:g.m]
                    if len(nb):
                        adj[li, slot, :len(nb)] = _within(nb, cap)
            self._upper = (torch.from_numpy(adj).to(self.device),
                           torch.from_numpy(slots).to(self.device))
        self._upper_version = ver
        self._upper_cap = cap
        return self._upper


def _within(ids: np.ndarray, cap: int) -> np.ndarray:
    """int32 ``ids`` with those at or past ``cap`` set to -1."""
    ids = np.asarray(ids, np.int32)
    return np.ascontiguousarray(np.where(ids < cap, ids, -1), np.int32)


def _snap_upper(g, levels: int):
    """Lock-free snapshot of the upper-level dicts, top level first, with a
    short retry when a dict resizes under a concurrent insert. None =
    pathological churn; the caller serves stale tables."""
    for _ in range(8):
        try:
            return [list(g.upper.get(lv, {}).items())
                    for lv in range(levels, 0, -1)]
        except RuntimeError:  # resized under us; re-read
            continue
    return None
