"""Hybrid fusion on the device: rankedFusion / relativeScoreFusion top-k
(port of ``weaviate_tpu/ops/fusion.py``).

Reference: ``usecases/traverser/hybrid/hybrid_fusion.go``, the two
algorithms ``query/fusion.py`` implements on the host with dicts. Each
leg's candidates arrive as dense arrays (union-slot ids + raw scores),
each entry's fused contribution is summed into the union's accumulator,
and a top-k of the slots present gives the fused page.

Slot assignment (``query/fusion.py assemble_slots``) keeps the host twin's
dict-insertion order, and the top-k puts the lower slot first on equal
scores as the host's stable sort puts the earlier key first, so the page
order matches the host page, with scores equal up to float32 rounding.

Kernel B6b (``csrc/hybrid.cu``: ``fusion_small_kernel`` for the widths
hybrid search serves, ``fusion_topk_kernel`` for wider ones) is the whole
fusion in one launch a request on the card. The plain versions
(``ranked_fusion_plain``, ``relative_score_fusion_plain``) are the JAX
programs step for step; ``ranked_fusion_topk`` and
``relative_score_fusion_topk`` take them for CPU tensors only, and on a
CUDA tensor launch B6b or raise. Shapes bucket to powers of two (legs x
leg length, union size), as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from weaviate_tpu_torch.ops import sparse
from weaviate_tpu_torch.ops.launch import launch_on

# the classic RRF constant used by the reference (query/fusion.py twin)
RANKED_FUSION_OFFSET = 60.0

# Test/ops hook, mirroring ops.device_beam.dispatch_count: fusions
# dispatched by this process ("hybrid fusion is one dispatch a request").
_dispatch_count = 0


def dispatch_count() -> int:
    return _dispatch_count


def bucket(n: int, floor: int = 8) -> int:
    """pow2 shape bucket (same discipline as the beam's row bucketing)."""
    return max(floor, 1 << max(0, int(n - 1).bit_length()))


def _scatter_fused(slots, contrib, union: int):
    """Sum each entry's fused contribution into the union accumulator, legs
    in order and entries in order (slots -1 and past the union dropped).
    Returns (acc [union], present [union]); ``masked_score_topk`` of them
    is the page (absent slots score 0, id -1; lower slot first on ties)."""
    ok = (slots >= 0) & (slots < union)
    rows = slots[ok].long()
    acc = torch.zeros(union, dtype=torch.float32, device=slots.device)
    acc.index_add_(0, rows, contrib[ok])
    present = torch.zeros(union, dtype=torch.bool, device=slots.device)
    present[rows] = True
    return acc, present


def ranked_fusion_plain(slots, weights, k: int, union: int):
    """Reciprocal-rank fusion: score = sum over legs of weight / (60 + rank).
    slots [S, L] int32 in rank order (-1 pad), weights [S] float32."""
    ranks = torch.arange(slots.shape[1], dtype=torch.float32,
                         device=slots.device)
    contrib = weights[:, None] / (RANKED_FUSION_OFFSET + ranks)[None, :]
    return sparse.masked_score_topk(*_scatter_fused(slots, contrib, union), k)


def relative_score_fusion_plain(slots, scores, weights, k: int, union: int):
    """Min-max normalise each leg's scores to [0, 1], then the weighted sum;
    a leg with one distinct score (or one entry) normalises to 1.0."""
    ok = slots >= 0
    big = float(np.finfo(np.float32).max)
    lo = torch.where(ok, scores, torch.full_like(scores, big)).amin(
        1, keepdim=True)
    hi = torch.where(ok, scores, torch.full_like(scores, -big)).amax(
        1, keepdim=True)
    span = hi - lo
    norm = torch.where(span > 0.0,
                       (scores - lo) / torch.clamp(span, min=1e-30),
                       torch.ones_like(scores))
    return sparse.masked_score_topk(
        *_scatter_fused(slots, weights[:, None] * norm, union), k)


def ranked_fusion_topk(slots, weights, k: int, union: int):
    """Returns (fused scores [k], slot ids [k], -1 where absent)."""
    if slots.device.type == "cpu":
        return ranked_fusion_plain(slots, weights, k, union)
    return fusion_topk_cuda(slots, None, weights, k, union)


def relative_score_fusion_topk(slots, scores, weights, k: int, union: int):
    """Returns (fused scores [k], slot ids [k], -1 where absent)."""
    if slots.device.type == "cpu":
        return relative_score_fusion_plain(slots, scores, weights, k, union)
    return fusion_topk_cuda(slots, scores, weights, k, union)


def _align16(n: int) -> int:
    return -(-n // 16) * 16


def fusion_path(legs: int, width: int, union: int, k: int) -> str:
    """The path B6b takes at a shape: ``small`` (a warp a leg, the widths
    hybrid search serves), ``shared`` (the general path, its buffers in
    shared memory) or ``device`` (its buffers in device memory); the C
    entry's choice, from the source's constants."""
    c = sparse.CONST
    if legs <= c["kFusionSmallLegs"] and width <= c["kFusionSmallLen"] \
            and union <= c["kFusionSmallUnion"] and k <= c["kFusionSmallK"]:
        return "small"
    return "shared" if fusion_smem_bytes(legs, width, union) else "device"


def fusion_smem_bytes(legs: int, width: int, union: int) -> int:
    """The general path's shared memory at (legs, L, union): 0 where its
    buffers go to device memory instead."""
    b = (_align16(bucket(legs * width, 1) * 8) + _align16(union * 4)
         + _align16(union))
    return b if b <= sparse.CONST["kFusionSmem"] else 0


def fusion_topk_cuda(slots, scores, weights, k: int, union: int):
    """B6b on the card: one launch of ``fusion_small_kernel`` or
    ``fusion_topk_kernel`` (``scores`` None: rankedFusion), counted in
    ``launches``, into one allocation (the page, and the general path's
    device-memory buffers where it needs them). Raises on arguments the
    kernel does not take, or when the launch fails."""
    dev = slots.device
    if slots.dim() != 2 or slots.dtype != torch.int32 \
            or not slots.is_contiguous():
        raise ValueError(f"slots must be contiguous int32 [S, L], got "
                         f"{slots.dtype} {tuple(slots.shape)}")
    legs, width = slots.shape
    if scores is not None and (scores.dtype != torch.float32
                               or tuple(scores.shape) != (legs, width)
                               or not scores.is_contiguous()
                               or scores.device != dev):
        raise ValueError("scores must be contiguous float32 like slots")
    if weights.dtype != torch.float32 or tuple(weights.shape) != (legs,) \
            or weights.device != dev:
        raise ValueError("weights must be float32 [S] beside slots")
    if not 1 <= k <= union:
        raise ValueError(f"k={k} outside [1, union={union}]")
    lib = sparse._library()
    page = -(-k // 4) * 4  # words: the scratch from 16 bytes
    scratch = 0
    if fusion_path(legs, width, union, k) == "device":
        scratch = bucket(legs * width, 1) * 8 + union * 5
    buf = torch.empty(2 * page + -(-scratch // 4), dtype=torch.int32,
                      device=dev)
    ptr = buf.data_ptr()
    with launch_on(dev):
        err = lib.fusion_topk(
            slots.data_ptr(), None if scores is None else scores.data_ptr(),
            weights.data_ptr(), legs, width, union, k, int(scores is None),
            ptr + 8 * page if scratch else None, ptr, ptr + 4 * k,
            torch.cuda.current_stream(dev).cuda_stream)
    sparse.raise_on(lib, err, "fusion_topk")
    fusion_topk_cuda.launches += 1
    return buf[:k].view(torch.float32), buf[k:2 * k]


fusion_topk_cuda.launches = 0


def fuse_topk(slot_sets, score_sets, weights, k: int, algorithm: str,
              union_size: int, device=None):
    """Host-callable entry: pad each leg to one pow2 (legs x length)
    bucket, pack slots, scores and weights into one host buffer and make
    one upload, run the requested fusion as one launch on ``device`` (the
    card unless the caller names another), and hand back (slot ids [<=k]
    int32 np, fused scores [<=k] float32 np) in one download, with the
    absent tail trimmed.

    slot_sets / score_sets: one int/float sequence per leg (rank order);
    union_size: distinct keys across all legs (slot ids are < this).
    """
    from weaviate_tpu_torch.index.store import resolve_device

    global _dispatch_count
    if algorithm not in ("rankedFusion", "relativeScoreFusion"):
        raise ValueError(f"unknown fusion algorithm {algorithm!r}")
    dev = resolve_device(device)
    n_sets = max(1, len(slot_sets))
    l_max = bucket(max([1] + [len(s) for s in slot_sets]))
    union = bucket(max(union_size, k))
    cells = n_sets * l_max
    # one buffer: slots [S, L] int32 | scores [S, L] float32 | weights [S]
    host = np.zeros(2 * cells + n_sets, np.int32)
    slots = host[:cells].reshape(n_sets, l_max)
    scores = host[cells:2 * cells].view(np.float32).reshape(n_sets, l_max)
    slots[:] = -1
    for i, ss in enumerate(slot_sets):
        slots[i, :len(ss)] = ss
        scores[i, :len(ss)] = score_sets[i]
    host[2 * cells:2 * cells + len(weights)].view(np.float32)[:] = weights
    t = torch.from_numpy(host).to(dev)
    t_slots = t[:cells].view(n_sets, l_max)
    t_w = t[2 * cells:].view(torch.float32)
    kk = min(k, union)
    if algorithm == "rankedFusion":
        vals, ids = ranked_fusion_topk(t_slots, t_w, kk, union)
    else:
        vals, ids = relative_score_fusion_topk(
            t_slots, t[cells:2 * cells].view(torch.float32).view(
                n_sets, l_max), t_w, kk, union)
    _dispatch_count += 1
    # result materialization: the one host sync of the fusion stage
    out_vals, out_ids = sparse.page_to_host(vals, ids)
    live = out_ids >= 0
    return out_ids[live], out_vals[live]
