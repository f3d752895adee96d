"""Fused L2 flat scan: masked distance + per-block bucketed top-k.

Port of ``weaviate_tpu/ops/pallas_flat.py``. Its one Pallas kernel
(``_kernel``, launched by ``pallas_flat_topk``) becomes the hand-written
CUDA C++ kernel ``csrc/fused_flat.cu``; ``fused_flat_topk`` launches it for
tensors on the card. ``fused_flat_topk_reference`` is the plain PyTorch
version of the same function: the CPU tests hold it against the JAX kernel
and ``chip_smoke.py`` holds the CUDA kernel against it. The wrapper takes
the plain version only for tensors on the CPU; on the card it launches the
kernel or raises, with no fallback.

Selection inside a corpus block is bucketed as in the JAX kernel: the C
block columns fold into C/fold strided buckets (bucket j holds columns
{j, j + C/fold, ...}), each keeping its (min, argmin at the lowest column),
and k extract-min rounds over the bucket minima take the lowest bucket on
ties and retire a taken bucket whole. The fold width grows with the live
row count so the loss from bucket collisions stays bounded; small or
heavily masked corpora get fold = 1, which is exact selection.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from weaviate_tpu_torch.ops.distance import MASK_DISTANCE
from weaviate_tpu_torch.ops.topk import smallest_k

KERNEL = "fused_flat"
# the k extract-min rounds are unrolled per query; the serving route only
# sends k <= MAX_K here
MAX_K = 64
# the kernel's variants, by the code ``fused_flat_variant`` returns: the
# first design, kept for the shapes the new one cannot take, and the
# resident-query ring shared by a thread-block cluster (see the header of
# csrc/fused_flat.cu)
VARIANTS = ("legacy", "cluster")

# corpus block rows, largest first; the ladder walks down for small or
# oddly sized corpora
_BLOCK_LADDER = (2048, 1024, 512, 256, 128)


def bucket_live(live: int) -> int:
    """Coarse power-of-4 bucket of a live-row count. Fold sizing only needs
    the order of magnitude of the candidate population."""
    b = 1
    while b * 4 <= max(1, live):
        b *= 4
    return b


def _pick_block(n: int, chunk_size: int) -> int:
    for blk in _BLOCK_LADDER:
        if blk <= chunk_size and n % blk == 0:
            return blk
    raise ValueError(
        f"corpus rows {n} have no block divisor <= chunk {chunk_size}")


def fits(n: int, chunk_size: int) -> bool:
    """Whether a corpus of ``n`` rows satisfies the kernel's shape contract
    (the serving route in ``index/flat.py`` asks this)."""
    try:
        _pick_block(n, chunk_size)
        return True
    except ValueError:
        return False


def fold_width(block: int, k: int, live: int) -> int:
    """Bucket fold of a block: expected missed candidates grow as
    C(k,2)*(fold-1)/live, so capping fold at live/(64*k^2) keeps the loss
    under ~1%; tiny or heavily masked corpora get fold = 1 (exact)."""
    fold = 16
    while fold > 1 and (block // fold < k or fold * 64 * k * k > live):
        fold //= 2
    if block // fold < k:
        raise ValueError(f"k={k} exceeds block {block} bucket count")
    return fold


def plan(corpus: torch.Tensor, k: int, chunk_size: int,
         live_rows: int | None) -> tuple[int, int]:
    """(block rows, fold) of a scan of ``corpus``: the ladder block that
    divides it, and the fold sized from ``live_rows`` (or the row count)."""
    n = corpus.shape[0]
    block = _pick_block(n, chunk_size)
    return block, fold_width(block, k, live_rows if live_rows else n)


def _as_mask(mask: torch.Tensor) -> torch.Tensor:
    """Boolean keep-mask from a bool or 1/0 float mask."""
    return mask if mask.dtype == torch.bool else mask > 0.5


def block_topk_reference(queries, corpus, corpus_sqnorms, mask, k: int,
                         block: int, fold: int):
    """Plain PyTorch per-block candidates: ([N/C, B, k] float32 distances,
    [N/C, B, k] int32 columns inside the block)."""
    n = corpus.shape[0]
    b = queries.shape[0]
    g = n // block
    folds = block // fold
    qf = queries.float()
    # bf16-rounded operands, float32 products and sums
    ip = qf.to(torch.bfloat16).float() @ corpus.to(torch.bfloat16).float().T
    q_sq = torch.sum(qf * qf, dim=1, keepdim=True)
    d = torch.clamp(q_sq - 2.0 * ip + corpus_sqnorms.float()[None, :], min=0.0)
    d = torch.where(_as_mask(mask)[None, :], d, MASK_DISTANCE)
    # strided fold: bucket j of block i holds its columns {j, j+folds, ...}
    dr = d.reshape(b, g, fold, folds)
    fmin = dr.amin(dim=2)                                    # [B, G, F]
    loc3 = torch.arange(fold, device=d.device).view(1, 1, fold, 1)
    floc = torch.where(dr == fmin[:, :, None, :], loc3, fold).amin(dim=2)
    fcol = torch.arange(folds, device=d.device)
    vs, gs = [], []
    for _ in range(k):
        row_min = fmin.amin(dim=-1)                          # [B, G]
        j = torch.where(fmin == row_min[..., None], fcol, folds).amin(dim=-1)
        loc = torch.gather(floc, -1, j[..., None])[..., 0]
        vs.append(row_min)
        gs.append(loc * folds + j)
        fmin = fmin.scatter(-1, j[..., None], MASK_DISTANCE)
    vals = torch.stack(vs, dim=-1).transpose(0, 1)           # [G, B, k]
    ids = torch.stack(gs, dim=-1).transpose(0, 1).to(torch.int32)
    return vals.contiguous(), ids.contiguous()


def _check_shape(b: int, n: int, d: int, k: int, block: int, fold: int):
    """The kernel's shape contract (its C side refuses the same)."""
    if b < 1 or d < 1 or not 1 <= k <= MAX_K:
        raise ValueError(f"B={b}, D={d}, k={k} outside the kernel's range "
                         f"(B >= 1, D >= 1, 1 <= k <= {MAX_K})")
    if block not in _BLOCK_LADDER or n < block or n % block:
        raise ValueError(f"block {block} must be a ladder block dividing "
                         f"the {n} corpus rows")
    if not 1 <= fold <= 16 or block % fold or block // fold < k:
        raise ValueError(f"fold {fold} must divide block {block} into at "
                         f"least k={k} buckets, fold <= 16")


def _check(queries, corpus, corpus_sqnorms, mask, k, block, fold):
    n, d = corpus.shape
    if queries.dtype != torch.float32 or queries.ndim != 2 \
            or queries.shape[1] != d:
        raise ValueError(
            f"queries must be float32 [B, {d}], got {queries.dtype} "
            f"{tuple(queries.shape)}")
    if corpus.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"corpus must be float32 or bfloat16, got {corpus.dtype}")
    if corpus_sqnorms.dtype != torch.float32 or corpus_sqnorms.shape != (n,):
        raise ValueError(f"corpus_sqnorms must be float32 [{n}]")
    if mask.dtype != torch.bool or mask.shape != (n,):
        raise ValueError(f"mask must be bool [{n}]")
    for name, t in (("queries", queries), ("corpus", corpus),
                    ("corpus_sqnorms", corpus_sqnorms), ("mask", mask)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != corpus.device:
            raise ValueError(f"{name} is on {t.device}, corpus on {corpus.device}")
    _check_shape(queries.shape[0], n, d, k, block, fold)


def kernel_variant(queries, corpus, k: int, block: int,
                   fold: int) -> tuple[str, dict]:
    """The variant of the CUDA kernel that ``block_topk_cuda`` launches for
    these arguments, and its plan: query tile rows, ring stages, cluster
    size and shared-memory bytes. The kernel's C side chooses it from the
    shape alone; arguments outside the contract raise ValueError."""
    n, d = corpus.shape
    _check_shape(queries.shape[0], n, d, k, block, fold)
    if corpus.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"corpus must be float32 or bfloat16, got {corpus.dtype}")
    plan = (ctypes.c_int * 4)()
    code = _library().fused_flat_variant(
        corpus.data_ptr(), int(corpus.dtype == torch.bfloat16),
        queries.shape[0], n, d, k, block, fold, plan)
    if not 0 <= code < len(VARIANTS):
        raise RuntimeError(f"fused_flat_variant refused the shape ({code})")
    return VARIANTS[code], dict(zip(
        ("query_tile", "stages", "cluster", "smem_bytes"), plan))


def count_launch(variant: str) -> None:
    """Counts one launch of ``variant``: the total and the per-variant
    counts on ``fused_flat_topk``."""
    fused_flat_topk.launches += 1
    fused_flat_topk.launches_by_variant[variant] += 1


def reset_launches() -> None:
    """Sets every launch count to 0."""
    fused_flat_topk.launches = 0
    fused_flat_topk.launches_by_variant = dict.fromkeys(VARIANTS, 0)


def block_topk_cuda(queries, corpus, corpus_sqnorms, mask, k: int,
                    block: int, fold: int):
    """The CUDA kernel's per-block candidates, same contract as
    ``block_topk_reference``. Launches on the current stream; raises on
    arguments outside the kernel's contract or a refused launch."""
    mask = _as_mask(mask)
    _check(queries, corpus, corpus_sqnorms, mask, k, block, fold)
    n, d = corpus.shape
    b = queries.shape[0]
    lib = _library()
    variant, _ = kernel_variant(queries, corpus, k, block, fold)
    vals = torch.empty((n // block, b, k), dtype=torch.float32,
                       device=corpus.device)
    ids = torch.empty((n // block, b, k), dtype=torch.int32,
                      device=corpus.device)
    with torch.cuda.device(corpus.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.fused_flat_l2_topk(
            queries.data_ptr(), corpus.data_ptr(),
            int(corpus.dtype == torch.bfloat16), corpus_sqnorms.data_ptr(),
            mask.data_ptr(), b, n, d, k, block, fold,
            vals.data_ptr(), ids.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(
            f"fused_flat_l2_topk launch failed: "
            f"{lib.fused_flat_error_string(err).decode()} (cudaError {err})")
    count_launch(variant)
    return vals, ids


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declares the C signatures of a built kernel library (pointers and
    the stream as c_void_p: undeclared, ctypes would pass 32-bit ints)."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fused_flat_l2_topk.argtypes = [
        p, p, i, p, p, i, i, i, i, i, i, p, p, p]
    lib.fused_flat_l2_topk.restype = i
    lib.fused_flat_variant.argtypes = [p, i, i, i, i, i, i, i, p]
    lib.fused_flat_variant.restype = i
    lib.fused_flat_error_string.argtypes = [i]
    lib.fused_flat_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The kernel's library, built on first use, with its C signatures
    declared."""
    from weaviate_tpu_torch import _build

    return declare(_build.load(KERNEL))


def merge_blocks(vals: torch.Tensor, ids: torch.Tensor, block: int, k: int):
    """Global merge of per-block candidates [G, B, k] -> [B, k]: one stable
    selection over [B, G*k] (ties: lower block, then earlier round, as
    ``lax.top_k`` orders them), ids offset by block base, sentinel -> -1."""
    g, b, _ = vals.shape
    base = (torch.arange(g, dtype=torch.int32, device=ids.device)
            * block)[:, None, None]
    flat_v = vals.transpose(0, 1).reshape(b, -1)
    flat_i = (ids + base).transpose(0, 1).reshape(b, -1)
    out_v, pos = smallest_k(flat_v, k)
    out_i = torch.gather(flat_i, 1, pos)
    return out_v, torch.where(out_v >= MASK_DISTANCE, -1, out_i)


def fused_flat_topk_reference(queries, corpus, corpus_sqnorms, mask, k: int,
                              chunk_size: int = 131072,
                              live_rows: int | None = None):
    """Plain PyTorch version of ``fused_flat_topk``: same arguments, same
    result up to float32 summation order."""
    block, fold = plan(corpus, k, chunk_size, live_rows)
    vals, ids = block_topk_reference(queries, corpus, corpus_sqnorms, mask,
                                     k, block, fold)
    return merge_blocks(vals, ids, block, k)


def fused_flat_topk(queries, corpus, corpus_sqnorms, mask, k: int,
                    chunk_size: int = 131072, live_rows: int | None = None):
    """L2 top-k over the corpus. queries [B, D] float32; corpus [N, D]
    float32 or bfloat16 (rounded to bf16 for the product); corpus_sqnorms
    [N] float32; mask [N] bool (or 1/0 float). N must be a multiple of a
    ladder block <= chunk_size (pad with masked rows). ``live_rows`` is the
    unmasked candidate population (pass it through ``bucket_live``); it
    sizes the fold. Returns ([B, k] float32, [B, k] int32), -1 for empty
    slots.

    CUDA tensors go to the kernel, CPU tensors to the plain version. The
    ``launches`` attribute counts kernel launches, ``launches_by_variant``
    the launches of each of ``VARIANTS``; ``reset_launches`` zeroes both.
    """
    block, fold = plan(corpus, k, chunk_size, live_rows)
    if corpus.device.type == "cuda":
        vals, ids = block_topk_cuda(queries, corpus, corpus_sqnorms, mask,
                                    k, block, fold)
    elif corpus.device.type == "cpu":
        vals, ids = block_topk_reference(queries, corpus, corpus_sqnorms,
                                         mask, k, block, fold)
    else:
        raise ValueError(f"no fused flat kernel for device {corpus.device}")
    return merge_blocks(vals, ids, block, k)


reset_launches()
