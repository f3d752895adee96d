"""The HFresh posting top-k (B9a; port of the device part of
``HFreshIndex.search``, ``weaviate_tpu/index/hfresh.py:319-340``).

For each query row: the distance to each of its candidate columns (corpus
rows named by ``cand``), ``MASK_DISTANCE`` where ``mask`` or the store's
``valid`` bit is off, and the ``kk = min(k, C)`` smallest ascending, equal
distances lower column first (``lax.top_k``'s order on the negated
distances). ``posting_topk_plain`` is the plain PyTorch version;
``posting_topk_cuda`` launches the hand-written kernel ``csrc/hfresh.cu``
(one launch a batch, counted in ``launches``); ``posting_topk`` takes the
plain version for CPU tensors and the kernel for CUDA tensors, with no
fallback between them.
"""

from __future__ import annotations

import ctypes
import functools
import struct

import torch

from weaviate_tpu_torch.ops.distance import MASK_DISTANCE, METRICS, gather_distance
from weaviate_tpu_torch.ops.launch import bad_operand, launch_on, raw_stream
from weaviate_tpu_torch.ops.topk import smallest_k

KERNEL = "hfresh"
# one launch's arguments as the C entry point reads them (a PostingCall):
# 10 addresses (the stream last), 9 ints
_CALL = struct.Struct("<10Q9i")
_BINS, _MISC = 256, 16


def posting_topk_plain(queries, corpus, valid, cand, mask, k: int,
                       metric: str):
    """B9a in torch ops: -> (distances [B, kk] float32, columns [B, kk]
    int32). ``queries`` [B, D] float32, ``corpus`` [N, D] float32, ``valid``
    [N] bool, ``cand`` [B, C] int (in [0, N)), ``mask`` [B, C] bool."""
    d = gather_distance(queries, corpus, cand, metric, precision="fp32")
    live = valid[cand.long()]
    d = torch.where(mask & live, d, MASK_DISTANCE)
    v, pos = smallest_k(d, min(k, cand.shape[1]))
    return v, pos.to(torch.int32)


def head_bytes(d: int) -> int:
    """Shared memory of a CTA before its keys (``head_bytes`` of the
    source): the query rounded to 16 bytes, the histogram, the scalars."""
    return 4 * ((d + 3) & ~3) + 4 * _BINS + 4 * _MISC


def posting_plan(c: int, d: int, kk: int, smem_max: int) -> tuple:
    """(keys in shared memory, kept keys in shared memory, bytes a CTA):
    the keys of a row's C columns stay in shared memory where they fit
    beside the query, then the kk kept keys where they fit too; the rest
    go to a global scratch."""
    smem = head_bytes(d)
    if smem > smem_max:
        raise ValueError(f"B9a needs {smem} bytes of shared memory for "
                         f"d {d}, the card has {smem_max}")
    keys_smem = smem + 8 * c <= smem_max
    if keys_smem:
        smem += 8 * c
    sel_smem = smem + 8 * kk <= smem_max
    if sel_smem:
        smem += 8 * kk
    return keys_smem, sel_smem, smem


_device_info: dict = {}


def _smem_max(index: int) -> int:
    """Dynamic shared memory a block of B9a can take on device ``index``,
    read once from the library."""
    got = _device_info.get(index)
    if got is None:
        smem = ctypes.c_int()
        lib = _library()
        err = lib.hfresh_device_info(index, ctypes.byref(smem))
        if err:
            raise RuntimeError(f"hfresh_device_info failed: "
                               f"{lib.hfresh_error_string(err).decode()}")
        got = _device_info[index] = smem.value
    return got


def posting_topk_cuda(queries, corpus, valid, cand, mask, k: int,
                      metric: str):
    """B9a on the card: one launch of ``posting_topk_kernel`` on the current
    stream, counted in ``launches``, its outputs one allocation.
    ``queries`` float32 [B, D], ``corpus`` float32 [N, D], ``valid`` bool
    [N], ``cand`` int32 [B, C] in [0, N), ``mask`` bool [B, C], all
    contiguous on one card. Raises ``ValueError`` on arguments outside the
    kernel's contract and ``RuntimeError`` on a failed launch."""
    if metric not in METRICS:
        raise ValueError(f"unknown metric {metric!r}")
    if queries.dim() != 2 or corpus.dim() != 2 or cand.dim() != 2:
        raise ValueError("queries [B, D], corpus [N, D] and cand [B, C] "
                         "expected")
    dev = queries.device
    b, d = queries.shape
    n = corpus.shape[0]
    c = cand.shape[1]
    at = queries.get_device()
    for name, x, dtype, shape in (
            ("queries", queries, torch.float32, (b, d)),
            ("corpus", corpus, torch.float32, (n, d)),
            ("valid", valid, torch.bool, (n,)),
            ("cand", cand, torch.int32, (b, c)),
            ("mask", mask, torch.bool, (b, c))):
        if bad_operand(x, dtype, shape, at):
            raise ValueError(f"{name} must be contiguous {dtype} "
                             f"{tuple(shape)} on {dev}, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
    if b < 1 or c < 1 or n < 1 or k < 1:
        raise ValueError(f"empty operands: b {b}, c {c}, n {n}, k {k}")
    kk = min(k, c)
    lib = _library()
    keys_smem, sel_smem, smem = posting_plan(c, d, kk, _smem_max(dev.index))
    out = torch.empty((2, b, kk), dtype=torch.int32, device=dev)
    keys_g = (None if keys_smem else
              torch.empty((b, c), dtype=torch.int64, device=dev))
    sel_g = (None if sel_smem else
             torch.empty((b, kk), dtype=torch.int64, device=dev))
    ptr = out.data_ptr()
    with launch_on(dev):
        err = lib.hfresh_posting_topk(_CALL.pack(
            queries.data_ptr(), corpus.data_ptr(), valid.data_ptr(),
            cand.data_ptr(), mask.data_ptr(),
            0 if keys_g is None else keys_g.data_ptr(),
            0 if sel_g is None else sel_g.data_ptr(),
            ptr, ptr + 4 * b * kk, raw_stream(dev.index),
            b, c, n, d, kk, METRICS.index(metric), int(keys_smem),
            int(sel_smem), smem))
    if err < 0:
        raise ValueError(f"hfresh_posting_topk refused its arguments: "
                         f"{lib.hfresh_error_string(err).decode()} "
                         f"(code {err})")
    if err > 0:
        raise RuntimeError(f"hfresh_posting_topk launch failed: "
                           f"{lib.hfresh_error_string(err).decode()} "
                           f"(code {err})")
    posting_topk_cuda.launches += 1
    return out[0].view(torch.float32), out[1]


posting_topk_cuda.launches = 0


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declares the C signatures of the built library (pointers as
    c_void_p: undeclared, ctypes would pass 32-bit ints)."""
    lib.hfresh_posting_topk.argtypes = [ctypes.c_char_p]
    lib.hfresh_posting_topk.restype = ctypes.c_int
    lib.hfresh_device_info.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.hfresh_device_info.restype = ctypes.c_int
    lib.hfresh_error_string.argtypes = [ctypes.c_int]
    lib.hfresh_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The kernel's library, built on first use, with its C signatures
    declared."""
    from weaviate_tpu_torch import _build

    return declare(_build.load(KERNEL))


def posting_topk(queries, corpus, valid, cand, mask, k: int, metric: str):
    """The posting top-k: CUDA tensors go to the kernel, CPU tensors to the
    plain version (the same contract as ``posting_topk_plain``)."""
    dev = queries.device
    if dev.type == "cuda":
        return posting_topk_cuda(
            queries.float().contiguous(), corpus.float().contiguous(),
            valid.contiguous(), cand.to(torch.int32).contiguous(),
            mask.contiguous(), k, metric)
    if dev.type == "cpu":
        return posting_topk_plain(queries, corpus, valid, cand, mask, k,
                                  metric)
    raise ValueError(f"no posting top-k for device {dev}")
