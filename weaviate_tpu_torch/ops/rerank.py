"""The rerank stage of a search batch (B7a; port of ``_rerank_stage`` and
``_rerank_module_scores`` of ``weaviate_tpu/ops/device_beam.py``).

For each query: gather its candidates' token planes, score them with a
device rerank module (``modules/device/``), keep the ``out_k`` best by
score. The result is (ids, -score): lower is better, so the host plumbing
treats it like distances. ``rerank_topk_plain`` is the plain PyTorch
version; ``rerank_topk_cuda`` launches the hand-written kernel
``csrc/rerank.cu`` (one launch a batch, counted in ``launches``);
``rerank_topk`` takes the plain version for CPU tensors and the kernel for
CUDA tensors, with no fallback between them.
"""

from __future__ import annotations

import ctypes
import functools
import struct
import threading
from pathlib import Path
from typing import NamedTuple

import torch

from weaviate_tpu_torch.ops.distance import MASK_DISTANCE
from weaviate_tpu_torch.ops.launch import (
    bad_operand,
    launch_on,
    raw_stream,
    source_ints,
)

KERNEL = "rerank"
# the kernel's limit on candidates a query (their groups are grid.y)
MAX_CANDIDATES = 65535


def _module_scores(module, cand, tokens, tmask, q_tokens, q_mask):
    """-> (valid [B, C], scores [B, C]): the candidates' token planes
    gathered and scored by ``module``'s plain version; invalid slots carry
    garbage the caller masks."""
    n = tokens.shape[0]
    cand = cand.long()
    valid = (cand >= 0) & (cand < n)
    safe = torch.where(valid, cand, 0)
    toks = tokens[safe]                               # [B, C, T, D]
    tm = tmask[safe] & valid[:, :, None]
    return valid, module.score(q_tokens, q_mask, toks, tm)


def rerank_topk_plain(cand, tokens, tmask, q_tokens, q_mask, module,
                      out_k: int):
    """B7a in torch ops: -> (ids [B, out_k] int32, neg_scores [B, out_k]
    float32), descending by score, equal scores in candidate order (the
    stable sort's, as ``lax.top_k``); slots whose score is not finite are
    (-1, MASK_DISTANCE)."""
    valid, scores = _module_scores(module, cand, tokens, tmask, q_tokens,
                                   q_mask)
    scores = torch.where(valid, scores, -torch.inf)
    order = torch.sort(scores, dim=1, descending=True, stable=True)
    s = order.values[:, :out_k]
    ids = torch.gather(cand.long(), 1, order.indices[:, :out_k])
    ok = torch.isfinite(s)
    return (torch.where(ok, ids, -1).to(torch.int32),
            torch.where(ok, -s, MASK_DISTANCE).to(torch.float32))


CONST = source_ints(Path(__file__).resolve().parent.parent / "csrc"
                     / f"{KERNEL}.cu")
_THREADS, _COLS, _DK = CONST["kThreads"], CONST["kCols"], CONST["kDK"]
_WARPS, _WINDOW = _THREADS // 32, _THREADS
_MAX_CLUSTER = CONST["kMaxCluster"]
# one launch's arguments as the C entry point reads them (a RerankCall):
# 10 addresses (the stream last), 12 ints, 3 floats
_CALL = struct.Struct("<10Q12i3f")


class RerankPlan(NamedTuple):
    """One B7a launch: ``rg`` groups of 4 query-token rows a tile (the
    kernel instance), ``cpb`` candidates a CTA, ``nblk`` CTAs a candidate
    (one thread block cluster, each a block of its kept tokens), the grid
    (queries x nblk, candidate groups) and the dynamic shared memory a CTA
    (bytes: the layout, or the c scores the last CTA stages where they
    are more and fit)."""

    rg: int
    cpb: int
    nblk: int
    grid: tuple
    smem: int


def _r4(x: int) -> int:
    return (x + 3) & ~3


def rerank_smem_words(rg: int, cpb: int, tq: int, d: int,
                      linear: bool) -> int:
    """4-byte words of a CTA's shared memory (``layout`` of the source):
    the staged chunks (one where D fits a chunk, else two), the warps'
    partial sums, the window's list (positions and candidates), the live
    query tokens, the maxima, the mean row, per-candidate sums, counts
    and ids, the scan's totals and the mean token."""
    stages = 2 if d > _DK else 1
    return (stages * (4 * rg + _COLS) * (_DK + 4) + 4 * _WARPS * _COLS
            + 2 * _WINDOW
            + _r4(tq) + _r4(cpb * tq) + _COLS + 3 * _r4(cpb) + 2 * _WARPS
            + (_r4(d) if linear else 0))


@functools.lru_cache(maxsize=4096)
def rerank_plan(b: int, c: int, t: int, tq: int, d: int, linear: bool,
                sms: int, smem_max: int) -> RerankPlan:
    """The launch of B7a for these shapes on a card of ``sms`` SMs and
    ``smem_max`` bytes of dynamic shared memory a block: the fewest row
    groups that hold the query's tokens (and the mean row); several
    candidates a CTA where a candidate's tokens fill less than a tile,
    as long as the batch still gives two CTAs an SM; where the batch gives
    fewer, each candidate's kept tokens split over up to 8 CTAs (at least
    16 token slots each). Raises ``ValueError`` where a CTA's shared
    memory passes the card's."""
    rows = tq + int(linear)
    rg = next(r for r in (1, 2, 4, 8) if 4 * r >= rows or r == 8)
    want = 2 * sms
    cpb = 1 if t >= _COLS else max(1, min(_COLS // t, (b * c) // want))
    nblk = 1
    if cpb == 1 and b * c < want:
        nblk = max(1, min(_MAX_CLUSTER, -(-want // (b * c)), t // 16))
    groups = -(-c // cpb)
    smem = 4 * rerank_smem_words(rg, cpb, tq, d, linear)
    if smem > smem_max:
        raise ValueError(f"B7a needs {smem} bytes of shared memory a block "
                         f"(tq {tq}, d {d}), the card has {smem_max}")
    if 4 * c <= smem_max:  # the last CTA stages the scores
        smem = max(smem, 4 * c)
    return RerankPlan(rg, cpb, nblk, (b * nblk, groups), smem)


# each (device, stream)'s scratch: (the tensor, its tickets) -- first the
# tickets, one a query, zero when made and left zero by every launch (a
# query's last CTA wraps its ticket), then the [b, c] scores
_scratch: dict = {}
_scratch_lock = threading.Lock()


def _scratch_for(dev: torch.device, stream: int, b: int, c: int) -> tuple:
    """(the tickets' address, the scores' address) of a scratch that holds
    at least ``b`` tickets and ``b * c`` scores for ``stream``."""
    key = (dev.index, stream)
    got = _scratch.get(key)
    if got is None or got[1] < b or got[0].numel() < got[1] + b * c:
        with _scratch_lock:
            got = _scratch.get(key)
            if got is None or got[1] < b or got[0].numel() < got[1] + b * c:
                old_t, old_s = (0, 0) if got is None else (
                    got[1], got[0].numel() - got[1])
                tickets = _r4(max(b, old_t, 256))
                got = _scratch[key] = (torch.zeros(
                    tickets + max(b * c, old_s, 65536), dtype=torch.int32,
                    device=dev), tickets)
    base = got[0].data_ptr()
    return base, base + 4 * got[1]


_device_info: dict = {}


def _card(index: int) -> tuple:
    """(SMs, dynamic shared memory a block) of device ``index``, read once
    from the library."""
    info = _device_info.get(index)
    if info is None:
        sms, smem = ctypes.c_int(), ctypes.c_int()
        lib = _library()
        err = lib.rerank_device_info(index, ctypes.byref(sms),
                                     ctypes.byref(smem))
        if err:
            raise RuntimeError(f"rerank_device_info failed: "
                               f"{lib.rerank_error_string(err).decode()}")
        info = _device_info[index] = (sms.value, smem.value)
    return info


def rerank_topk_cuda(cand, tokens, tmask, q_tokens, q_mask, module,
                     out_k: int):
    """B7a on the card: one launch of ``rerank_kernel`` on the current
    stream (the plan of ``rerank_plan``), counted in ``launches``, its
    outputs one allocation. ``cand`` int32 [B, C], ``tokens`` float32 [N,
    T, D], ``tmask`` bool [N, T], ``q_tokens`` float32 [B, Tq, D],
    ``q_mask`` bool [B, Tq], all contiguous on one card. Raises
    ``ValueError`` on arguments outside the kernel's contract and
    ``RuntimeError`` on a failed launch."""
    dev = cand.device
    if cand.dim() != 2 or tokens.dim() != 3 or q_tokens.dim() != 3:
        raise ValueError("cand [B, C], tokens [N, T, D] and q_tokens "
                         "[B, Tq, D] expected")
    b, c = cand.shape
    n, t, d = tokens.shape
    tq = q_tokens.shape[1]
    at = cand.get_device()
    for name, x, dtype, shape in (
            ("cand", cand, torch.int32, (b, c)),
            ("tokens", tokens, torch.float32, (n, t, d)),
            ("tmask", tmask, torch.bool, (n, t)),
            ("q_tokens", q_tokens, torch.float32, (b, tq, d)),
            ("q_mask", q_mask, torch.bool, (b, tq))):
        if bad_operand(x, dtype, shape, at):
            raise ValueError(f"{name} must be contiguous {dtype} "
                             f"{tuple(shape)} on {dev}, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
    if not 1 <= out_k <= c:
        raise ValueError(f"out_k {out_k} outside [1, C={c}]")
    if c > MAX_CANDIDATES:
        raise ValueError(f"{c} candidates a query, the kernel takes "
                         f"{MAX_CANDIDATES}")
    kind, w_max, w_mean, bias = module.kernel_params()
    lib = _library()
    plan = rerank_plan(b, c, t, tq, d, kind == 1, *_card(dev.index))
    out = torch.empty((2, b, out_k), dtype=torch.int32, device=dev)
    ptr = out.data_ptr()
    stream = raw_stream(dev.index)
    tickets, scores = _scratch_for(dev, stream, b, c)
    with launch_on(dev):
        err = lib.rerank_topk(_CALL.pack(
            cand.data_ptr(), tokens.data_ptr(), tmask.data_ptr(),
            q_tokens.data_ptr(), q_mask.data_ptr(), scores, tickets, ptr,
            ptr + 4 * b * out_k, stream, b, c, n, t, d, tq, out_k, kind,
            plan.rg, plan.cpb, plan.nblk, plan.smem, w_max, w_mean, bias))
    if err < 0:
        raise ValueError(f"rerank_topk refused its arguments: "
                         f"{lib.rerank_error_string(err).decode()} "
                         f"(code {err})")
    if err > 0:
        raise RuntimeError(f"rerank_topk launch failed: "
                           f"{lib.rerank_error_string(err).decode()} "
                           f"(code {err})")
    rerank_topk_cuda.launches += 1
    return out[0], out[1].view(torch.float32)


rerank_topk_cuda.launches = 0


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declares the C signatures of the built library (pointers and the
    stream as c_void_p: undeclared, ctypes would pass 32-bit ints)."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.rerank_topk.argtypes = [ctypes.c_char_p]
    lib.rerank_topk.restype = i
    lib.rerank_device_info.argtypes = [i, p, p]
    lib.rerank_device_info.restype = i
    lib.rerank_error_string.argtypes = [i]
    lib.rerank_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The kernel's library, built on first use, with its C signatures
    declared."""
    from weaviate_tpu_torch import _build

    return declare(_build.load(KERNEL))


def rerank_topk(cand, tokens, tmask, q_tokens, q_mask, module, out_k: int):
    """The rerank stage: CUDA tensors go to the kernel, CPU tensors to the
    plain version (the same contract as ``rerank_topk_plain``)."""
    dev = cand.device
    if dev.type == "cuda":
        return rerank_topk_cuda(
            cand.to(torch.int32).contiguous(), tokens.contiguous(),
            tmask.contiguous(), q_tokens.float().contiguous(),
            q_mask.contiguous(), module, out_k)
    if dev.type == "cpu":
        return rerank_topk_plain(cand, tokens, tmask, q_tokens, q_mask,
                                 module, out_k)
    raise ValueError(f"no rerank stage for device {dev}")
