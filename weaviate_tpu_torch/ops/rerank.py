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
import threading

import torch

from weaviate_tpu_torch.ops.distance import MASK_DISTANCE

KERNEL = "rerank"
# the kernel's limit on candidates a query (a warp each, on grid.y)
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


# each (device, stream)'s tickets, one a query: zero when made, and every
# launch leaves them zero (a query's last CTA wraps its ticket)
_tickets: dict = {}
_tickets_lock = threading.Lock()


def _tickets_for(dev: torch.device, stream: int, b: int) -> torch.Tensor:
    key = (dev.index, stream)
    with _tickets_lock:
        t = _tickets.get(key)
        if t is None or t.numel() < b:
            t = _tickets[key] = torch.zeros(max(b, 256), dtype=torch.int32,
                                            device=dev)
    return t


def _check(name, t, dtype, shape, dev):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {dtype} {tuple(shape)}, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, the candidates on {dev}")


def rerank_topk_cuda(cand, tokens, tmask, q_tokens, q_mask, module,
                     out_k: int):
    """B7a on the card: one launch of ``rerank_kernel`` on the current
    stream, counted in ``launches``. ``cand`` int32 [B, C], ``tokens``
    float32 [N, T, D], ``tmask`` bool [N, T], ``q_tokens`` float32 [B, Tq,
    D], ``q_mask`` bool [B, Tq], all contiguous on one card. Raises
    ``ValueError`` on arguments outside the kernel's contract and
    ``RuntimeError`` on a failed launch."""
    dev = cand.device
    if cand.dim() != 2 or tokens.dim() != 3 or q_tokens.dim() != 3:
        raise ValueError("cand [B, C], tokens [N, T, D] and q_tokens "
                         "[B, Tq, D] expected")
    b, c = cand.shape
    n, t, d = tokens.shape
    tq = q_tokens.shape[1]
    _check("cand", cand, torch.int32, (b, c), dev)
    _check("tokens", tokens, torch.float32, (n, t, d), dev)
    _check("tmask", tmask, torch.bool, (n, t), dev)
    _check("q_tokens", q_tokens, torch.float32, (b, tq, d), dev)
    _check("q_mask", q_mask, torch.bool, (b, tq), dev)
    if not 1 <= out_k <= c:
        raise ValueError(f"out_k {out_k} outside [1, C={c}]")
    if c > MAX_CANDIDATES:
        raise ValueError(f"{c} candidates a query, the kernel takes "
                         f"{MAX_CANDIDATES}")
    kind, w_max, w_mean, bias = module.kernel_params()
    lib = _library()
    scores = torch.empty((b, c), dtype=torch.float32, device=dev)
    ids = torch.empty((b, out_k), dtype=torch.int32, device=dev)
    dists = torch.empty((b, out_k), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.rerank_topk(
            cand.data_ptr(), tokens.data_ptr(), tmask.data_ptr(),
            q_tokens.data_ptr(), q_mask.data_ptr(), scores.data_ptr(),
            _tickets_for(dev, stream, b).data_ptr(), ids.data_ptr(),
            dists.data_ptr(), b, c, n, t, d, tq, out_k, kind, w_max, w_mean,
            bias, stream)
    if err < 0:
        raise ValueError(f"rerank_topk refused its arguments: "
                         f"{lib.rerank_error_string(err).decode()} "
                         f"(code {err})")
    if err > 0:
        raise RuntimeError(f"rerank_topk launch failed: "
                           f"{lib.rerank_error_string(err).decode()} "
                           f"(code {err})")
    rerank_topk_cuda.launches += 1
    return ids, dists


rerank_topk_cuda.launches = 0


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declares the C signatures of the built library (pointers and the
    stream as c_void_p: undeclared, ctypes would pass 32-bit ints)."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.rerank_topk.argtypes = [p] * 9 + [i] * 8 + [f] * 3 + [p]
    lib.rerank_topk.restype = i
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
