"""The HFresh posting top-k (B9a; port of the device part of
``HFreshIndex.search``, ``weaviate_tpu/index/hfresh.py:319-340``).

For each query row: the distance to each of its candidate columns (corpus
rows named by ``cand``), ``MASK_DISTANCE`` where ``mask`` or the store's
``valid`` bit is off, and the ``kk = min(k, C)`` smallest ascending, equal
distances lower column first (``lax.top_k``'s order on the negated
distances). A query's candidates are the sorted union of the postings
it probes, each row once, padded with ids not below the last
(``HFreshIndex.search`` pads with n - 1) so that each row is sorted. The
posting snapshot stays on the kernel's device as a CSR
(``posting_table``, rebuilt only when the postings change) and a batch
adds only its probes, uploaded with its queries, candidates and mask in
one copy (``posting_operands``); the kernels group the probes by posting
themselves, so a probed posting is read once a tile of the queries that
probe it.
``posting_topk_plain`` is the plain PyTorch version (it checks the
posting operands' shapes and ids and reads nothing else of them);
``posting_topk_cuda`` launches the hand-written kernels of
``csrc/hfresh.cu`` (a call is three launches on the current stream, the
inverse, the scoring pass and the select pass, the last two as
programmatic dependents of the one before, counted once a call in
``launches``); ``posting_topk`` takes the plain version for CPU tensors
and the kernels for CUDA tensors, with no fallback between them.
"""

from __future__ import annotations

import ctypes
import functools
import struct
from typing import NamedTuple

import numpy as np
import torch

from weaviate_tpu_torch.ops.distance import MASK_DISTANCE, METRICS, gather_distance
from weaviate_tpu_torch.ops.launch import bad_operand, launch_on, raw_stream
from weaviate_tpu_torch.ops.topk import smallest_k

KERNEL = "hfresh"
# one call's arguments as the C entry point reads them (a PostingCall):
# 14 addresses (the stream last), 12 ints
_CALL = struct.Struct("<14Q12i")
_BINS, _MISC = 256, 16
# queries and rows a tile of the scoring pass (kTileQueries and kTileRows
# of the source: 8 warps of kWarpRows 4)
TILE_QUERIES, TILE_ROWS = 8, 32


class PostingTable(NamedTuple):
    """A posting snapshot as B9a reads it: ``rows`` every posting's row
    ids, posting after posting, clipped to [0, n); ``off`` [P + 1] where
    each posting starts (both int32, views of one tensor); ``max_len`` the
    longest posting's length."""

    rows: torch.Tensor
    off: torch.Tensor
    max_len: int


class Postings(NamedTuple):
    """A batch's posting operands: ``probe`` [B, nprobe] int32, the
    postings each query probes (ids into ``table``), and the snapshot's
    ``PostingTable``."""

    probe: torch.Tensor
    table: PostingTable


def posting_table(postings, n: int, device=None) -> PostingTable:
    """The ``PostingTable`` of ``postings`` (a list of row-id arrays) for a
    store of ``n`` rows: one int32 buffer filled on the host, on
    ``device`` where given (one copy from pinned memory, not waited for,
    on a CUDA device)."""
    p = len(postings)
    sizes = np.fromiter(map(len, postings), np.int64, p)
    pinned = device is not None and torch.device(device).type == "cuda"
    buf = torch.empty(p + 1 + int(sizes.sum()), dtype=torch.int32,
                      pin_memory=pinned)
    host = buf.numpy()
    off, rows = host[:p + 1], host[p + 1:]
    off[0] = 0
    np.cumsum(sizes, out=off[1:])
    if p:
        np.concatenate(postings, out=rows, casting="unsafe")
    np.clip(rows, 0, max(n - 1, 0), out=rows)
    if device is not None:
        buf = buf.to(device, non_blocking=pinned)
    return PostingTable(buf[p + 1:], buf[:p + 1],
                        int(sizes.max()) if p else 0)


def posting_operands(queries, cand, mask, probe, table: PostingTable,
                     n: int, device=None) -> tuple:
    """B9a's operands of a batch beside ``table``, in one host buffer with
    one copy to ``device`` where given (pinned and not waited for on a
    CUDA device): ``queries`` [B, D] as float32; ``cand`` [B, C], each
    query's candidates (the sorted union of its probed postings, each row
    once, padded with ids not below the last, as ``HFreshIndex.search``
    builds them), clipped to [0, n) as int32; ``mask`` [B, C] bool;
    ``probe`` [B, nprobe] (posting ids into ``table``) as int32. ->
    (queries, cand, mask, ``Postings``), views of the one tensor. Raises
    ``ValueError`` on a posting id outside the table."""
    probe, cand = np.asarray(probe), np.asarray(cand)
    if probe.size and (probe.min() < 0
                       or probe.max() >= table.off.shape[0] - 1):
        raise ValueError("a probe names no posting of the table")
    b, d = queries.shape
    c = cand.shape[1]
    ends = np.cumsum([4 * b * d, 4 * b * c, 4 * probe.size, b * c])
    pinned = device is not None and torch.device(device).type == "cuda"
    buf = torch.empty(int(ends[-1]), dtype=torch.uint8, pin_memory=pinned)
    host = buf.numpy()
    host[:ends[0]].view(np.float32).reshape(b, d)[...] = queries
    np.clip(cand, 0, n - 1, out=host[ends[0]:ends[1]].view(
        np.int32).reshape(b, c), casting="unsafe")
    host[ends[1]:ends[2]].view(np.int32)[...] = probe.reshape(-1)
    host[ends[2]:].view(np.bool_).reshape(b, c)[...] = mask
    if device is not None:
        buf = buf.to(device, non_blocking=pinned)
    return (buf[:ends[0]].view(torch.float32).view(b, d),
            buf[ends[0]:ends[1]].view(torch.int32).view(b, c),
            buf[ends[2]:].view(torch.bool).view(b, c),
            Postings(buf[ends[1]:ends[2]].view(torch.int32).view(
                probe.shape), table))


def check_postings(posts: Postings, b: int) -> None:
    """Raises ``ValueError`` where ``posts`` cannot be a batch of ``b``
    query rows as B9a's kernels read it: shapes and dtypes, offsets that
    do not span the table, posting ids outside the table. Vectorised; it
    does not check that the candidates are the probed postings' union
    (the tests do)."""
    probe, (rows, off, max_len) = posts
    if (any(x.dtype != torch.int32 for x in (probe, rows, off))
            or probe.dim() != 2 or probe.shape[0] != b or off.dim() != 1
            or off.numel() < 1):
        raise ValueError("B9a's posting operands have the wrong shapes or "
                         "dtypes")
    sizes = off.diff()
    top = int(sizes.max()) if sizes.numel() else 0
    if (int(off[0]) != 0 or int(off[-1]) != rows.numel()
            or bool((sizes < 0).any()) or top != max_len):
        raise ValueError("B9a's posting table does not span its rows")
    if bool(((probe < 0) | (probe >= off.numel() - 1)).any()):
        raise ValueError("B9a's posting operands hold ids out of range")


def posting_topk_plain(queries, corpus, valid, cand, mask, k: int,
                       metric: str, posts: Postings = None):
    """B9a in torch ops: -> (distances [B, kk] float32, columns [B, kk]
    int32). ``queries`` [B, D] float32, ``corpus`` [N, D] float32, ``valid``
    [N] bool, ``cand`` [B, C] int (in [0, N)), ``mask`` [B, C] bool.
    ``posts``, where given, is checked (``check_postings``) and not
    otherwise read."""
    if posts is not None:
        check_postings(posts, cand.shape[0])
    d = gather_distance(queries, corpus, cand, metric, precision="fp32")
    live = valid[cand.long()]
    d = torch.where(mask & live, d, MASK_DISTANCE)
    v, pos = smallest_k(d, min(k, cand.shape[1]))
    return v, pos.to(torch.int32)


def head_bytes() -> int:
    """Shared memory of a select CTA before its keys (``head_bytes`` of
    the source): the histogram and the scalars."""
    return 4 * _BINS + 4 * _MISC


def score_bytes(d: int) -> int:
    """Shared memory of a scoring CTA (``score_bytes`` of the source): the
    tile's queries, each rounded to 16 bytes."""
    return 4 * TILE_QUERIES * ((d + 3) & ~3)


def posting_plan(c: int, d: int, kk: int, smem_max: int) -> tuple:
    """(keys in shared memory, kept keys in shared memory, bytes a select
    CTA): the keys of a row's C columns stay in shared memory where they
    fit, then the kk kept keys where they fit too; the rest stay in the
    global scratch. Raises where a scoring CTA's queries at ``d`` do not
    fit."""
    if score_bytes(d) > smem_max:
        raise ValueError(f"B9a needs {score_bytes(d)} bytes of shared "
                         f"memory for d {d}, the card has {smem_max}")
    smem = head_bytes()
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


def invert_ints(postings: int, probes: int, max_len: int) -> int:
    """Ints of the inverse's scratch (``invert_ints`` of the source): a
    count, a query start and a tile start a posting, two ends, a place
    and a query a probe, and a posting a tile for as many tiles as the
    probes can have (each at most its posting's row tiles)."""
    return (3 * postings + 2 + 2 * probes
            + probes * -(-max_len // TILE_ROWS))


def posting_topk_cuda(queries, corpus, valid, cand, mask, k: int,
                      metric: str, posts: Postings):
    """B9a on the card: the inverse, the scoring and the select kernel on
    the current stream (one call, counted once in ``launches``), its
    outputs one allocation and its scratch another. ``queries`` float32
    [B, D], ``corpus`` float32 [N, D], ``valid`` bool [N], ``cand`` int32
    [B, C] in [0, N), each row sorted and holding an id once but in its
    padding, ``mask`` bool [B, C], ``posts`` the
    batch's ``Postings`` (int32), all contiguous on one card (the kernels
    trust that every column with its mask on is a row of a posting its
    query probes). Raises ``ValueError`` on arguments outside the kernel's
    contract and ``RuntimeError`` on a failed launch."""
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
    probe, (rows, off, max_len) = posts
    p = off.shape[0] - 1
    nprobe = probe.shape[1] if probe.dim() == 2 else -1
    for name, x, dtype, shape in (
            ("queries", queries, torch.float32, (b, d)),
            ("corpus", corpus, torch.float32, (n, d)),
            ("valid", valid, torch.bool, (n,)),
            ("cand", cand, torch.int32, (b, c)),
            ("mask", mask, torch.bool, (b, c)),
            ("posts.probe", probe, torch.int32, (b, nprobe)),
            ("posts.table.rows", rows, torch.int32, rows.shape[:1]),
            ("posts.table.off", off, torch.int32, (p + 1,))):
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
    # the keys [b, c], the kept keys [b, kk] where they do not fit in
    # shared memory, the inverse's ints
    sel = 0 if sel_smem else b * kk
    scratch = torch.empty(
        b * c + sel + (invert_ints(p, b * nprobe, max_len) + 1) // 2,
        dtype=torch.int64, device=dev)
    keys = scratch.data_ptr()
    ptr = out.data_ptr()
    with launch_on(dev):
        err = lib.hfresh_posting_topk(_CALL.pack(
            queries.data_ptr(), corpus.data_ptr(), valid.data_ptr(),
            cand.data_ptr(), mask.data_ptr(), probe.data_ptr(),
            rows.data_ptr(), off.data_ptr(),
            keys + 8 * (b * c + sel), keys, keys + 8 * b * c if sel else 0,
            ptr, ptr + 4 * b * kk, raw_stream(dev.index),
            b, c, n, d, kk, METRICS.index(metric), p, nprobe, max_len,
            int(keys_smem), int(sel_smem), smem))
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


def posting_topk(queries, corpus, valid, cand, mask, k: int, metric: str,
                 posts: Postings):
    """The posting top-k: CUDA tensors go to the kernels, CPU tensors to
    the plain version (the same contract as ``posting_topk_plain``)."""
    dev = queries.device
    if dev.type == "cuda":
        return posting_topk_cuda(
            queries.float().contiguous(), corpus.float().contiguous(),
            valid.contiguous(), cand.to(torch.int32).contiguous(),
            mask.contiguous(), k, metric, posts)
    if dev.type == "cpu":
        return posting_topk_plain(queries, corpus, valid, cand, mask, k,
                                  metric, posts)
    raise ValueError(f"no posting top-k for device {dev}")
