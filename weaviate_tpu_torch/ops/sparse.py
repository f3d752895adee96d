"""Segmented sparse (BM25F) scoring on the device (port of
``weaviate_tpu/ops/sparse.py``).

The filtered keyword leg of a hybrid search, and ``bm25_search`` with
``device_scoring``, flatten the query terms' postings into one entry list
(doc row, tf, doc length, weight = boost * idf, the property's avgdl),
score every entry, sum the entries into the doc space, mask the sums by
the touched docs, the filter's allow mask and, for a minimum-match query,
the number of distinct query tokens a doc matched, and take a descending
top-k: equal scores put the lower doc id first, and slots no eligible doc
fills come back id -1 with score 0.

The formula is ``inverted/index.py``'s dense path term for term:

    denom = tf + k1 * (1 - b + b * dl / avgdl)
    score += w * tf * (k1 + 1) / max(denom, 1e-9)

Kernel B6a (``csrc/hybrid.cu sparse_topk_kernel``) does it all in one
launch on the card. Its operands are rows, tf and dl an entry and, for
each (property, term) segment of the entry list, its boundary (``seg``
[G + 1]; a segment's rows ascend and are unique: a posting list is
doc-sorted), weight, avgdl and min-match group. A CTA owns a range of
doc ids and, segment after segment, adds the range's entries of each
segment in shared memory: every doc's sum is taken in entry order, as
the plain version's CPU scatter takes it, with no float atomics. The
plain versions (``entry_scores``, ``scatter_doc_scores``,
``masked_score_topk``) are the JAX program step for step, on the
segments' planes spread over their entries (``per_entry``);
``sparse_score_topk`` and ``sparse_score_topk_min_match`` take them for
CPU tensors only, and on a CUDA tensor launch B6a or raise.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from pathlib import Path

import numpy as np
import torch

from weaviate_tpu_torch.ops.launch import launch_on, source_ints

KERNEL = "hybrid"

# Test/ops hook (mirrors ops.device_beam.dispatch_count): segmented
# sparse-scoring programs dispatched by this process.
_dispatch_count = 0


def dispatch_count() -> int:
    return _dispatch_count


def count_dispatch() -> None:
    """``InvertedIndex.bm25_device_search`` records each dispatch here."""
    global _dispatch_count
    _dispatch_count += 1


# ---------------------------------------------------------------------------
# the plain versions
# ---------------------------------------------------------------------------


def entry_scores(tf, dl, w, avgdl, k1: float, b: float):
    """Per-posting-entry BM25 contribution, float32, each operation
    rounded on its own as JAX rounds it."""
    denom = tf + k1 * ((1.0 - b) + b * dl / torch.clamp(avgdl, min=1e-9))
    return w * tf * (k1 + 1.0) / torch.clamp(denom, min=1e-9)


def scatter_doc_scores(rows, contrib, ok, space: int):
    """Sum the entries' contributions into the doc space, in entry order
    (rows past ``space`` are dropped). Returns (scores [space] float32,
    touched [space] bool)."""
    sel = ok & (rows < space)
    r = rows[sel].long()
    scores = torch.zeros(space, dtype=torch.float32, device=rows.device)
    scores.index_add_(0, r, contrib[sel])
    touched = torch.zeros(space, dtype=torch.bool, device=rows.device)
    touched[r] = True
    return scores, touched


def masked_score_topk(scores, keep, k: int):
    """Descending top-k over the eligible docs, lower doc id first on equal
    scores; ineligible slots come back score 0 and id -1."""
    ranked = torch.where(keep, scores,
                         torch.full_like(scores, float("-inf")))
    order = torch.sort(ranked, descending=True, stable=True).indices[:k]
    vals = ranked[order]
    live = torch.isfinite(vals)
    return (torch.where(live, vals, torch.zeros_like(vals)),
            torch.where(live, order.to(torch.int32),
                        torch.full_like(order, -1, dtype=torch.int32)))


def matched_groups(rows, grp, ok, space: int, n_groups: int):
    """Distinct query-token groups each doc matched [space] (entries whose
    group lies outside [0, n_groups) count for none)."""
    valid = ok & (rows < space) & (grp >= 0) & (grp < n_groups)
    flat = grp[valid].long() * space + rows[valid].long()
    pres = torch.zeros(n_groups * space, dtype=torch.bool,
                       device=rows.device)
    pres[flat] = True
    return pres.view(n_groups, space).sum(0)


def per_entry(p: int, seg, *planes):
    """Each per-segment plane ([G], with the value its pad takes) spread
    over the entries it covers ([p]; entries past ``seg[-1]`` get the
    pad): the JAX package's per-entry layout."""
    lens = torch.diff(seg.long())
    n = int(seg[-1]) if seg.numel() else 0
    out = []
    for plane, pad in planes:
        full = torch.full((p,), pad, dtype=plane.dtype, device=plane.device)
        full[:n] = torch.repeat_interleave(plane, lens)
        out.append(full)
    return out


def sparse_topk_plain(rows, tf, dl, seg, seg_w, seg_avgdl, allow, k: int,
                      k1: float, b: float, seg_grp=None, n_groups: int = 0,
                      min_match: int = 0):
    """The plain version of B6a: ``sparse_score_topk`` (``seg_grp`` None)
    or ``sparse_score_topk_min_match``, the segments' weight, avgdl and
    group spread over their entries (pads: weight 0, avgdl 1, group 0)."""
    w, avgdl = per_entry(rows.numel(), seg, (seg_w, 0.0), (seg_avgdl, 1.0))
    ok = rows >= 0
    space = allow.shape[0]
    contrib = entry_scores(tf, dl, w, avgdl, k1, b)
    scores, touched = scatter_doc_scores(rows, contrib, ok, space)
    keep = touched & allow
    if seg_grp is not None:
        (grp,) = per_entry(rows.numel(), seg, (seg_grp, 0))
        keep &= matched_groups(rows, grp, ok, space, n_groups) >= min_match
    return masked_score_topk(scores, keep, k)


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------


def sparse_score_topk(rows, tf, dl, seg, seg_w, seg_avgdl, allow, k: int,
                      k1: float, b: float):
    """Filtered BM25F top-k in one launch.

    rows [P] int32 doc ids (-1 = pad); tf/dl [P] float32; ``seg`` [G + 1]
    int32, the entry list's (property, term) segment boundaries (a
    segment's rows ascend, unique); seg_w (boost x idf) and seg_avgdl
    [G] float32, each segment's; allow [S] bool (the filter AND the live
    mask over the padded doc space). Returns (scores [k] float32
    descending, ids [k] int32, -1 where no doc is eligible)."""
    if rows.device.type == "cpu":
        return sparse_topk_plain(rows, tf, dl, seg, seg_w, seg_avgdl, allow,
                                 k, k1, b)
    return sparse_topk_cuda(rows, tf, dl, seg, seg_w, seg_avgdl, allow, k,
                            k1, b)


def sparse_score_topk_min_match(rows, tf, dl, seg, seg_w, seg_avgdl, seg_grp,
                                allow, k: int, k1: float, b: float,
                                n_groups: int, min_match: int):
    """``sparse_score_topk`` with the reference's SearchOperatorOptions: a
    doc is eligible only when it matches at least ``min_match`` distinct
    query-token groups (``seg_grp`` [G] int32, each segment's group: a
    token that fans out across properties counts once); ``n_groups`` is
    the padded group count."""
    if rows.device.type == "cpu":
        return sparse_topk_plain(rows, tf, dl, seg, seg_w, seg_avgdl, allow,
                                 k, k1, b, seg_grp, n_groups, min_match)
    return sparse_topk_cuda(rows, tf, dl, seg, seg_w, seg_avgdl, allow, k,
                            k1, b, seg_grp, n_groups, min_match)


def page_to_host(vals, ids):
    """A page (scores, ids) as numpy: one copy where the wrapper left the
    two side by side in one buffer (``vals`` then ``ids``), else two."""
    k = ids.numel()
    if vals.is_contiguous() and ids.is_contiguous() and \
            ids.dtype == torch.int32 and \
            vals.data_ptr() + 4 * k == ids.data_ptr() and \
            vals.untyped_storage().data_ptr() == \
            ids.untyped_storage().data_ptr():
        host = ids.as_strided((2 * k,), (1,),
                              ids.storage_offset() - k).cpu().numpy()
        return host[:k].view(np.float32), host[k:]
    return vals.cpu().numpy(), ids.cpu().numpy()


CONST = source_ints(Path(__file__).resolve().parent.parent / "csrc"
                     / f"{KERNEL}.cu")


def sparse_range(space: int) -> int:
    """Doc ids a CTA of B6a owns over ``space`` docs: the smallest power of
    two in [kSparseMinRange, kSparseMaxRange] that gives at most
    kSparseCtas CTAs (the C entry's ``range_for``)."""
    r, top, ctas = (CONST["kSparseMinRange"], CONST["kSparseMaxRange"],
                    CONST["kSparseCtas"])
    while r < top and -(-space // r) > ctas:
        r *= 2
    return r


def sparse_ctas(space: int) -> int:
    """CTAs (doc ranges, and so partial lists) of one B6a launch."""
    return -(-space // sparse_range(space))


# each (device, stream)'s ticket counter: zero when made, and every launch
# of B6a leaves it zero (its last CTA takes the ticket that wraps it)
_tickets: dict = {}
_tickets_lock = threading.Lock()


def _ticket(dev: torch.device, stream: int) -> torch.Tensor:
    key = (dev.index, stream)
    t = _tickets.get(key)
    if t is None:
        with _tickets_lock:
            t = _tickets.get(key)
            if t is None:
                t = _tickets[key] = torch.zeros(1, dtype=torch.int32,
                                                device=dev)
    return t


_F32, _I32 = torch.float32, torch.int32


def _check(name, t, dtype, n, dev):
    if t.dtype != dtype or t.dim() != 1 or (n is not None and t.numel() != n) \
            or not t.is_contiguous() or t.device != dev:
        raise ValueError(f"{name} must be contiguous {dtype} [{n}] on {dev}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def sparse_topk_cuda(rows, tf, dl, seg, seg_w, seg_avgdl, allow, k: int,
                     k1: float, b: float, seg_grp=None, n_groups: int = 0,
                     min_match: int = 0):
    """B6a on the card: one launch of ``sparse_topk_kernel``, counted in
    ``launches``, into one allocation (the page, then the partial lists and
    the survivors). Raises on arguments the kernel does not take, or when
    the launch fails."""
    dev = rows.device
    p, g, space = rows.numel(), seg_w.numel(), allow.numel()
    _check("rows", rows, _I32, None, dev)
    _check("tf", tf, _F32, p, dev)
    _check("dl", dl, _F32, p, dev)
    _check("seg", seg, _I32, g + 1, dev)
    _check("seg_w", seg_w, _F32, g, dev)
    _check("seg_avgdl", seg_avgdl, _F32, g, dev)
    _check("allow", allow, torch.bool, None, dev)
    if seg_grp is not None:
        _check("seg_grp", seg_grp, _I32, g, dev)
        if n_groups < 1:
            raise ValueError(f"n_groups={n_groups} must be >= 1")
    if k < 1 or space < 1:
        raise ValueError(f"k={k} and the doc space {space} must be >= 1")
    if space >= 2 ** 31 or p >= 2 ** 31:
        raise ValueError("the doc space and the entries must fit int32")
    lib = _library()
    keys = (sparse_ctas(space) + 1) * k
    page = -(-k // 2) * 2  # keeps the keys 16-byte aligned
    buf = torch.empty(2 * page + 2 * keys, dtype=_I32, device=dev)
    ptr = buf.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with launch_on(dev):
        err = lib.sparse_topk(
            rows.data_ptr(), tf.data_ptr(), dl.data_ptr(), seg.data_ptr(),
            seg_w.data_ptr(), seg_avgdl.data_ptr(),
            None if seg_grp is None else seg_grp.data_ptr(), g,
            allow.data_ptr(), space, k1, 1.0 - b, b, k1 + 1.0, n_groups,
            min_match, k, ptr + 8 * page, keys,
            _ticket(dev, stream).data_ptr(), ptr, ptr + 4 * k, stream)
    raise_on(lib, err, "sparse_topk")
    sparse_topk_cuda.launches += 1
    return buf[:k].view(_F32), buf[k:2 * k]


sparse_topk_cuda.launches = 0


def raise_on(lib, err: int, what: str):
    if err < 0:
        raise ValueError(f"{what} refused its arguments: "
                         f"{lib.hybrid_error_string(err).decode()} "
                         f"(code {err})")
    if err > 0:
        raise RuntimeError(f"{what} launch failed: "
                           f"{lib.hybrid_error_string(err).decode()} "
                           f"(code {err})")


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declares the C signatures of the built library (pointers and the
    stream as c_void_p: undeclared, ctypes would pass 32-bit ints)."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.sparse_topk.argtypes = ([p] * 7 + [i, p, i] + [f] * 4 + [i] * 3
                                + [p, ctypes.c_longlong] + [p] * 4)
    lib.fusion_topk.argtypes = [p] * 3 + [i] * 5 + [p] * 4
    lib.sparse_range.argtypes = [i]
    for fn in (lib.sparse_topk, lib.fusion_topk, lib.sparse_range):
        fn.restype = i
    lib.hybrid_error_string.argtypes = [i]
    lib.hybrid_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The kernels' library, built on first use, with its C signatures
    declared."""
    from weaviate_tpu_torch import _build

    return declare(_build.load(KERNEL))
