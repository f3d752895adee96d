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
launch on the card. It needs the boundaries of the entry list's
(property, term) segments, ``seg`` [G + 1]: the rows of a segment ascend
and are unique (a posting list is doc-sorted). A CTA owns a range of doc
ids and, segment after segment, adds the range's entries of each segment
in shared memory: every doc's sum is taken in entry order, as the plain
version's CPU scatter takes it, with no float atomics. The plain versions
(``entry_scores``, ``scatter_doc_scores``, ``masked_score_topk``) are the
JAX program step for step; ``sparse_score_topk`` and
``sparse_score_topk_min_match`` take them for CPU tensors only, and on a
CUDA tensor launch B6a or raise.
"""

from __future__ import annotations

import ctypes
import functools
import re
from pathlib import Path

import torch

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


def sparse_topk_plain(rows, tf, dl, w, avgdl, allow, k: int, k1: float,
                      b: float, grp=None, n_groups: int = 0,
                      min_match: int = 0):
    """The plain version of B6a: ``sparse_score_topk`` (``grp`` None) or
    ``sparse_score_topk_min_match``."""
    ok = rows >= 0
    space = allow.shape[0]
    contrib = entry_scores(tf, dl, w, avgdl, k1, b)
    scores, touched = scatter_doc_scores(rows, contrib, ok, space)
    keep = touched & allow
    if grp is not None:
        keep &= matched_groups(rows, grp, ok, space, n_groups) >= min_match
    return masked_score_topk(scores, keep, k)


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------


def sparse_score_topk(rows, tf, dl, w, avgdl, allow, k: int, k1: float,
                      b: float, seg=None):
    """Filtered BM25F top-k in one launch.

    rows [P] int32 doc ids (-1 = pad); tf/dl/w/avgdl [P] float32;
    allow [S] bool (the filter AND the live mask over the padded doc
    space); ``seg`` [G + 1] int32, the entry list's (property, term)
    segment boundaries (the kernel's input; the plain version sums in
    entry order without it). Returns (scores [k] float32 descending,
    ids [k] int32, -1 where no doc is eligible)."""
    if rows.device.type == "cpu":
        return sparse_topk_plain(rows, tf, dl, w, avgdl, allow, k, k1, b)
    return sparse_topk_cuda(rows, tf, dl, w, avgdl, allow, seg, k, k1, b)


def sparse_score_topk_min_match(rows, tf, dl, w, avgdl, grp, allow, k: int,
                                k1: float, b: float, n_groups: int,
                                min_match: int, seg=None):
    """``sparse_score_topk`` with the reference's SearchOperatorOptions: a
    doc is eligible only when it matches at least ``min_match`` distinct
    query-token groups (``grp`` [P] int32, each entry's group: a token
    that fans out across properties counts once); ``n_groups`` is the
    padded group count."""
    if rows.device.type == "cpu":
        return sparse_topk_plain(rows, tf, dl, w, avgdl, allow, k, k1, b,
                                 grp, n_groups, min_match)
    return sparse_topk_cuda(rows, tf, dl, w, avgdl, allow, seg, k, k1, b,
                            grp, n_groups, min_match)


def _check(name, t, dtype, n, dev):
    if t.dtype != dtype or t.dim() != 1 or (n is not None and t.numel() != n):
        raise ValueError(f"{name} must be {dtype} [{n}], got {t.dtype} "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, the entries on {dev}")


def _source_ints(path: Path) -> dict:
    """The ``constexpr int`` constants that a kernel source defines."""
    return {name: int(v) for name, v in re.findall(
        r"^constexpr int (k\w+) = (\d+);", path.read_text(), re.M)}


_CONST = _source_ints(Path(__file__).resolve().parent.parent / "csrc"
                      / f"{KERNEL}.cu")
# doc ids a CTA of B6a owns
SPARSE_RANGE = _CONST["kSparseRange"]


def sparse_ctas(space: int) -> int:
    """CTAs (doc ranges, and so partial lists) of one B6a launch."""
    return -(-space // SPARSE_RANGE)


def sparse_topk_cuda(rows, tf, dl, w, avgdl, allow, seg, k: int, k1: float,
                     b: float, grp=None, n_groups: int = 0,
                     min_match: int = 0):
    """B6a on the card: one launch of ``sparse_topk_kernel``, counted in
    ``launches``. Raises on arguments the kernel does not take, or when the
    launch fails."""
    dev = rows.device
    p = rows.numel()
    space = allow.shape[0]
    _check("rows", rows, torch.int32, None, dev)
    for name, t in (("tf", tf), ("dl", dl), ("w", w), ("avgdl", avgdl)):
        _check(name, t, torch.float32, p, dev)
    _check("allow", allow, torch.bool, None, dev)
    if seg is None:
        raise ValueError("B6a needs the entries' segment boundaries (seg)")
    _check("seg", seg, torch.int32, None, dev)
    if grp is not None:
        _check("grp", grp, torch.int32, p, dev)
        if n_groups < 1:
            raise ValueError(f"n_groups={n_groups} must be >= 1")
    if seg.numel() < 1:
        raise ValueError("seg must hold at least one boundary")
    if k < 1 or space < 1:
        raise ValueError(f"k={k} and the doc space {space} must be >= 1")
    if space >= 2 ** 31 or p >= 2 ** 31:
        raise ValueError("the doc space and the entries must fit int32")
    lib = _library()
    ctas = sparse_ctas(space)
    scratch = torch.empty(2 * ctas * k, dtype=torch.int64, device=dev)
    counter = torch.empty(1, dtype=torch.int32, device=dev)
    out_v = torch.empty(k, dtype=torch.float32, device=dev)
    out_i = torch.empty(k, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.sparse_topk(
            rows.data_ptr(), tf.data_ptr(), dl.data_ptr(), w.data_ptr(),
            avgdl.data_ptr(), None if grp is None else grp.data_ptr(),
            seg.data_ptr(), seg.numel() - 1, allow.data_ptr(), space,
            float(k1), float(1.0 - b), float(b), float(k1 + 1.0),
            int(n_groups), int(min_match), int(k), scratch.data_ptr(),
            counter.data_ptr(), out_v.data_ptr(), out_i.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    raise_on(lib, err, "sparse_topk")
    sparse_topk_cuda.launches += 1
    return out_v, out_i


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
                                + [p] * 4 + [p])
    lib.fusion_topk.argtypes = [p] * 3 + [i] * 5 + [p] * 3 + [p] * 2 + [p]
    lib.fusion_smem_bytes.argtypes = [i, i, i]
    for fn in (lib.sparse_topk, lib.fusion_topk, lib.fusion_smem_bytes):
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
