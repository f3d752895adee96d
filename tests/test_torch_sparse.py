"""Parity: the port's segmented BM25F scoring (``ops/sparse.py``, kernel
B6a's plain version) against the JAX package's ``sparse_score_topk`` and
``sparse_score_topk_min_match``, on the CPU.

The same numpy-seeded entry lists go to both. Tolerance: scores to 1e-5
relative (float32 sums in entry order on both sides); ids exactly wherever
the neighbouring scores of the page differ by more than that (a near tie
may order either way and stay correct). The entry lists are built the way
``InvertedIndex.bm25_device_search`` builds them, one doc-sorted segment a
(property, term) with its weight, avgdl and group (the JAX package takes
them spread over the entries), and the operands it hands the kernel are
held to the kernel's contract and to the JAX package's arrays here. A CPU
model of the kernel's per-CTA selection and one-select merge is held to
JAX on tied scores, at k up to 1,000 and with 128 min-match groups.
"""

import numpy as np
import pytest
import torch

from weaviate_tpu.ops import sparse as jsparse
from weaviate_tpu_torch.ops import sparse
from weaviate_tpu_torch.ops.fusion import bucket

import probe_hybrid

K1, B = 1.2, 0.75
RTOL = 1e-5


def _entries(rng, space, n_segs, per_seg, ties=False, n_groups=4,
             groups=None):
    """Segments of unique ascending rows (posting lists), padded to a pow2
    entry count with rows -1, in the port's layout (rows, tf, dl an entry;
    seg, seg_w, seg_avgdl, seg_grp a segment) and the JAX package's (w,
    avgdl, grp an entry too: pads 0, 1, 0). ``groups``: the segments'
    groups drawn from these, else segment s has group s % n_groups."""
    rows, tf, dl, seg = [], [], [], [0]
    for s in range(n_segs):
        n = int(rng.integers(1, per_seg + 1))
        r = np.sort(rng.choice(space, size=min(n, space), replace=False))
        rows.append(r)
        if ties:
            tf.append(np.full(len(r), 2.0))
            dl.append(np.full(len(r), 50.0))
        else:
            tf.append(rng.integers(1, 4, len(r)).astype(np.float64))
            dl.append(rng.integers(40, 90, len(r)).astype(np.float64))
        seg.append(seg[-1] + len(r))
    n = seg[-1]
    p = bucket(max(n, 1))
    out = {"rows": np.full(p, -1, np.int32), "tf": np.zeros(p, np.float32),
           "dl": np.zeros(p, np.float32),
           "seg": np.asarray(seg, np.int32),
           "seg_w": np.asarray([1.0 if ties else 0.5 + s
                                for s in range(n_segs)], np.float32),
           "seg_avgdl": np.full(n_segs, 64.5, np.float32),
           "seg_grp": (rng.choice(groups, n_segs) if groups is not None
                       else np.arange(n_segs) % n_groups).astype(np.int32)}
    if n:
        for key, parts in (("rows", rows), ("tf", tf), ("dl", dl)):
            out[key][:n] = np.concatenate(parts)
    lens = np.diff(out["seg"])
    for key, pad, dtype in (("w", 0, np.float32), ("avgdl", 1, np.float32),
                            ("grp", 0, np.int32)):
        full = np.full(p, pad, dtype)
        full[:n] = np.repeat(out[f"seg_{key}"], lens)
        out[key] = full
    return out


PORT = ("rows", "tf", "dl", "seg", "seg_w", "seg_avgdl")


def _port(e, allow, k, min_match=0, n_groups=4):
    """The port's page on the CPU: B6a's plain version."""
    t = [torch.from_numpy(e[key]) for key in PORT]
    ta = torch.from_numpy(allow)
    if min_match:
        tv, ti = sparse.sparse_score_topk_min_match(
            *t, torch.from_numpy(e["seg_grp"]), ta, k, K1, B, n_groups,
            min_match)
    else:
        tv, ti = sparse.sparse_score_topk(*t, ta, k, K1, B)
    return tv.numpy(), ti.numpy()


def _jax(e, allow, k, min_match=0, n_groups=4):
    if min_match:
        jv, ji = jsparse.sparse_score_topk_min_match(
            e["rows"], e["tf"], e["dl"], e["w"], e["avgdl"], e["grp"], allow,
            k, K1, B, n_groups, min_match)
    else:
        jv, ji = jsparse.sparse_score_topk(
            e["rows"], e["tf"], e["dl"], e["w"], e["avgdl"], allow, k, K1, B)
    return np.asarray(jv), np.asarray(ji)


def _both(e, allow, k, min_match=0, n_groups=4):
    return (_jax(e, allow, k, min_match, n_groups),
            _port(e, allow, k, min_match, n_groups))


def assert_page(j, t):
    """Scores to RTOL; -1 slots equal; ids equal except inside near ties."""
    (jv, ji), (tv, ti) = j, t
    assert tv.dtype == np.float32 and ti.dtype == np.int32
    np.testing.assert_allclose(tv, jv, rtol=RTOL, atol=1e-6)
    np.testing.assert_array_equal(ti == -1, ji == -1)
    for i in np.nonzero(ti != ji)[0]:
        near = [jv[x] for x in (i - 1, i + 1) if 0 <= x < len(jv)]
        assert any(abs(n - jv[i]) <= RTOL * abs(jv[i]) for n in near), i


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("k", [1, 10, 64])
def test_random_entries_match_jax(seed, k):
    rng = np.random.default_rng(seed)
    space = 512
    e = _entries(rng, space, n_segs=6, per_seg=200)
    allow = rng.random(space) < 0.6
    assert_page(*_both(e, allow, k))


def test_score_ties_put_the_lower_doc_first():
    rng = np.random.default_rng(7)
    e = _entries(rng, 256, n_segs=1, per_seg=120, ties=True)
    allow = np.ones(256, bool)
    j, t = _both(e, allow, 32)
    assert len(set(t[0].tolist())) == 1  # every kept doc ties
    np.testing.assert_array_equal(t[1], j[1])
    live = t[1][t[1] >= 0]
    assert (np.diff(live) > 0).all()


def test_k_above_the_docs_touched_pads_with_minus_one():
    rng = np.random.default_rng(3)
    e = _entries(rng, 128, n_segs=2, per_seg=5)
    allow = np.ones(128, bool)
    j, t = _both(e, allow, 64)
    assert_page(j, t)
    touched = len(set(e["rows"][e["rows"] >= 0].tolist()))
    assert (t[1] >= 0).sum() == touched
    assert (t[0][t[1] < 0] == 0).all()


def test_empty_query_and_all_false_allow():
    rng = np.random.default_rng(4)
    empty = _entries(rng, 64, n_segs=0, per_seg=1)
    j, t = _both(empty, np.ones(64, bool), 8)
    assert (t[1] == -1).all() and (t[0] == 0).all()
    assert_page(j, t)
    e = _entries(rng, 64, n_segs=3, per_seg=30)
    j, t = _both(e, np.zeros(64, bool), 8)
    assert (t[1] == -1).all()
    assert_page(j, t)


@pytest.mark.parametrize("min_match,n_groups", [(2, 4), (3, 4), (2, 128)])
def test_min_match_matches_jax(min_match, n_groups):
    """Distinct groups per doc, a token fanning out across segments counting
    once; 128 groups spans two of the kernel's 64-group passes."""
    rng = np.random.default_rng(min_match + n_groups)
    e = _entries(rng, 300, n_segs=8, per_seg=150, n_groups=n_groups,
                 groups=[1, 70, 100] if n_groups > 64 else None)
    if n_groups > 64:  # groups on both sides of 64
        assert set(e["seg_grp"]) & {70, 100} and 1 in set(e["seg_grp"])
    allow = rng.random(300) < 0.8
    assert_page(*_both(e, allow, 20, min_match, n_groups))


def test_device_search_hands_the_kernel_doc_sorted_segments(monkeypatch,
                                                             tmp_path):
    """``bm25_device_search`` passes segment boundaries whose rows ascend
    strictly within each segment (the kernel's contract) and whose entries
    cover every live entry, in entry order."""
    from weaviate_tpu_torch.inverted.index import InvertedIndex
    from weaviate_tpu_torch.schema.config import (
        CollectionConfig,
        DataType,
        Property,
    )
    from weaviate_tpu_torch.storage.objects import StorageObject
    from weaviate_tpu_torch.storage.store import Store

    cfg = CollectionConfig(name="T", properties=[
        Property(name="a", data_type=DataType.TEXT),
        Property(name="b", data_type=DataType.TEXT)])
    inv = InvertedIndex(cfg, Store(str(tmp_path / "s")))
    rng = np.random.default_rng(5)
    words = ["red", "green", "blue", "cyan"]
    for d in range(300):
        inv.add_object(StorageObject(
            uuid=f"u{d}", collection="T", doc_id=d, properties={
                "a": " ".join(rng.choice(words, 4)),
                "b": " ".join(rng.choice(words, 3))}))
    seen = {}
    real = sparse.sparse_score_topk_min_match

    def spy(rows, tf, dl, seg, *args, **kw):
        seen["rows"], seen["seg"] = rows.clone(), seg.clone()
        return real(rows, tf, dl, seg, *args, **kw)

    monkeypatch.setattr(sparse, "sparse_score_topk_min_match", spy)
    ids, scores = inv.bm25_device_search("red blue", 10, operator="And",
                                         device="cpu")
    rows, seg = seen["rows"].numpy(), seen["seg"].numpy()
    assert len(seg) == 5  # 2 properties x 2 terms
    for a, b in zip(seg[:-1], seg[1:]):
        assert b > a and (np.diff(rows[a:b]) > 0).all()
    assert (rows[seg[-1]:] == -1).all() and (rows[:seg[-1]] >= 0).all()
    host_ids, host_scores = inv.bm25_search("red blue", 10, operator="And")
    np.testing.assert_array_equal(ids, host_ids)
    np.testing.assert_allclose(scores, host_scores, rtol=RTOL)


def _two_indexes(tmp_path, n_docs=300, seed=5):
    """The same text objects in the JAX package's InvertedIndex and the
    port's."""
    from weaviate_tpu.inverted.index import InvertedIndex as JaxIndex
    from weaviate_tpu.schema import config as jconfig
    from weaviate_tpu.storage.objects import StorageObject as JaxObject
    from weaviate_tpu.storage.store import Store as JaxStore
    from weaviate_tpu_torch.inverted.index import InvertedIndex
    from weaviate_tpu_torch.schema import config
    from weaviate_tpu_torch.storage.objects import StorageObject
    from weaviate_tpu_torch.storage.store import Store

    out = []
    for mod, index, store, obj in (
            (jconfig, JaxIndex, JaxStore, JaxObject),
            (config, InvertedIndex, Store, StorageObject)):
        cfg = mod.CollectionConfig(name="T", properties=[
            mod.Property(name="a", data_type=mod.DataType.TEXT),
            mod.Property(name="b", data_type=mod.DataType.TEXT)])
        inv = index(cfg, store(str(tmp_path / f"s{len(out)}")))
        rng = np.random.default_rng(seed)
        words = ["red", "green", "blue", "cyan", "teal", "gold"]
        for d in range(n_docs):
            inv.add_object(obj(uuid=f"u{d}", collection="T", doc_id=d,
                               properties={
                                   "a": " ".join(rng.choice(words, 4)),
                                   "b": " ".join(rng.choice(words, 3))}))
        out.append(inv)
    return out


@pytest.mark.parametrize("operator,allow_share", [("Or", None), ("Or", 0.45),
                                                  ("And", 0.8)])
def test_device_operands_expand_to_the_jax_per_entry_arrays(
        monkeypatch, tmp_path, operator, allow_share):
    """The per-segment operands ``_device_sparse_single`` uploads, spread
    over their entries, are the JAX package's per-entry arrays for the same
    index and query (``weaviate_tpu/inverted/index.py``
    ``_device_sparse_single``), pads included."""
    jinv, tinv = _two_indexes(tmp_path)
    allow = (None if allow_share is None else
             np.random.default_rng(3).random(300) < allow_share)
    seen = {}
    name = ("sparse_score_topk_min_match" if operator == "And"
            else "sparse_score_topk")

    def jspy(*args, **kw):
        seen["jax"] = [np.asarray(a) for a in args]
        return getattr(jsparse, "_real_" + name)(*args, **kw)

    def tspy(*args, **kw):
        seen["port"] = [a.clone() if torch.is_tensor(a) else a for a in args]
        return getattr(sparse, "_real_" + name)(*args, **kw)

    monkeypatch.setattr(jsparse, "_real_" + name, getattr(jsparse, name),
                        raising=False)
    monkeypatch.setattr(sparse, "_real_" + name, getattr(sparse, name),
                        raising=False)
    monkeypatch.setattr(jsparse, name, jspy)
    monkeypatch.setattr(sparse, name, tspy)
    jout = jinv.bm25_device_search("red blue teal", 10, allow_list=allow,
                                   doc_space=300, operator=operator)
    tout = tinv.bm25_device_search("red blue teal", 10, allow_list=allow,
                                   doc_space=300, operator=operator,
                                   device="cpu")
    port = seen["port"]
    rows, tf, dl, seg, seg_w, seg_avgdl = port[:6]
    mm = operator == "And"
    allow_t = port[7] if mm else port[6]
    w, ad = sparse.per_entry(rows.numel(), seg, (seg_w, 0.0),
                             (seg_avgdl, 1.0))
    planes = [rows, tf, dl, w, ad]
    if mm:
        planes += sparse.per_entry(rows.numel(), seg, (port[6], 0))
    planes.append(allow_t)
    jax = seen["jax"]
    for got, want in zip(planes, jax):
        np.testing.assert_array_equal(got.numpy(), want)
        assert got.numpy().dtype == want.dtype
    # k, k1, b (and n_groups, min_match) beside them
    assert [float(x) for x in port[8 if mm else 7:]] == \
        [float(x) for x in jax[len(planes):]]
    np.testing.assert_array_equal(tout[0], jout[0])
    np.testing.assert_allclose(tout[1], jout[1], rtol=RTOL)


def test_cta_range_fits_the_doc_space():
    """B6a's doc ids a CTA: a power of two in [kSparseMinRange,
    kSparseMaxRange], the smallest whose CTAs are at most kSparseCtas, over
    doc spaces from 1 to 2^20; phase hybrid's 8,192-doc tenants fill 16
    SMs, not 2."""
    lo, hi = sparse.CONST["kSparseMinRange"], sparse.CONST["kSparseMaxRange"]
    target = sparse.CONST["kSparseCtas"]
    spaces = sorted({1, 2, 511, 512, 513, 8192, 65535, 65536, 65537,
                     550_000, 1 << 20} | {(1 << e) + d for e in range(21)
                                            for d in (-1, 0, 1) if
                                            (1 << e) + d >= 1})
    for space in spaces:
        r = sparse.sparse_range(space)
        assert lo <= r <= hi and r & (r - 1) == 0, space
        ctas = sparse.sparse_ctas(space)
        assert ctas == -(-space // r) and ctas * r >= space
        assert ctas <= target or r == hi, space
        assert r == lo or -(-space // (r // 2)) > target, space
    assert sparse.sparse_ctas(8192) == 16
    assert sparse.sparse_ctas(1 << 20) == 256


# -- a CPU model of B6a's selection -----------------------------------------

NONE = (1 << 64) - 1


def _key(score: np.float32, doc: int) -> int:
    """The kernel's sort_key: descending score, then ascending doc id."""
    u = int(np.float32(score + np.float32(0.0)).view(np.uint32))
    ordv = (~u & 0xFFFFFFFF) if u & 0x80000000 else (u | 0x80000000)
    return ((~ordv & 0xFFFFFFFF) << 32) | int(doc)


def _key_score(key: int) -> np.float32:
    ordv = ~(key >> 32) & 0xFFFFFFFF
    u = (ordv & 0x7FFFFFFF) if ordv & 0x80000000 else (~ordv & 0xFFFFFFFF)
    return np.uint32(u).view(np.float32)


def _select_k(keys: list, k: int) -> list:
    """select_k: the k smallest live keys (distinct), by byte passes over
    only the bytes the live keys do not share."""
    live = [x for x in keys if x != NONE]
    if len(live) <= k:
        return live
    orv = andv = live[0]
    for x in live:
        orv |= x
        andv &= x
    diff, pk, need = orv ^ andv, andv, k
    shift = (diff.bit_length() - 1) & ~7
    while True:
        hm = 0 if shift >= 56 else (NONE << (shift + 8)) & NONE
        hist = [0] * 256
        for x in live:
            if x & hm == pk & hm:
                hist[(x >> shift) & 255] += 1
        before = 0
        for digit, c in enumerate(hist):
            if before < need <= before + c:
                break
            before += c
        need -= before
        pk = (pk & ~(0xFF << shift)) | (digit << shift)
        if hist[digit] == need:
            limit = pk | ((1 << shift) - 1)
            break
        shift = ((diff & ((1 << shift) - 1)).bit_length() - 1) & ~7
    out = [x for x in live if x <= limit]
    assert len(out) == k
    return out


def _rank_write(keys: list, k: int) -> list:
    """Each live key at its rank among keys (the count of keys below it),
    ranks below k kept."""
    out = [None] * min(k, sum(x != NONE for x in keys))
    for x in keys:
        if x != NONE:
            r = sum(y < x for y in keys)
            if r < k:
                out[r] = x
    return out


def _b6a_model(e, allow, k, min_match=0, n_groups=0, rank_max=None,
               stage=None):
    """B6a as the kernel computes it: the doc space cut into CTA ranges,
    each CTA's doc sums in entry order and its min-match masks 64 groups a
    pass, its kept keys' k best (by rank below ``rank_max`` kept keys,
    else select_k), then the last CTA's one select over the m x k partial
    keys (by rank where they are staged and at most ``rank_max``), the
    survivors ranked. ``rank_max`` / ``stage`` lowered force the radix
    paths at these small sizes."""
    rank_max = sparse.CONST["kRankMax"] if rank_max is None else rank_max
    space = len(allow)
    r_len = sparse.sparse_range(space)
    rows, seg = e["rows"], e["seg"]
    contrib = sparse.entry_scores(*(torch.from_numpy(x) for x in (
        e["tf"], e["dl"], e["w"], e["avgdl"])), K1, B).numpy()
    parts = []
    for lo in range(0, space, r_len):
        n = min(r_len, space - lo)
        acc = np.zeros(n, np.float32)
        touched = np.zeros(n, bool)
        cnt = np.zeros(n, np.int64)
        for s in range(len(seg) - 1):  # segments in order
            for i in range(seg[s], seg[s + 1]):
                if lo <= rows[i] < lo + n:
                    acc[rows[i] - lo] = np.float32(acc[rows[i] - lo]
                                                   + contrib[i])
                    touched[rows[i] - lo] = True
        if min_match:
            for g0 in range(0, n_groups, 64):
                mask = np.zeros(n, np.uint64)
                for s in range(len(seg) - 1):
                    g = int(e["seg_grp"][s])
                    if g0 <= g < min(g0 + 64, n_groups):
                        r = rows[seg[s]:seg[s + 1]]
                        r = r[(r >= lo) & (r < lo + n)] - lo
                        mask[r] |= np.uint64(1 << (g - g0))
                cnt += np.array([bin(int(m)).count("1") for m in mask])
        keep = touched & allow[lo:lo + n] & (cnt >= min_match)
        keys = [_key(acc[i], lo + i) for i in np.nonzero(keep)[0]]
        best = (_rank_write(keys, k) if len(keys) <= rank_max
                else _select_k(keys, k))
        parts += best + [NONE] * (k - len(best))
    staged = stage is None or len(parts) <= stage
    if staged and len(parts) <= rank_max:
        page = _rank_write(parts, k)
    else:
        page = _rank_write(_select_k(parts, k), k)
    vals = np.zeros(k, np.float32)
    ids = np.full(k, -1, np.int32)
    for j, x in enumerate(page):
        vals[j], ids[j] = _key_score(x), x & 0xFFFFFFFF
    return vals, ids


@pytest.mark.parametrize("k", [1, 10, 100, 1000])
@pytest.mark.parametrize("paths", ["rank", "radix"])
def test_cta_select_and_one_select_merge_model_matches_jax(k, paths):
    """The kernel's per-CTA select and single-select merge, modelled on the
    CPU on entries with many tied scores, against JAX's
    ``sparse_score_topk`` (scores to RTOL, ids outside near ties) and the
    port's plain version (equal in bits: the same keys selected). "radix"
    lowers the rank limit and the stage so that every CTA and the merge
    take select_k."""
    rng = np.random.default_rng(k)
    space = 65536 + 4096  # 129 CTAs of 1,024
    e = _entries(rng, space, n_segs=5, per_seg=900, ties=True)
    allow = rng.random(space) < 0.7
    kk = min(k, bucket(space))
    opts = {"rank": {}, "radix": {"rank_max": 4, "stage": 0}}[paths]
    got = _b6a_model(e, allow, kk, **opts)
    assert len(set(got[0].tolist())) < 40  # many scores tie
    assert_page(_jax(e, allow, kk), got)
    want = _port(e, allow, kk)
    np.testing.assert_array_equal(got[0].view(np.int32),
                                  want[0].view(np.int32))
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("k", [1, 10, 100])
def test_cta_select_model_min_match_128_groups_matches_jax(k):
    """The model under min-match with 128 groups (two 64-group passes), the
    select forced onto its radix path."""
    rng = np.random.default_rng(100 + k)
    space = 8192
    e = _entries(rng, space, n_segs=8, per_seg=3000, n_groups=128,
                 groups=[1, 63, 64, 70, 127])
    allow = rng.random(space) < 0.8
    got = _b6a_model(e, allow, k, 2, 128, rank_max=4, stage=0)
    assert (got[1] >= 0).sum() == k
    assert_page(_jax(e, allow, k, 2, 128), got)
    want = _port(e, allow, k, 2, 128)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0].view(np.int32),
                                  want[0].view(np.int32))


@pytest.mark.parametrize("name", sorted(probe_hybrid.COPIES))
def test_probe_copies_apply_to_the_kernel_source(name):
    # probe_hybrid.py's copies replace text the kernel source holds exactly
    # once, so a kernel edit that drops one fails here
    src = probe_hybrid.SOURCE.read_text()
    for old, new in probe_hybrid.COPIES[name]:
        assert src.count(old) == 1, repr(old)
    assert probe_hybrid.copies_of(src)[name] != src + probe_hybrid.APPENDED
