"""Parity: the port's segmented BM25F scoring (``ops/sparse.py``, kernel
B6a's plain version) against the JAX package's ``sparse_score_topk`` and
``sparse_score_topk_min_match``, on the CPU.

The same numpy-seeded entry lists go to both. Tolerance: scores to 1e-5
relative (float32 sums in entry order on both sides); ids exactly wherever
the neighbouring scores of the page differ by more than that (a near tie
may order either way and stay correct). The entry lists are built the way
``InvertedIndex.bm25_device_search`` builds them, one doc-sorted segment a
(property, term), and the segment boundaries it hands the kernel are held
to the kernel's contract here.
"""

import numpy as np
import pytest
import torch

from weaviate_tpu.ops import sparse as jsparse
from weaviate_tpu_torch.ops import sparse
from weaviate_tpu_torch.ops.fusion import bucket

K1, B = 1.2, 0.75
RTOL = 1e-5


def _entries(rng, space, n_segs, per_seg, ties=False, n_groups=4):
    """Segments of unique ascending rows (posting lists), padded to a pow2
    entry count with rows -1. Returns numpy arrays and the boundaries."""
    rows, tf, dl, w, ad, grp, seg = [], [], [], [], [], [], [0]
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
        w.append(np.full(len(r), 0.5 + s if not ties else 1.0))
        ad.append(np.full(len(r), 64.5))
        grp.append(np.full(len(r), s % n_groups))
        seg.append(seg[-1] + len(r))
    n = seg[-1]
    p = bucket(max(n, 1))
    out = {"rows": np.full(p, -1, np.int32), "tf": np.zeros(p, np.float32),
           "dl": np.zeros(p, np.float32), "w": np.zeros(p, np.float32),
           "avgdl": np.ones(p, np.float32), "grp": np.zeros(p, np.int32)}
    if n:
        for key, parts in (("rows", rows), ("tf", tf), ("dl", dl),
                           ("w", w), ("avgdl", ad), ("grp", grp)):
            out[key][:n] = np.concatenate(parts)
    return out, np.asarray(seg, np.int32)


def _both(e, allow, k, min_match=0, n_groups=4):
    t = {key: torch.from_numpy(v) for key, v in e.items()}
    ta = torch.from_numpy(allow)
    if min_match:
        jv, ji = jsparse.sparse_score_topk_min_match(
            e["rows"], e["tf"], e["dl"], e["w"], e["avgdl"], e["grp"], allow,
            k, K1, B, n_groups, min_match)
        tv, ti = sparse.sparse_score_topk_min_match(
            t["rows"], t["tf"], t["dl"], t["w"], t["avgdl"], t["grp"], ta, k,
            K1, B, n_groups, min_match)
    else:
        jv, ji = jsparse.sparse_score_topk(
            e["rows"], e["tf"], e["dl"], e["w"], e["avgdl"], allow, k, K1, B)
        tv, ti = sparse.sparse_score_topk(
            t["rows"], t["tf"], t["dl"], t["w"], t["avgdl"], ta, k, K1, B)
    return (np.asarray(jv), np.asarray(ji)), (tv.numpy(), ti.numpy())


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
    e, _ = _entries(rng, space, n_segs=6, per_seg=200)
    allow = rng.random(space) < 0.6
    assert_page(*_both(e, allow, k))


def test_score_ties_put_the_lower_doc_first():
    rng = np.random.default_rng(7)
    e, _ = _entries(rng, 256, n_segs=1, per_seg=120, ties=True)
    allow = np.ones(256, bool)
    j, t = _both(e, allow, 32)
    assert len(set(t[0].tolist())) == 1  # every kept doc ties
    np.testing.assert_array_equal(t[1], j[1])
    live = t[1][t[1] >= 0]
    assert (np.diff(live) > 0).all()


def test_k_above_the_docs_touched_pads_with_minus_one():
    rng = np.random.default_rng(3)
    e, _ = _entries(rng, 128, n_segs=2, per_seg=5)
    allow = np.ones(128, bool)
    j, t = _both(e, allow, 64)
    assert_page(j, t)
    touched = len(set(e["rows"][e["rows"] >= 0].tolist()))
    assert (t[1] >= 0).sum() == touched
    assert (t[0][t[1] < 0] == 0).all()


def test_empty_query_and_all_false_allow():
    rng = np.random.default_rng(4)
    empty, _ = _entries(rng, 64, n_segs=0, per_seg=1)
    j, t = _both(empty, np.ones(64, bool), 8)
    assert (t[1] == -1).all() and (t[0] == 0).all()
    assert_page(j, t)
    e, _ = _entries(rng, 64, n_segs=3, per_seg=30)
    j, t = _both(e, np.zeros(64, bool), 8)
    assert (t[1] == -1).all()
    assert_page(j, t)


@pytest.mark.parametrize("min_match,n_groups", [(2, 4), (3, 4), (2, 128)])
def test_min_match_matches_jax(min_match, n_groups):
    """Distinct groups per doc, a token fanning out across segments counting
    once; 128 groups spans two of the kernel's 64-group passes."""
    rng = np.random.default_rng(min_match + n_groups)
    e, _ = _entries(rng, 300, n_segs=8, per_seg=150, n_groups=n_groups)
    if n_groups > 64:  # groups on both sides of 64
        e["grp"][e["rows"] >= 0] = rng.choice([1, 70, 100],
                                              int((e["rows"] >= 0).sum()))
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

    def spy(rows, *args, seg=None, **kw):
        seen["rows"], seen["seg"] = rows.clone(), seg.clone()
        return real(rows, *args, seg=seg, **kw)

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
