"""Parity: weaviate_tpu_torch inverted index, filters, snapshots, cost
planner and resident filter planes against the JAX package's, on the CPU.

The same seeded objects go into both packages' ``InvertedIndex``. Allow
masks must be identical for every filter in ``FILTERS``, BM25 pages must
agree (ids exactly, scores to float32 rounding), and snapshots must be the
same bytes and load in the other package. ``plan()`` is pure, so seeded
stats give identical plans. Planes built from the same filter give the same
host bitmaps, and the port's device mirror equals them.
"""

import numpy as np
import pytest
import torch

from weaviate_tpu.inverted import analyzer as janalyzer
from weaviate_tpu.inverted import snapshot as jsnapshot
from weaviate_tpu.inverted.filters import Filter as JFilter
from weaviate_tpu.inverted.index import InvertedIndex as JaxInverted
from weaviate_tpu.query.planner import cost as jcost
from weaviate_tpu.query.planner import planes as jplanes
from weaviate_tpu.schema import config as jconfig
from weaviate_tpu.storage.objects import StorageObject as JaxObject
from weaviate_tpu.storage.store import Store as JaxStore
from weaviate_tpu_torch.inverted import analyzer, snapshot
from weaviate_tpu_torch.inverted.filters import Filter, Where
from weaviate_tpu_torch.inverted.index import InvertedIndex
from weaviate_tpu_torch.query.planner import cost, planes
from weaviate_tpu_torch.schema import config
from weaviate_tpu_torch.storage.objects import StorageObject
from weaviate_tpu_torch.storage.store import Store

N = 2000
WORDS = ["alpha", "beta", "gamma", "delta", "epsilon", "zeta", "eta",
         "theta", "iota", "kappa", "lambda", "mu", "the", "and"]
CATS = ["news", "sports", "science", "arts", "travel"]

FILTERS = {
    "eq_int": Where.eq("views", 42),
    "eq_text_field": Where.eq("category", "science"),
    "like_word": Where.like("title", "*gamma*"),
    "neq": Where.neq("category", "news"),
    "gt": Where.gt("views", 900),
    "gte_range": Where.gte("rank", 750),
    "lt": Where.lt("price", -1.0),
    "lte": Where.lte("views", 10),
    "like_prefix": Where.like("category", "sp*"),
    "like_suffix": Where.like("category", "*ts"),
    "like_any": Where.like("category", "s?i*"),
    "bool": Where.eq("ok", True),
    "contains_any": Where.contains_any("tags", ["t1", "t3"]),
    "contains_all": Where.contains_all("tags", ["t0", "t2"]),
    "is_null": Where.is_null("price"),
    "and": Where.and_(Where.gt("views", 300), Where.eq("category", "arts")),
    "or": Where.or_(Where.lt("views", 50), Where.like("category", "tra*")),
    "not": Where.not_(Where.eq("ok", True)),
    "nested": Where.and_(Where.or_(Where.eq("category", "news"),
                                   Where.gte("rank", 900)),
                         Where.not_(Where.lt("price", 0.0))),
}


def _cfg(mod):
    P, T = mod.Property, mod.DataType
    return mod.CollectionConfig(
        name="Doc",
        properties=[
            P("title", T.TEXT),
            P("category", T.TEXT, tokenization=mod.Tokenization.FIELD),
            P("views", T.INT),
            P("rank", T.INT, index_range_filters=True),
            P("price", T.NUMBER),
            P("ok", T.BOOL),
            P("tags", T.TEXT_ARRAY),
        ])


def _records(seed=0, n=N):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        props = {
            "title": " ".join(rng.choice(WORDS, int(rng.integers(2, 9)))),
            "category": str(rng.choice(CATS)),
            "views": int(rng.integers(0, 1000)),
            "rank": int(rng.integers(0, 1000)),
            "ok": bool(rng.random() < 0.4),
            "tags": [f"t{j}" for j in range(4) if rng.random() < 0.4],
        }
        if rng.random() < 0.9:
            props["price"] = float(np.round(rng.standard_normal() * 3, 3))
        out.append(dict(uuid=f"00000000-0000-4000-8000-{i:012d}",
                        collection="Doc", properties=props, doc_id=i,
                        creation_time_ms=1, update_time_ms=1))
    return out


def _fill(tmp_path, name, Inv, Obj, St, cfg):
    """One package's index over the writes: N adds, 10% deleted, 5% updated
    (delete + re-add under a new doc id, as the shard does)."""
    ix = Inv(cfg, St(str(tmp_path / name)))
    objs = [Obj(**r) for r in _records()]
    for o in objs:
        ix.add_object(o)
    for o in objs[::10]:
        ix.delete_object(o)
    for i, o in enumerate(objs[1::20]):
        ix.delete_object(o)
        o.doc_id = N + i
        o.properties["views"] = 42
        ix.add_object(o)
    return ix


def _engine(ix) -> str:
    return "native" if ix.native is not None else "dense"


def _build(tmp_path):
    """Both indexes over the same writes, on the same BM25 engine. Each
    package's native WAND engine and its dense path may order a near tie
    differently, so when one package's native engine did not come up, the
    other's index is built on its dense path too
    (``WEAVIATE_TPU_NATIVE_BM25=off``)."""
    j = _fill(tmp_path, "jax", JaxInverted, JaxObject, JaxStore,
              _cfg(jconfig))
    with pytest.MonkeyPatch.context() as mp:
        if j.native is None:
            mp.setenv("WEAVIATE_TPU_NATIVE_BM25", "off")
        t = _fill(tmp_path, "torch", InvertedIndex, StorageObject, Store,
                  _cfg(config))
    if j.native is not None and t.native is None:
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("WEAVIATE_TPU_NATIVE_BM25", "off")
            j = _fill(tmp_path, "jax-dense", JaxInverted, JaxObject,
                      JaxStore, _cfg(jconfig))
    assert _engine(j) == _engine(t)
    return j, t


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return _build(tmp_path_factory.mktemp("inv"))


@pytest.mark.parametrize("name", sorted(FILTERS))
def test_allow_masks_identical(pair, name):
    j, t = pair
    flt = FILTERS[name]
    jf = JFilter.from_dict(flt.to_dict())
    space = N + 200
    want = j.allow_list(jf, space)
    got = t.allow_list(flt, space)
    assert got.dtype == want.dtype == bool
    np.testing.assert_array_equal(got, want)
    assert 0 < int(want.sum()) < space, name  # the filter selects something
    assert t.estimate_selectivity(flt) == pytest.approx(
        j.estimate_selectivity(jf), rel=1e-12)


BM25_QUERIES = ["gamma delta", "the beta", "zeta", "kappa lambda mu",
                "nomatch"]


def _pages_agree(j, t, query):
    allow = np.zeros(N + 200, bool)
    allow[::3] = True
    engines = f"engines: jax {_engine(j)}, torch {_engine(t)}"
    for kw in ({}, {"allow_list": allow}, {"properties": ["title^2"]},
               {"operator": "And"}):
        jid, jsc = j.bm25_search(query, 10, **kw)
        tid, tsc = t.bm25_search(query, 10, **kw)
        np.testing.assert_array_equal(tid, jid, err_msg=f"{kw} {engines}")
        np.testing.assert_allclose(tsc, jsc, rtol=1e-6, atol=1e-6,
                                   err_msg=f"{kw} {engines}")


@pytest.mark.parametrize("query", BM25_QUERIES)
def test_bm25_pages_agree(pair, query):
    _pages_agree(*pair, query)


@pytest.mark.parametrize("side", ["jax", "torch"])
def test_bm25_pair_follows_an_engine_that_did_not_come_up(tmp_path,
                                                          monkeypatch, side):
    """One package's native engine forced off: the pair is built on the
    dense path on both sides and agrees page for page."""
    from weaviate_tpu.inverted import native_bm25 as jnative
    from weaviate_tpu_torch.inverted import native_bm25 as tnative

    monkeypatch.setattr(jnative if side == "jax" else tnative,
                        "try_native_bm25", lambda k1, b: None)
    j, t = _build(tmp_path)
    assert j.native is None and t.native is None
    for query in BM25_QUERIES:
        _pages_agree(j, t, query)


def test_native_engine_on_the_write_path(tmp_path):
    """The port's native engine builds and takes an index's writes."""
    t = InvertedIndex(_cfg(config), Store(str(tmp_path / "t")))
    assert t.native is not None, "the port's BM25 engine did not build"
    for r in _records(n=50):
        t.add_object(StorageObject(**r))
    ids, _ = t.bm25_search("gamma", 5)
    assert len(ids) > 0


def test_snapshot_bytes_identical_and_cross_load(pair, tmp_path):
    j, t = pair
    pj, pt = str(tmp_path / "j.snap"), str(tmp_path / "t.snap")
    jsnapshot.save_snapshot(j, pj, 17)
    snapshot.save_snapshot(t, pt, 17)
    assert open(pj, "rb").read() == open(pt, "rb").read()
    # each package loads the other's snapshot into a fresh index
    t2 = InvertedIndex(_cfg(config), Store(str(tmp_path / "t2")))
    assert snapshot.load_snapshot(t2, pj) == 17
    j2 = JaxInverted(_cfg(jconfig), JaxStore(str(tmp_path / "j2")))
    assert jsnapshot.load_snapshot(j2, pt) == 17
    for flt in FILTERS.values():
        jf = JFilter.from_dict(flt.to_dict())
        np.testing.assert_array_equal(t2.allow_list(flt, N + 200),
                                      j.allow_list(jf, N + 200))
        np.testing.assert_array_equal(j2.allow_list(jf, N + 200),
                                      j.allow_list(jf, N + 200))
    np.testing.assert_array_equal(t2.bm25_search("gamma beta", 10)[0],
                                  j.bm25_search("gamma beta", 10)[0])


@pytest.mark.parametrize("scheme", ["word", "lowercase", "whitespace",
                                    "field", "trigram", "gse"])
def test_tokenizers_agree(scheme):
    texts = ["Hello, World! The quick-brown fox.", "  spaced   out ",
             "naïve café ÜBER", "東京タワー と Tokyo", "a_b c-d 42x"]
    for s in texts:
        assert analyzer.tokenize(s, scheme) == janalyzer.tokenize(s, scheme)
    assert analyzer.stopword_set("en") == janalyzer.stopword_set("en")


def test_filter_dict_roundtrip_and_validation():
    for flt in FILTERS.values():
        assert Filter.from_dict(flt.to_dict()).to_dict() == flt.to_dict()
        flt.validate()
    with pytest.raises(ValueError):
        Filter("Bogus", ["x"], 1).validate()


def _stats(mod, sel, **kw):
    base = dict(live=20_000, k=10, ef=64, selectivity=sel, flat_cutoff=50)
    base.update(kw)
    return mod.PlanStats(**base)


@pytest.mark.parametrize("sel", [1.0, 0.0004, 0.002, 0.01, 0.04, 0.07, 0.2,
                                 0.5, 0.9])
@pytest.mark.parametrize("resident", [False, True])
def test_plans_identical(sel, resident):
    a = cost.plan(_stats(cost, sel, plane_resident=resident))
    b = jcost.plan(_stats(jcost, sel, plane_resident=resident))
    assert a.trace_attrs() == b.trace_attrs()
    assert cost.expansion_budget(sel) == jcost.expansion_budget(sel)


def test_planes_match_and_mirror_on_device(pair):
    j, t = pair
    space = N + 200
    recs = _records()
    for flt in FILTERS.values():
        jf = JFilter.from_dict(flt.to_dict())
        assert planes.canonical_key(flt) == jplanes.canonical_key(jf)
        tp = planes.FilterPlaneStore(lambda f: t.allow_list(f, space),
                                     device="cpu")
        jp = jplanes.FilterPlaneStore(lambda f: j.allow_list(f, space))
        tpl, jpl = tp.declare(flt), jp.declare(jf)
        assert tpl.plane_id == jpl.plane_id
        assert tp.lookup(flt) is tpl and jp.lookup(jf) is jpl
        # incremental maintenance on the write path
        for r in recs[:50]:
            tp.on_put(r["doc_id"], r["properties"])
            jp.on_put(r["doc_id"], r["properties"])
        tp.on_delete(3)
        jp.on_delete(3)
        np.testing.assert_array_equal(tpl.mask(space), jpl.mask(space))
        assert tpl.version == jpl.version and tpl.stale == jpl.stale
        dev = tpl.device_mask(4096)
        assert isinstance(dev, torch.Tensor) and dev.device.type == "cpu"
        np.testing.assert_array_equal(dev.numpy(), tpl.mask(4096))
        assert tpl.device_mask(4096) is dev  # cached
        assert tp.drop_device() == 4096 and tpl.hbm_bytes() == 0
        if tpl.incremental:
            for r in recs[:200]:
                assert planes.matches(flt, r["properties"]) == \
                    jplanes.matches(jf, r["properties"])


def test_mesh_sharded_plane_raises():
    pl = planes.FilterPlane(Where.eq("n", 1), device="cpu")
    pl.rebuild(np.ones(8, bool))
    with pytest.raises(NotImplementedError, match="slice 11"):
        pl.device_mask(8, sharding=object())


def test_device_bm25_raises(pair):
    """The device scoring is ported (``tests/test_torch_sparse.py``,
    ``tests/test_torch_hybrid.py``); its mesh form raises, naming its
    slice, and the single-device form answers as the JAX one does."""
    j, t = pair
    with pytest.raises(NotImplementedError, match="slice 11"):
        t._device_sparse_mesh(None, None, None, None, None, None, None, 1, 1)
    ji, js = j.bm25_device_search("gamma", 10)
    ti, ts = t.bm25_device_search("gamma", 10, device="cpu")
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(ts, js, rtol=1e-5)
    assert len(ti) == 10
