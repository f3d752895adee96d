"""Parity: the port's keyword, hybrid and aggregate read paths and the
explorer (``Collection.bm25_search`` / ``hybrid_search`` / ``aggregate``,
``query/explorer.py``) against the JAX package's, on one seeded
multi-tenant collection with text, on the CPU.

The collection has BASELINE config 5's shape at a small size: tenants of a
multi-tenant collection, a text property drawn from a Zipf vocabulary, an
int ``bucket``, and cosine vectors in an SQ flat index with a rescore
limit. Tolerance: scores to 1e-5 relative (float32 BM25 on both sides,
float32 fusion); uuids exactly wherever the neighbouring scores of the page
differ by more than that. Also: a text collection written by one package
opens in the other and answers the same; one fusion dispatch a hybrid
request; a kernel wrapper that raises makes the request raise.
"""

import numpy as np
import pytest

from weaviate_tpu.core.db import DB as JaxDB
from weaviate_tpu.inverted.filters import Filter as JFilter
from weaviate_tpu.query import explorer as jexplorer
from weaviate_tpu.schema import config as jconfig
from weaviate_tpu.storage.objects import StorageObject as JaxObject
from weaviate_tpu_torch.core.db import DB
from weaviate_tpu_torch.inverted.filters import Where
from weaviate_tpu_torch.ops import fusion, sparse
from weaviate_tpu_torch.query import explorer
from weaviate_tpu_torch.schema import config
from weaviate_tpu_torch.storage.objects import StorageObject

RTOL = 1e-5
DIMS = 16
TENANTS = ("t0", "t1")
PER_TENANT = 300
VOCAB = [f"w{i}" for i in range(40)]
TAGS = ["news", "sports", "science", "arts"]
QUERIES = ["w0 w3", "w1 w7 w12", "w5", "w2 w2 w30", "w39 w0 w1 w4"]
FILTERS = {
    "one_pct": Where.eq("bucket", 7),
    "near_half": Where.lt("bucket", 45),
}


def _cfg(mod, name="Msmarco"):
    P, T = mod.Property, mod.DataType
    return mod.CollectionConfig(
        name=name,
        properties=[P("body", T.TEXT), P("tag", T.TEXT), P("bucket", T.INT)],
        vector_config=mod.FlatIndexConfig(
            distance="cosine", quantizer=mod.SQConfig(rescore_limit=40)),
        multi_tenancy=mod.MultiTenancyConfig(enabled=True))


def _records(seed, tenant, n=PER_TENANT):
    rng = np.random.default_rng(seed)
    p = 1.0 / (1.0 + np.arange(len(VOCAB))) ** 0.9
    p /= p.sum()
    centres = rng.standard_normal((8, DIMS)).astype(np.float32)
    vecs = centres[rng.integers(0, 8, n)] + 0.4 * rng.standard_normal(
        (n, DIMS)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    out = []
    for i in range(n):
        u = rng.bytes(16).hex()
        words = rng.choice(VOCAB, int(rng.integers(4, 12)), p=p)
        out.append(dict(
            uuid=f"{u[:8]}-{u[8:12]}-4{u[13:16]}-8{u[17:20]}-{u[20:32]}",
            collection="Msmarco", tenant=tenant, vector=vecs[i],
            properties={"body": " ".join(words),
                        "tag": TAGS[int(rng.integers(0, len(TAGS)))],
                        "bucket": int(rng.integers(0, 100))},
            creation_time_ms=1, update_time_ms=1))
    return out


def _fill(col, cls):
    for t_i, tenant in enumerate(TENANTS):
        col.add_tenant(tenant)
        recs = _records(100 + t_i, tenant)
        col.put_batch([cls(**dict(r, properties=dict(r["properties"])))
                       for r in recs], tenant=tenant)


def _qvec(seed):
    v = np.random.default_rng(seed).standard_normal(DIMS).astype(np.float32)
    return v / np.linalg.norm(v)


def _jflt(flt):
    return None if flt is None else JFilter.from_dict(flt.to_dict())


@pytest.fixture(scope="module")
def cols(tmp_path_factory):
    root = tmp_path_factory.mktemp("hybrid")
    jdb = JaxDB(str(root / "jax"))
    tdb = DB(str(root / "torch"), device="cpu")
    jcol = jdb.create_collection(_cfg(jconfig))
    tcol = tdb.create_collection(_cfg(config))
    _fill(jcol, JaxObject)
    _fill(tcol, StorageObject)
    yield jdb, tdb, jcol, tcol
    jdb.close()
    tdb.close()


def assert_pages(jres, tres, score=lambda s: s):
    """[(obj, score)] pages: scores to RTOL, uuids equal except in near
    ties."""
    ju = [o.uuid for o, _ in jres]
    tu = [o.uuid for o, _ in tres]
    js = np.asarray([score(s) for _, s in jres], np.float64)
    ts = np.asarray([score(s) for _, s in tres], np.float64)
    assert len(ju) == len(tu)
    np.testing.assert_allclose(ts, js, rtol=RTOL, atol=1e-6)
    for i in (i for i in range(len(ju)) if ju[i] != tu[i]):
        near = [js[x] for x in (i - 1, i + 1) if 0 <= x < len(js)]
        assert any(abs(n - js[i]) <= RTOL * abs(js[i]) + 1e-6
                   for n in near), (i, ju, tu)


@pytest.mark.parametrize("tenant", TENANTS)
@pytest.mark.parametrize("flt", [None, *FILTERS])
@pytest.mark.parametrize("device_scoring", [False, True])
def test_bm25_search_matches_jax(cols, tenant, flt, device_scoring):
    _, _, jcol, tcol = cols
    f = FILTERS.get(flt)
    for q in QUERIES:
        kw = dict(k=10, tenant=tenant, device_scoring=device_scoring)
        jres = jcol.bm25_search(q, flt=_jflt(f), **kw)
        tres = tcol.bm25_search(q, flt=f, **kw)
        assert_pages(jres, tres)
        if f is None:
            assert tres


@pytest.mark.parametrize("operator,minimum_match", [("And", 0), ("Or", 2)])
def test_bm25_device_min_match_matches_jax(cols, operator, minimum_match):
    _, _, jcol, tcol = cols
    before = sparse.dispatch_count()
    for q in QUERIES[1:]:
        kw = dict(k=10, tenant="t1", operator=operator,
                  minimum_match=minimum_match, device_scoring=True)
        jres = jcol.bm25_search(q, flt=_jflt(FILTERS["near_half"]), **kw)
        tres = tcol.bm25_search(q, flt=FILTERS["near_half"], **kw)
        assert_pages(jres, tres)
    assert sparse.dispatch_count() == before + len(QUERIES) - 1


@pytest.mark.parametrize("fusion_name", ["relativeScoreFusion",
                                         "rankedFusion"])
@pytest.mark.parametrize("flt", [None, *FILTERS])
@pytest.mark.parametrize("alpha", [0.0, 0.5, 1.0])
def test_hybrid_search_matches_jax(cols, fusion_name, flt, alpha):
    """Unfiltered: WAND + the dense leg; filtered: the device sparse leg
    (``hybrid_sparse_device="auto"``); both fusions."""
    _, _, jcol, tcol = cols
    f = FILTERS.get(flt)
    before = (fusion.dispatch_count(), sparse.dispatch_count())
    for i, q in enumerate(QUERIES):
        kw = dict(query=q, vector=_qvec(i), alpha=alpha, k=10,
                  fusion=fusion_name, tenant=TENANTS[i % 2])
        jres = jcol.hybrid_search(flt=_jflt(f), **kw)
        tres = tcol.hybrid_search(flt=f, **kw)
        assert_pages(jres, tres)
        assert tres
    assert fusion.dispatch_count() == before[0] + len(QUERIES)
    sparse_legs = len(QUERIES) if f is not None and alpha < 1.0 else 0
    assert sparse.dispatch_count() == before[1] + sparse_legs


@pytest.mark.parametrize("flt", [None, "one_pct"])
@pytest.mark.parametrize("group_by", [None, "tag"])
def test_aggregate_matches_jax(cols, flt, group_by):
    _, _, jcol, tcol = cols
    f = FILTERS.get(flt)
    props = {"bucket": "numeric", "tag": "text", "body": None}
    for tenant in TENANTS:
        jres = jcol.aggregate(props, flt=_jflt(f), group_by=group_by,
                              tenant=tenant, top_occurrences_limit=3)
        tres = tcol.aggregate(props, flt=f, group_by=group_by,
                              tenant=tenant, top_occurrences_limit=3)
        assert tres == jres
        assert tres["meta"]["count"] > 0


def _explore(mod, db, **kw):
    hybrid = kw.pop("hybrid", None)
    params = mod.QueryParams(collection="Msmarco", **kw)
    if hybrid is not None:
        params.hybrid = mod.HybridParams(**hybrid)
    return mod.Explorer(db).get(params)


EXPLORER_CASES = {
    "near_vector": dict(near_vector=_qvec(3), limit=5, offset=2),
    "bm25_sort": dict(bm25_query="w1 w2", limit=8,
                      sort=[("bucket", "asc")]),
    "bm25_autocut": dict(bm25_query="w0 w3", limit=20, autocut=1),
    "hybrid_filtered": dict(hybrid=dict(query="w1 w7", vector=_qvec(5),
                                        alpha=0.5), limit=10,
                            filters=FILTERS["near_half"]),
    "hybrid_ranked_groupby": dict(
        hybrid=dict(query="w2 w5", vector=_qvec(6), alpha=0.3,
                    fusion="rankedFusion"), limit=20,
        group_by=("tag", 3, 2)),
    "filtered_fetch_sort": dict(filters=FILTERS["one_pct"],
                                sort=[("bucket", "desc"), ("id", "asc")]),
}


@pytest.mark.parametrize("case", sorted(EXPLORER_CASES))
def test_explorer_get_matches_jax(cols, case):
    jdb, tdb, _, _ = cols
    kw = dict(EXPLORER_CASES[case], tenant="t0")
    group = kw.pop("group_by", None)
    flt = kw.pop("filters", None)
    jkw, tkw = dict(kw), dict(kw)
    if flt is not None:
        jkw["filters"], tkw["filters"] = _jflt(flt), flt
    if group is not None:
        jkw["group_by"] = jexplorer.GroupByParams(*group)
        tkw["group_by"] = explorer.GroupByParams(*group)
    jr = _explore(jexplorer, jdb, **jkw)
    tr = _explore(explorer, tdb, **tkw)
    if group is not None:
        assert [g.value for g in tr.groups] == [g.value for g in jr.groups]
        assert tr.groups
        for jg, tg in zip(jr.groups, tr.groups):
            assert_pages(jg.objects, tg.objects)
        return
    key = "distance" if case == "near_vector" else "score"
    assert_pages([(h.object, getattr(h, key) or 0.0) for h in jr.hits],
                 [(h.object, getattr(h, key) or 0.0) for h in tr.hits])
    assert tr.hits


def test_explorer_aggregate_and_unported_steps(cols):
    jdb, tdb, _, _ = cols
    props = {"bucket": "numeric", "tag": "text"}
    jr = jexplorer.Explorer(jdb).aggregate("Msmarco", props, tenant="t1")
    tr = explorer.Explorer(tdb).aggregate("Msmarco", props, tenant="t1")
    assert tr == jr
    params = explorer.QueryParams(collection="Msmarco", tenant="t1",
                                  bm25_query="w1",
                                  rerank=explorer.RerankParams(query="w1"))
    with pytest.raises(NotImplementedError, match="slice 7"):
        explorer.Explorer(tdb).get(params)
    params = explorer.QueryParams(
        collection="Msmarco", tenant="t1", bm25_query="w1",
        generate=explorer.GenerateParams(single_prompt="{body}"))
    with pytest.raises(NotImplementedError, match="slice 9"):
        explorer.Explorer(tdb).get(params)


def test_one_fusion_dispatch_a_hybrid_request(cols):
    _, _, _, tcol = cols
    kw = dict(query="w0 w1", vector=_qvec(1), alpha=0.5, k=10, tenant="t0")
    tcol.hybrid_search(**kw)
    before = fusion.dispatch_count()
    assert tcol.hybrid_search(**kw)
    assert fusion.dispatch_count() == before + 1


@pytest.mark.parametrize("where", ["fusion", "sparse"])
def test_a_kernel_wrapper_that_raises_makes_hybrid_raise(cols, monkeypatch,
                                                         where):
    """No fallback: a failed launch of B6b (fusion) or B6a (the filtered
    sparse leg) raises through ``hybrid_search``."""
    _, _, _, tcol = cols

    def boom(*args, **kw):
        raise RuntimeError("launch failed")

    if where == "fusion":
        monkeypatch.setattr(fusion, "relative_score_fusion_topk", boom)
        flt = None
    else:
        monkeypatch.setattr(sparse, "sparse_score_topk", boom)
        flt = FILTERS["near_half"]
    with pytest.raises(RuntimeError, match="launch failed"):
        tcol.hybrid_search(query="w0 w1", vector=_qvec(1), alpha=0.5, k=10,
                           tenant="t0", flt=flt)


def _answers(col, flt_of):
    out = []
    for i, q in enumerate(QUERIES[:3]):
        t = TENANTS[i % 2]
        out.append(col.bm25_search(q, 10, tenant=t))
        out.append(col.bm25_search(q, 10, tenant=t, device_scoring=True,
                                   flt=flt_of(FILTERS["near_half"])))
        out.append(col.hybrid_search(query=q, vector=_qvec(i), alpha=0.5,
                                     k=10, tenant=t,
                                     flt=flt_of(FILTERS["one_pct"])))
    aggs = [col.aggregate({"bucket": "numeric", "tag": "text"}, tenant=t)
            for t in TENANTS]
    return out, aggs


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_text_collection_opens_in_the_other_package(tmp_path, writer):
    """A multi-tenant text collection written by one package (WAL,
    objects, the RAM inverted snapshot; SQ codes rebuilt from the objects)
    opens in the other and answers bm25, hybrid and aggregate alike."""
    path = str(tmp_path / "db")
    jflt = _jflt
    if writer == "jax":
        wdb, cls, wflt = JaxDB(path), JaxObject, jflt
        wcol = wdb.create_collection(_cfg(jconfig, "Msmarco"))
    else:
        wdb, cls = DB(path, device="cpu"), StorageObject
        wcol, wflt = wdb.create_collection(_cfg(config, "Msmarco")), None
    _fill(wcol, cls)
    want = _answers(wcol, wflt or (lambda f: f))
    wdb.close()
    if writer == "jax":
        rdb = DB(path, device="cpu")
        got = _answers(rdb.get_collection("Msmarco"), lambda f: f)
    else:
        rdb = JaxDB(path)
        got = _answers(rdb.get_collection("Msmarco"), jflt)
    try:
        for w, g in zip(want[0], got[0]):
            assert_pages(w, g)
        assert got[1] == want[1]
        assert any(want[0])
    finally:
        rdb.close()
