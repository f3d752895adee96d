"""Parity: the port's database path (``DB`` -> ``Collection`` -> ``Shard`` ->
``FlatIndex``) against the JAX package's on the same seeded objects, on the
CPU, plus the query-coalescing dispatcher.

- Exact route (``precision="fp32"``, or bf16 with ``flat_approx_recall=0``):
  the same uuids in the same order, distances at ``test_torch_flat.py``'s
  ``TOL``; unfiltered, filtered, after update and delete, after close and
  reopen (from a checkpoint, and by delta-log replay after a crash).
- bf16 approximate route (the fused-kernel route, plain version on the
  CPU): recall@10 against the exact float32 answer >= 0.95, the bound
  ``BASELINE.json`` and slice 1 state.
- State carried across: a DB directory written by one package opens in the
  other and answers the same searches.
- A writer and searchers at once; every unported route raises
  ``NotImplementedError`` naming its ROADMAP queue-A slice.
"""

import os
import sys
import threading

import numpy as np
import pytest
import torch

from weaviate_tpu.core.db import DB as JaxDB
from weaviate_tpu.index import dispatch as jdispatch
from weaviate_tpu.inverted.filters import Filter as JFilter
from weaviate_tpu.schema import config as jconfig
from weaviate_tpu.storage.objects import StorageObject as JaxObject
from weaviate_tpu_torch.core.db import DB
from weaviate_tpu_torch.core.shard import build_vector_index
from weaviate_tpu_torch.index import dispatch
from weaviate_tpu_torch.inverted.filters import Where
from weaviate_tpu_torch.ops import fused_flat
from weaviate_tpu_torch.schema import config
from weaviate_tpu_torch.storage.objects import StorageObject

TOL = {"fp32": dict(rtol=1e-5, atol=1e-4), "bf16": dict(rtol=1e-4, atol=1e-3)}
N, DIMS, K = 2000, 64, 10
WORDS = [f"w{i}" for i in range(200)]

FILTERS = [
    Where.eq("bucket", 7),
    Where.lt("bucket", 30),
    Where.and_(Where.gte("bucket", 20), Where.like("text", "*w1*")),
    Where.or_(Where.eq("bucket", 3), Where.eq("bucket", 99)),
]


def _cfg(mod, precision="fp32", approx=0.0, shards=1, distance="l2-squared"):
    P, T = mod.Property, mod.DataType
    return mod.CollectionConfig(
        name="Doc",
        properties=[P("bucket", T.INT), P("text", T.TEXT)],
        vector_config=mod.FlatIndexConfig(
            distance=distance, precision=precision,
            flat_approx_recall=approx, initial_capacity=512),
        sharding=mod.ShardingConfig(desired_count=shards))


def _records(seed, n=N, start=0):
    rng = np.random.default_rng(seed)
    vecs = rng.standard_normal((n, DIMS), dtype=np.float32)
    out = []
    for i in range(n):
        u = rng.bytes(16).hex()
        out.append(dict(
            uuid=f"{u[:8]}-{u[8:12]}-4{u[13:16]}-8{u[17:20]}-{u[20:32]}",
            collection="Doc", vector=vecs[i],
            properties={"bucket": (start + i) % 100,
                        "text": " ".join(rng.choice(WORDS, 8))},
            creation_time_ms=1, update_time_ms=1))
    return out


def _put(col, cls, recs, batch=500):
    for s in range(0, len(recs), batch):
        col.put_batch([cls(**dict(r, properties=dict(r["properties"])))
                       for r in recs[s:s + batch]])


def _answers(col, queries, flt=None, k=K):
    rows = col.vector_search_batch(queries, k, flt=flt)
    return ([[o.uuid for o, _ in row] for row in rows],
            [[d for _, d in row] for row in rows])


def _jflt(flt):
    return None if flt is None else JFilter.from_dict(flt.to_dict())


def _same(jcol, tcol, queries, precision, flt=None):
    ju, jd = _answers(jcol, queries, _jflt(flt))
    tu, td = _answers(tcol, queries, flt)
    assert tu == ju
    assert any(ju)
    for a, b in zip(jd, td):
        np.testing.assert_allclose(b, a, **TOL[precision])
    return tu


def _queries(recs, seed=9, b=8):
    rng = np.random.default_rng(seed)
    base = np.stack([recs[i]["vector"] for i in range(0, 40 * b, 40)])
    return base + 0.1 * rng.standard_normal(base.shape, dtype=np.float32)


@pytest.fixture
def dbs(tmp_path):
    opened = []

    def make(mod, name, **kw):
        if mod == "jax":
            db = JaxDB(str(tmp_path / name))
        else:
            db = DB(str(tmp_path / name), device="cpu", **kw)
        opened.append(db)
        return db

    yield make
    for db in opened:
        try:
            db.close()
        except Exception:  # a test may have closed it already
            pass


@pytest.mark.parametrize("shards", [1, 2])
@pytest.mark.parametrize("precision,approx", [("fp32", -1.0), ("fp32", 0.5),
                                              ("bf16", 0.0)])
def test_exact_route_filters_updates_deletes(dbs, shards, precision, approx):
    jdb, tdb = dbs("jax", "j"), dbs("torch", "t")
    jcol = jdb.create_collection(_cfg(jconfig, precision, approx, shards))
    tcol = tdb.create_collection(_cfg(config, precision, approx, shards))
    recs = _records(0)
    _put(jcol, JaxObject, recs)
    _put(tcol, StorageObject, recs)
    q = _queries(recs)
    assert tcol.count() == jcol.count() == N
    _same(jcol, tcol, q, precision)
    for flt in FILTERS:
        got = _same(jcol, tcol, q, precision, flt)
        if flt is FILTERS[0]:
            for row in got:
                assert all(tcol.get(u).properties["bucket"] == 7
                           for u in row)
    # single-query wrapper
    j1 = jcol.vector_search(q[0], k=5)
    t1 = tcol.vector_search(q[0], k=5)
    assert [o.uuid for o, _ in t1] == [o.uuid for o, _ in j1]
    # delete 10%, update 5% (new vectors and buckets), then search again
    gone = [r["uuid"] for r in recs[::10]]
    assert tcol.delete(gone) == jcol.delete(gone) == len(gone)
    upd = _records(5, n=100)
    for r, old in zip(upd, recs[3::20]):
        r["uuid"] = old["uuid"]
    _put(jcol, JaxObject, upd, batch=100)
    _put(tcol, StorageObject, upd, batch=100)
    assert tcol.count() == jcol.count()
    for flt in (None, *FILTERS):
        got = _same(jcol, tcol, q, precision, flt)
        assert not set(gone) & {u for row in got for u in row}
    assert tcol.get(upd[0]["uuid"]).properties == upd[0]["properties"]
    assert tcol.get(gone[0]) is None


def test_bf16_approx_route_recall_and_kernel_route(dbs, monkeypatch):
    calls = []
    real = fused_flat.fused_flat_topk

    def spy(*a, **kw):
        calls.append(a[1].device.type)
        return real(*a, **kw)

    monkeypatch.setattr(fused_flat, "fused_flat_topk", spy)
    tdb = dbs("torch", "t")
    tcol = tdb.create_collection(_cfg(config, "bf16", 0.99, shards=2))
    recs = _records(1)
    _put(tcol, StorageObject, recs)
    tcol.delete([r["uuid"] for r in recs[::50]])
    q = _queries(recs, b=16)
    got, _ = _answers(tcol, q)
    assert calls == ["cpu", "cpu"]  # one fused scan per shard
    live = [i for i in range(N) if i % 50]
    corpus = np.stack([recs[i]["vector"] for i in live]).astype(np.float64)
    d = ((q[:, None, :].astype(np.float64) - corpus[None]) ** 2).sum(-1)
    truth = np.argsort(d, axis=1, kind="stable")[:, :K]
    uuids = np.array([recs[i]["uuid"] for i in live])
    rec = np.mean([len(set(got[b]) & set(uuids[truth[b]])) / K
                   for b in range(len(q))])
    assert rec >= 0.95
    # the filtered query keeps to its filter at the same bound
    flt = Where.eq("bucket", 7)
    got, _ = _answers(tcol, q, flt)
    allowed = np.array([recs[i]["properties"]["bucket"] == 7 for i in live])
    d_f = np.where(allowed[None], d, np.inf)
    truth_f = np.argsort(d_f, axis=1, kind="stable")[:, :K]
    rec_f = np.mean([len(set(got[b]) & set(uuids[truth_f[b]])) / K
                     for b in range(len(q))])
    assert rec_f >= 0.95
    assert all(tcol.get(u).properties["bucket"] == 7 for row in got
               for u in row)


def _crash(db):
    """Durable writes without a checkpoint: flush every shard's delta log
    and LSM store, stop the background cycles, and abandon the DB."""
    db.flush()
    db.cycles.stop()


@pytest.mark.parametrize("how", ["close", "crash"])
def test_reopen_from_checkpoint_and_by_delta_replay(dbs, how):
    jdb, tdb = dbs("jax", "j"), dbs("torch", "t")
    jcol = jdb.create_collection(_cfg(jconfig, shards=2))
    tcol = tdb.create_collection(_cfg(config, shards=2))
    recs = _records(2)
    _put(jcol, JaxObject, recs[:1500])
    _put(tcol, StorageObject, recs[:1500])
    tdb.close()
    tdb = dbs("torch", "t")  # reopened: from the checkpoint close wrote
    tcol = tdb.get_collection("Doc")
    shards = list(tcol._shards.values())
    assert [s.recovered_from for s in shards] == ["checkpoint"] * 2
    # writes past the checkpoint: adds, an update, deletes
    more = recs[1500:] + [dict(recs[7], vector=recs[8]["vector"])]
    gone = [r["uuid"] for r in recs[::13]]
    for col, cls in ((jcol, JaxObject), (tcol, StorageObject)):
        _put(col, cls, more)
        col.delete(gone)
    q = _queries(recs)
    before = _answers(tcol, q, FILTERS[1])
    if how == "close":
        tdb.close()
    else:
        _crash(tdb)
    tdb = dbs("torch", "t")
    tcol = tdb.get_collection("Doc")
    assert [s.recovered_from for s in tcol._shards.values()] == \
        ["checkpoint"] * 2
    assert tcol.count() == jcol.count()
    assert _answers(tcol, q, FILTERS[1]) == before
    for flt in (None, *FILTERS):
        _same(jcol, tcol, q, "fp32", flt)


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("how", ["close", "crash"])
def test_db_directory_opens_in_the_other_package(dbs, tmp_path, writer, how):
    """State carried across: the one package writes (and checkpoints, or
    crashes leaving a delta log to replay), the other opens the directory
    and answers the same searches."""
    recs = _records(3)
    cls = JaxObject if writer == "jax" else StorageObject
    db = dbs(writer, "shared")
    col = db.create_collection(_cfg(jconfig if writer == "jax" else config,
                                    shards=2))
    _put(col, cls, recs[:1200])
    if how == "crash":
        db.close()
        db = dbs(writer, "shared")
        col = db.get_collection("Doc")
    _put(col, cls, recs[1200:])
    col.delete([r["uuid"] for r in recs[::11]])
    q = _queries(recs)
    want = {flt_i: _answers(col, q, (None, *FILTERS)[flt_i]
                            if writer == "torch" else
                            _jflt((None, *FILTERS)[flt_i]))
            for flt_i in range(len(FILTERS) + 1)}
    if how == "close":
        db.close()
    else:
        _crash(db)
    reader = "torch" if writer == "jax" else "jax"
    db2 = dbs(reader, "shared")
    col2 = db2.get_collection("Doc")
    assert col2.count() == N - len(recs[::11])
    for flt_i, (wu, wd) in want.items():
        flt = (None, *FILTERS)[flt_i]
        gu, gd = _answers(col2, q, flt if reader == "torch" else _jflt(flt))
        assert gu == wu
        for a, b in zip(wd, gd):
            np.testing.assert_allclose(b, a, **TOL["fp32"])
    o = col2.get(recs[5]["uuid"])
    assert o.properties == recs[5]["properties"]
    np.testing.assert_array_equal(o.vector, recs[5]["vector"])


def test_writer_and_searchers_at_once(dbs):
    """Searchers run lock-free on the store's snapshot while put_batch and
    delete swap in new tensors: every answer must be a consistent one (each
    distance is its object's exact distance to its query row, rows sorted,
    no deleted object) while the writer runs."""
    tdb = dbs("torch", "t")
    tcol = tdb.create_collection(_cfg(config, shards=2))
    recs = _records(4)
    _put(tcol, StorageObject, recs[:500])
    q = _queries(recs[:500], b=4)
    errors, seen = [], []
    done = threading.Event()

    def searcher():
        try:
            while not done.is_set():
                rows = tcol.vector_search_batch(q, K)
                for qi, row in enumerate(rows):
                    d = [dist for _, dist in row]
                    assert d == sorted(d) and len(row) == K
                    for o, dist in row:
                        ref = float(((o.vector - q[qi]) ** 2).sum())
                        assert abs(dist - ref) <= 1e-4 + 1e-5 * ref
                seen.append(len(rows))
        except Exception as e:  # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=searcher)
               for _ in range(os.cpu_count() + 1)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for s in range(500, N, 100):
            _put(tcol, StorageObject, recs[s:s + 100], batch=100)
            tcol.delete([recs[s - 450]["uuid"]])
    finally:
        done.set()
        for t in threads:
            t.join(timeout=60)
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[0]
    assert len(seen) > len(threads)
    # the final state answers as a JAX DB fed the same writes serially
    jdb = dbs("jax", "j")
    jcol = jdb.create_collection(_cfg(jconfig, shards=2))
    _put(jcol, JaxObject, recs[:500])
    for s in range(500, N, 100):
        _put(jcol, JaxObject, recs[s:s + 100], batch=100)
        jcol.delete([recs[s - 450]["uuid"]])
    qq = _queries(recs)
    _same(jcol, tcol, qq, "fp32")


# -- device -----------------------------------------------------------------


def test_device_is_passed_down_and_cuda_is_the_default(dbs, tmp_path,
                                                       monkeypatch):
    tdb = dbs("torch", "t")
    tcol = tdb.create_collection(_cfg(config, shards=2))
    _put(tcol, StorageObject, _records(6, n=50))
    for s in tcol._shards.values():
        assert s.device == torch.device("cpu")
        assert s.filter_planes.device == torch.device("cpu")
        corpus, _, _ = s.vector_index().store.snapshot()
        assert corpus.device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DB(str(tmp_path / "nocard"))


def test_resident_plane_feeds_flat_search_as_host_mask(dbs):
    """A declared hot predicate becomes a resident plane; the flat index
    does not take planes, so the shard hands it the plane's host bitmap."""
    tdb = dbs("torch", "t")
    cfg = _cfg(config)
    cfg.resident_filters = [FILTERS[0].to_dict()]
    tcol = tdb.create_collection(cfg)
    jdb = dbs("jax", "j")
    jcfg = _cfg(jconfig)
    jcfg.resident_filters = [FILTERS[0].to_dict()]
    jcol = jdb.create_collection(jcfg)
    recs = _records(7)
    _put(tcol, StorageObject, recs)
    _put(jcol, JaxObject, recs)
    q = _queries(recs)
    _same(jcol, tcol, q, "fp32", FILTERS[0])
    shard = next(iter(tcol._shards.values()))
    plane = shard.filter_planes.lookup(FILTERS[0])
    assert plane is not None and plane.hits >= 2
    assert plane.count() == N // 100


# -- unported routes --------------------------------------------------------


def _mt_cfg():
    cfg = _cfg(config)
    cfg.multi_tenancy = config.MultiTenancyConfig(enabled=True)
    cfg.name = "Tenants"
    return cfg


UNPORTED = {
    "multi_target": (lambda col, db: col.multi_target_search(
        {"a": np.zeros(DIMS), "b": np.zeros(DIMS)}), "slice 7"),
    "shard_multi_target": (lambda col, db: next(iter(
        col._shards.values())).multi_target_search({}, 1, "minimum"),
        "slice 7"),
    "qos": (lambda col, db: db.qos, "slice 8"),
    "vectorizer": (lambda col, db: col.put_batch([StorageObject(
        uuid="", collection="Doc", properties={"bucket": 1})]), "slice 9"),
    "frozen_tenant": (lambda col, db: _freeze(db), "slice 9"),
    "multivector_index": (lambda col, db: build_vector_index(
        DIMS, config.MultiVectorIndexConfig(), device="cpu"), "slice 7"),
    "hfresh_index": (lambda col, db: build_vector_index(
        DIMS, config.HFreshIndexConfig(), device="cpu"), "slice 7"),
    "disk_raw_tier": (lambda col, db: build_vector_index(
        DIMS, config.FlatIndexConfig(raw_tier="disk16"), device="cpu"),
        "slice 9"),
    "rerank_module": (lambda col, db: config.RerankModuleConfig().validate(),
                      "slice 7"),
}


def _dynamic_filtered_beam(col, db):
    """A dynamic index past its cutover, with the fused walk on, asked a
    filtered query the planner sends to the beam (slice 5): the same graph
    and the same answer as the JAX ``DynamicIndex``, in one walk each."""
    from weaviate_tpu.core.shard import build_vector_index as jbuild
    from weaviate_tpu.ops import device_beam as jbeam
    from weaviate_tpu_torch.monitoring.metrics import PLANNER_PLANS
    from weaviate_tpu_torch.ops import device_beam as tbeam
    from weaviate_tpu_torch.query.planner import PLAN_BEAM

    def dynamic(mod, build, **kw):
        return build(DIMS, mod.DynamicIndexConfig(
            distance="l2-squared", threshold=10, cutover_background=False,
            hnsw={"device_beam": True, "ef": 16, "max_connections": 4,
                  "flat_search_cutoff": 0}), **kw)

    vecs = np.random.default_rng(1).standard_normal((200, DIMS)).astype(
        np.float32)
    jidx = dynamic(jconfig, jbuild)
    tidx = dynamic(config, build_vector_index, device="cpu")
    for idx in (jidx, tidx):
        idx.add_batch(np.arange(200), vecs)
        assert idx.upgraded
    ja, ta = jidx.inner.graph.to_arrays(), tidx.inner.graph.to_arrays()
    for key in ja:
        np.testing.assert_array_equal(np.asarray(ta[key]), np.asarray(ja[key]))
    allow = np.arange(200) % 5 < 3
    before = (jbeam.dispatch_count(), tbeam.dispatch_count(),
              PLANNER_PLANS.value(plan=PLAN_BEAM))
    jr = jidx.search(vecs[:8], 5, allow_list=allow)
    tr = tidx.search(vecs[:8], 5, allow_list=allow)
    assert (jbeam.dispatch_count() - before[0],
            tbeam.dispatch_count() - before[1]) == (1, 1)
    assert PLANNER_PLANS.value(plan=PLAN_BEAM) == before[2] + 1
    np.testing.assert_array_equal(tr.ids, jr.ids)
    np.testing.assert_allclose(tr.dists, jr.dists, rtol=1e-5, atol=1e-5)
    assert allow[tr.ids].all()


def _quantized_index(kind, quantizer="sq"):
    """A quantized index (slice 4a: SQ; slice 4b: PQ, RQ) from each
    package's ``build_vector_index``: the same ids and distances as JAX,
    after a delete and under a filter."""
    from weaviate_tpu.core.shard import build_vector_index as jbuild

    def route(col, db):
        def cfg(mod):
            quant = {"sq": mod.SQConfig, "pq": mod.PQConfig,
                     "rq": mod.RQConfig}[quantizer](rescore_limit=40)
            if kind == "hnsw":
                return mod.HNSWIndexConfig(
                    distance="l2-squared", quantizer=quant, ef=32,
                    ef_construction=48, max_connections=8,
                    flat_search_cutoff=0, device_beam=True)
            return mod.FlatIndexConfig(distance="l2-squared", quantizer=quant)

        vecs = np.random.default_rng(2).standard_normal((600, DIMS)).astype(
            np.float32)
        jidx, tidx = jbuild(DIMS, cfg(jconfig)), build_vector_index(
            DIMS, cfg(config), device="cpu")
        allow = np.arange(600) % 4 != 0
        for idx in (jidx, tidx):
            idx.add_batch(np.arange(600), vecs)
            idx.delete(np.arange(0, 600, 7))
        assert tidx.backend.quantized and tidx.backend.quantizer.fitted
        for al in (None, allow):
            jr = jidx.search(vecs[:8] + 0.05, 5, allow_list=al)
            tr = tidx.search(vecs[:8] + 0.05, 5, allow_list=al)
            np.testing.assert_array_equal(tr.ids, jr.ids)
            np.testing.assert_allclose(tr.dists, jr.dists, rtol=1e-5,
                                       atol=1e-4)

    return route


def _keyword_route(name):
    """Slice 6a: bm25 (WAND and device-scored), hybrid and aggregate on the
    flat collection of the raise cases, the same answers as the JAX
    package's."""
    def route(col, db):
        from weaviate_tpu.core.db import DB as JDB

        jdb = JDB(os.path.join(os.path.dirname(db.root), "jax_" + name))
        try:
            jcol = jdb.create_collection(_cfg(jconfig))
            _put(jcol, JaxObject, _records(8, n=20))
            q = _records(8, n=20)[3]["vector"]
            calls = {
                "bm25": lambda c, f: [
                    (o.uuid, s) for ds in (False, True)
                    for o, s in c.bm25_search("w1 w2 w3", 5,
                                              device_scoring=ds)],
                "hybrid": lambda c, f: [
                    (o.uuid, s) for fu in ("relativeScoreFusion",
                                           "rankedFusion")
                    for o, s in c.hybrid_search("w1 w3", q, alpha=0.5, k=5,
                                                fusion=fu, flt=f)],
                "aggregate": lambda c, f: c.aggregate(
                    {"bucket": None, "text": "text"}, flt=f),
            }[name]
            want = calls(jcol, _jflt(FILTERS[1]))
            got = calls(col, FILTERS[1])
            assert got
            if got != want:  # scores equal to float32 rounding
                _close(got, want)
        finally:
            jdb.close()

    return route


def _close(got, want):
    assert [u for u, _ in got] == [u for u, _ in want]
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want],
                               rtol=1e-5)


# routes of this list's slices that are ported since: each answers as the
# JAX package does
PORTED = {
    "bm25": _keyword_route("bm25"),
    "hybrid": _keyword_route("hybrid"),
    "aggregate": _keyword_route("aggregate"),
    "dynamic_index": _dynamic_filtered_beam,
    "hnsw_index": _quantized_index("hnsw"),
    "quantizer": _quantized_index("flat"),
    "pq_hnsw_index": _quantized_index("hnsw", "pq"),
    "rq_quantizer": _quantized_index("flat", "rq"),
}


def _freeze(db):
    col = db.create_collection(_mt_cfg())
    col.add_tenant("t1")
    col.set_tenant_status("t1", "COLD")
    col.set_tenant_status("t1", "HOT")
    col.set_tenant_status("t1", "FROZEN")


@pytest.mark.parametrize("name", sorted(UNPORTED.keys() | PORTED.keys()))
def test_unported_route_raises(dbs, name):
    tdb = dbs("torch", "t")
    cfg = _cfg(config)
    if name == "vectorizer":
        cfg.vectorizer = "text2vec-hash"
    tcol = tdb.create_collection(cfg)
    _put(tcol, StorageObject, _records(8, n=20))
    if name in PORTED:
        PORTED[name](tcol, tdb)
        return
    fn, where = UNPORTED[name]
    with pytest.raises(NotImplementedError, match=where):
        fn(tcol, tdb)


@pytest.mark.parametrize("kw,env,where", [
    (dict(modules=object()), {}, "slice 9"),
    (dict(tiering_budget_bytes=1 << 20), {}, "slice 9"),
    ({}, {"WEAVIATE_TPU_HBM_BUDGET_BYTES": "4096"}, "slice 9"),
    ({}, {"USAGE_S3_BUCKET": "bucket"}, "slice 9"),
])
def test_unported_db_options_raise(tmp_path, monkeypatch, kw, env, where):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(NotImplementedError, match=where):
        DB(str(tmp_path / "db"), device="cpu", **kw)


def test_unported_index_types_refused_at_create_and_open(dbs, tmp_path):
    tdb = dbs("torch", "t")
    for cfg in (config.MultiVectorIndexConfig(), config.HFreshIndexConfig()):
        c = _cfg(config)
        c.vector_config = cfg
        with pytest.raises(ValueError, match="slice 7"):
            tdb.create_collection(c)
    # a JAX-written hfresh collection: the port refuses it at open
    jdb = dbs("jax", "hfresh")
    c = _cfg(jconfig)
    c.vector_config = jconfig.HFreshIndexConfig(distance="l2-squared")
    jcol = jdb.create_collection(c)
    _put(jcol, JaxObject, _records(10, n=30))
    jdb.close()
    with pytest.raises(NotImplementedError, match="slice 7"):
        DB(str(tmp_path / "hfresh"), device="cpu")


# -- the query-coalescing dispatcher ----------------------------------------


class _Plane:
    def __init__(self, plane_id, version):
        self.plane_id, self.version = plane_id, version


def _req_specs():
    """(k, allow, group token, tier key) for a pending queue that exercises
    every grouping rule: k, ad-hoc mask content, plane identity, dispatch
    group and residency tier."""
    m1 = np.arange(64) % 2 == 0
    return [
        (10, None, None, None), (10, None, None, None), (5, None, None, None),
        (10, m1, None, None), (10, m1.copy(), None, None),
        (10, ~m1, None, None), (10, _Plane(7, 1), None, None),
        (10, _Plane(7, 1), None, None), (10, _Plane(7, 2), None, None),
        (10, None, ("ingest",), None), (10, None, ("ingest",), None),
        (10, None, None, ("epoch", 1)), (10, None, None, None),
    ]


@pytest.mark.parametrize("max_batch", [2, 64])
def test_dispatcher_groups_like_jax(max_batch):
    groups = {}
    for name, mod in (("jax", jdispatch), ("torch", dispatch)):
        disp = mod.CoalescingDispatcher(lambda q, k, a: None,
                                        max_batch=max_batch)
        reqs = []
        for i, (k, allow, token, tier) in enumerate(_req_specs()):
            q = np.full((1 + i % 2, 4), float(i), np.float32)
            with mod.dispatch_group(token):
                reqs.append(mod._Req(q, k, allow, tier_key=tier))
        disp._pending = list(reqs)
        out = []
        while True:
            g = disp._take_group()
            if not g:
                break
            out.append([reqs.index(r) for r in g])
        groups[name] = out
    assert groups["torch"] == groups["jax"]
    assert len(groups["torch"]) < len(_req_specs())


def test_dispatcher_coalesces_concurrent_searches_and_splits_rows():
    calls = []
    gate = threading.Event()

    def run_batch(q, k, allow):
        gate.wait(timeout=10)
        calls.append(q.shape[0])
        ids = np.tile(np.arange(k, dtype=np.int64), (q.shape[0], 1))
        return ids, np.repeat(q.sum(1)[:, None], k, 1).astype(np.float32)

    disp = dispatch.CoalescingDispatcher(run_batch)
    results, errs = {}, []

    def worker(i):
        try:
            with dispatch.dispatch_group(("search",)):
                assert dispatch.current_dispatch_group() == ("search",)
                results[i] = disp.search(
                    np.full((1, 4), float(i), np.float32), 3)
        except Exception as e:  # surfaced below
            errs.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(24)]
    for t in threads:
        t.start()
    for _ in range(5000):
        with disp._lock:
            if len(disp._pending) + len(results) >= 23:
                break
        threading.Event().wait(0.001)
    gate.set()
    for t in threads:
        t.join()
    assert not errs
    for i, (ids, d) in results.items():
        assert ids.shape == (1, 3)
        np.testing.assert_allclose(d[0], 4.0 * i)
    assert sum(calls) == 24 and len(calls) < 24
    assert dispatch.current_dispatch_group() is None


def test_dispatcher_propagates_errors_and_stays_usable():
    def run_batch(q, k, allow):
        raise RuntimeError("boom")

    disp = dispatch.CoalescingDispatcher(run_batch)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="boom"):
            disp.search(np.zeros((1, 4), np.float32), 3)


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("kind", ["bq_flat", "sq_hnsw", "pq_hnsw", "rq_flat"])
def test_quantized_collection_opens_in_the_other_package(dbs, writer, kind):
    """A collection with a quantized vector index (codes not checkpointed:
    rebuilt from the objects on open; an HNSW graph from graph.npz and the
    quantizer from quantizer.msgpack) written by one package opens in the
    other with the same uuids; deletes after the reopen never come back.
    (Deletes before a close are left out: both packages rebuild codes for
    live objects only, so a reopened quantized graph walks its tombstones
    with empty codes and answers differently from before the close, in
    either package; ROADMAP queue C.)"""
    recs = _records(4, n=1200)
    mod = jconfig if writer == "jax" else config
    cfg = _cfg(mod)
    if kind.endswith("_flat"):
        quant = (mod.BQConfig if kind == "bq_flat" else mod.RQConfig)(
            rescore_limit=40)
        cfg.vector_config = mod.FlatIndexConfig(distance="cosine",
                                                quantizer=quant)
    else:
        quant = (mod.SQConfig if kind == "sq_hnsw" else mod.PQConfig)(
            rescore_limit=40)
        cfg.vector_config = mod.HNSWIndexConfig(
            distance="cosine", quantizer=quant,
            ef=32, ef_construction=48, max_connections=8,
            flat_search_cutoff=0, device_beam=True)
    db = dbs(writer, "q")
    col = db.create_collection(cfg)
    _put(col, JaxObject if writer == "jax" else StorageObject, recs)
    q = _queries(recs, b=6)
    want = [_answers(col, q, f if writer == "torch" else _jflt(f))[0]
            for f in (None, FILTERS[1])]
    db.close()
    reader = "torch" if writer == "jax" else "jax"
    col2 = dbs(reader, "q").get_collection("Doc")
    assert col2.count() == 1200
    got = [_answers(col2, q, f if reader == "torch" else _jflt(f))[0]
           for f in (None, FILTERS[1])]
    assert got == want and any(want[0])
    gone = [u for row in want[0] for u in row[:2]]
    col2.delete(gone)
    after = _answers(col2, q, None if reader == "torch" else _jflt(None))[0]
    assert not set(gone) & {u for row in after for u in row}
