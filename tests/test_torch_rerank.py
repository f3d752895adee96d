"""The rerank tier (port slice 7a) against the JAX package on the CPU.

- Both device rerank modules' ``score`` (torch) and ``host_score`` (numpy)
  against JAX's on seeded token sets with masked query tokens, partly and
  fully masked candidates: within 1e-5 (float32 sums of the same products
  in another order).
- ``rerank_topk_plain`` (kernel B7a's plain version) against JAX
  ``_rerank_stage`` with -1 pads and exact score ties: ids equal, negated
  scores within 1e-5.
- ``HNSWIndex.search(rerank=RerankRequest(...))`` against the JAX index on
  the same graph, raw and SQ rows, unfiltered and under a filter the
  planner sends to the filtered beam, in self mode and with explicit query
  tokens, and the host tiers picked by state (a demoted index, the exact
  plan of a 1% filter): ids equal, distances within 1e-5.
"""

import numpy as np
import pytest
import torch

from weaviate_tpu.index.hnsw import HNSWIndex as JaxHNSW
from weaviate_tpu.modules import device as jdev
from weaviate_tpu.ops import device_beam as jbeam
from weaviate_tpu.schema import config as jconfig
from weaviate_tpu_torch.index.hnsw import HNSWIndex
from weaviate_tpu_torch.modules import device as tdev
from weaviate_tpu_torch.ops import rerank as trerank
from weaviate_tpu_torch.schema import config

TOL = 1e-5
N, DIMS, TMAX = 320, 16, 4


def _tokens(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _modules(name):
    if name == "maxsim":
        return jdev.MaxSimRerank(), tdev.MaxSimRerank()
    return (jdev.LinearRerank(w_max=0.75, w_mean=0.5, bias=0.25),
            tdev.LinearRerank(w_max=0.75, w_mean=0.5, bias=0.25))


def _score_inputs(seed=0, b=3, tq=4, c=6, t=TMAX, d=DIMS):
    rng = np.random.default_rng(seed)
    q = _tokens(rng, (b, tq, d))
    qm = rng.random((b, tq)) < 0.7
    qm[:, 0] = True
    ct = _tokens(rng, (b, c, t, d))
    cm = rng.random((b, c, t)) < 0.6
    cm[:, 0] = False          # a fully masked candidate
    cm[:, 1] = True           # a full one
    return q, qm, ct, cm


@pytest.mark.parametrize("name", ["maxsim", "linear"])
def test_module_scores_match_jax(name):
    import jax.numpy as jnp

    jm, tm = _modules(name)
    q, qm, ct, cm = _score_inputs()
    want = np.asarray(jm.score(jnp.asarray(q), jnp.asarray(qm),
                               jnp.asarray(ct), jnp.asarray(cm)))
    got = tm.score(torch.from_numpy(q), torch.from_numpy(qm),
                   torch.from_numpy(ct), torch.from_numpy(cm)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tm.host_score(q, qm, ct, cm),
                               jm.host_score(q, qm, ct, cm), rtol=TOL,
                               atol=TOL)
    # the kernel's parameters are the module's
    kind, w_max, w_mean, bias = tm.kernel_params()
    assert kind == (0 if name == "maxsim" else 1)
    if name == "linear":
        assert (w_max, w_mean, bias) == (0.75, 0.5, 0.25)


def test_catalog_build_and_request_match_jax():
    assert sorted(tdev.device_reranker_catalog()) == sorted(
        jdev.device_reranker_catalog())
    with pytest.raises(KeyError):
        tdev.build_device_reranker("rerank-nope")
    with pytest.raises(TypeError):
        tdev.build_device_reranker("rerank-linear", {"w_maxx": 1.0})
    assert tdev.build_device_reranker(
        "rerank-linear", {"w_mean": 0.5}) == tdev.LinearRerank(w_mean=0.5)
    prov = tdev.DeviceRerankerProvider(tdev.MaxSimRerank)
    assert prov.meta() == {"name": "rerank-maxsim", "type": "device-rerank"}
    toks = _tokens(np.random.default_rng(1), (5, DIMS))
    jr = jdev.RerankRequest(jdev.MaxSimRerank(), toks)
    tr = tdev.RerankRequest(tdev.MaxSimRerank(), toks)
    assert tr.tq_pad == jr.tq_pad == 8
    assert tr.group_key[1:] == jr.group_key[1:]
    q = _tokens(np.random.default_rng(2), (3, DIMS))
    for a, b in zip(tr.batch_for(q)[1:], jr.batch_for(q)[1:]):
        np.testing.assert_array_equal(a, b)
    self_t, self_j = (tdev.RerankRequest(tdev.MaxSimRerank()),
                      jdev.RerankRequest(jdev.MaxSimRerank()))
    assert self_t.tq_pad == self_j.tq_pad == 1
    for a, b in zip(self_t.batch_for(q)[1:], self_j.batch_for(q)[1:]):
        np.testing.assert_array_equal(a, b)
    # validation follows JAX's
    config.RerankModuleConfig(module="rerank-linear",
                              params={"w_max": 2.0}).validate()
    for bad in (config.RerankModuleConfig(module="rerank-nope"),
                config.RerankModuleConfig(max_tokens=0),
                config.RerankModuleConfig(module="rerank-maxsim",
                                          params={"w": 1.0})):
        with pytest.raises(ValueError):
            bad.validate()
    with pytest.raises(ValueError, match="hnsw and multivector"):
        config.FlatIndexConfig(rerank=config.RerankModuleConfig()).validate()


@pytest.mark.parametrize("name", ["maxsim", "linear"])
@pytest.mark.parametrize("out_k", [1, 5, 12])
def test_rerank_topk_plain_matches_jax_rerank_stage(name, out_k):
    import jax.numpy as jnp

    jm, tm = _modules(name)
    rng = np.random.default_rng(3)
    n, b, c, tq = 40, 4, 12, 2
    tokens = _tokens(rng, (n, TMAX, DIMS))
    tmask = rng.random((n, TMAX)) < 0.7
    tmask[5] = False                      # a deleted row: no kept token
    tokens[7] = tokens[8]                 # twins: exact score ties
    tmask[7] = tmask[8]
    cand = rng.integers(0, n, (b, c)).astype(np.int32)
    cand[:, :3] = [5, 8, 7]
    cand[:, -2:] = -1                     # pads
    q = _tokens(rng, (b, tq, DIMS))
    qm = np.ones((b, tq), bool)
    qm[1, 1] = False
    ji, jd = jbeam._rerank_stage(
        jm, out_k, jnp.asarray(cand), jnp.asarray(tokens), jnp.asarray(tmask),
        jnp.asarray(q), jnp.asarray(qm))
    ti, td = trerank.rerank_topk_plain(
        torch.from_numpy(cand), torch.from_numpy(tokens),
        torch.from_numpy(tmask), torch.from_numpy(q), torch.from_numpy(qm),
        tm, out_k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=TOL,
                               atol=TOL)
    # the dispatcher takes the plain version for CPU tensors
    launches = trerank.rerank_topk_cuda.launches
    ri, _ = trerank.rerank_topk(
        torch.from_numpy(cand), torch.from_numpy(tokens),
        torch.from_numpy(tmask), torch.from_numpy(q), torch.from_numpy(qm),
        tm, out_k)
    np.testing.assert_array_equal(ri.numpy(), ti.numpy())
    assert trerank.rerank_topk_cuda.launches == launches


def test_rerank_topk_cuda_refuses_cpu_and_bad_shapes():
    """The kernel wrapper never runs on CPU tensors (the plain version
    does) and checks its arguments before any build."""
    tm = tdev.MaxSimRerank()
    cand = torch.zeros((2, 4), dtype=torch.int32)
    tokens = torch.zeros((8, 2, 4))
    tmask = torch.ones((8, 2), dtype=torch.bool)
    q = torch.zeros((2, 1, 4))
    qm = torch.ones((2, 1), dtype=torch.bool)
    with pytest.raises(ValueError, match="out_k"):
        trerank.rerank_topk_cuda(cand, tokens, tmask, q, qm, tm, 5)
    with pytest.raises(ValueError, match="tmask"):
        trerank.rerank_topk_cuda(cand, tokens, tmask[:, :1].contiguous(), q,
                                 qm, tm, 2)


def _hnsw_pair(quant: bool, module: str = "rerank-maxsim"):
    """The same HNSW index built by both packages (fused walk on, a rerank
    module configured), over N seeded rows."""
    def cfg(mod):
        kw = dict(distance="l2-squared", precision="fp32", ef=32,
                  ef_construction=48, max_connections=8, device_beam=True,
                  flat_search_cutoff=0,
                  rerank=mod.RerankModuleConfig(module=module,
                                                max_tokens=TMAX))
        if quant:
            kw["quantizer"] = mod.SQConfig(rescore_limit=24)
        return mod.HNSWIndexConfig(**kw)

    rng = np.random.default_rng(11)
    vecs = _tokens(rng, (N, DIMS))
    j = JaxHNSW(DIMS, cfg(jconfig))
    t = HNSWIndex(DIMS, cfg(config), device="cpu")
    for idx in (j, t):
        idx.add_batch(np.arange(N), vecs)
    ja, ta = j.graph.to_arrays(), t.graph.to_arrays()
    for key in ja:
        np.testing.assert_array_equal(np.asarray(ta[key]), np.asarray(ja[key]))
    return j, t, vecs


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module", params=["raw", "sq"])
def hnsw_pair(request):
    return _hnsw_pair(request.param == "sq")


def _same(jr, tr):
    np.testing.assert_array_equal(tr.ids, jr.ids)
    np.testing.assert_allclose(tr.dists, jr.dists, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("filtered", [False, True])
@pytest.mark.parametrize("mode", ["self", "tokens"])
def test_hnsw_rerank_search_matches_jax(hnsw_pair, filtered, mode):
    j, t, vecs = hnsw_pair
    rng = np.random.default_rng(21)
    if mode == "tokens":
        ids = np.arange(0, N, 3)
        sets = [_tokens(rng, (1 + i % TMAX, DIMS)) for i in range(len(ids))]
        j.set_tokens(ids, sets)
        t.set_tokens(ids, sets)
        qt = _tokens(rng, (3, DIMS))
        jreq = jdev.RerankRequest(jdev.MaxSimRerank(), qt)
        treq = tdev.RerankRequest(tdev.MaxSimRerank(), qt)
        q = vecs[:2] + 0.05
    else:
        jreq = jdev.RerankRequest(jdev.MaxSimRerank())
        treq = tdev.RerankRequest(tdev.MaxSimRerank())
        q = vecs[:6] + 0.05
    allow = None
    if filtered:
        allow = np.arange(N) % 2 == 0
    before = (jbeam.dispatch_count(), trerank.rerank_topk_cuda.launches)
    jr = j.search(q, 5, allow_list=allow, rerank=jreq)
    tr = t.search(q, 5, allow_list=allow, rerank=treq)
    _same(jr, tr)
    assert jbeam.dispatch_count() > before[0]
    assert trerank.rerank_topk_cuda.launches == before[1]  # CPU: plain
    if filtered:
        assert allow[tr.ids[tr.ids >= 0]].all()


def test_hnsw_rerank_host_tiers_match_jax():
    """The tiers the index picks by state: the exact plan of a 1% filter
    (flat triage) and a demoted index (warm tier) rerank on the host."""
    j, t, vecs = _hnsw_pair(False, "rerank-linear")
    q = vecs[:4] + 0.05
    jreq = jdev.RerankRequest(jdev.LinearRerank())
    treq = tdev.RerankRequest(tdev.LinearRerank())
    allow = np.zeros(N, bool)
    allow[::97] = True
    _same(j.search(q, 3, allow_list=allow, rerank=jreq),
          t.search(q, 3, allow_list=allow, rerank=treq))
    assert j.demote_device() > 0 and t.demote_device() > 0
    assert t._token_store.nbytes == 0
    _same(j.search(q, 5, rerank=jreq), t.search(q, 5, rerank=treq))
    t.promote_device()
    j.promote_device()
    _same(j.search(q, 5, rerank=jreq), t.search(q, 5, rerank=treq))


def test_hnsw_rerank_deletes_and_checkpoint(tmp_path):
    j, t, vecs = _hnsw_pair(False)
    gone = np.arange(0, N, 5)
    j.delete(gone)
    t.delete(gone)
    q = vecs[:5]
    jreq = jdev.RerankRequest(jdev.MaxSimRerank())
    treq = tdev.RerankRequest(tdev.MaxSimRerank())
    jr, tr = j.search(q, 5, rerank=jreq), t.search(q, 5, rerank=treq)
    _same(jr, tr)
    assert not np.isin(tr.ids, gone).any()
    # the token sidecar: the JAX index's file opens in the port
    path = str(tmp_path / "vec")
    j.save_vectors(path, {"seq": 3})
    t2 = HNSWIndex(DIMS, t.config, device="cpu")
    assert t2.load_vectors(path) == {"seq": 3}
    jt, jm = j._token_store.host_planes()
    tt, tm = t2._token_store.host_planes()
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(tm, jm)
    t.save_vectors(str(tmp_path / "t"), {"seq": 4})
    assert (tmp_path / "t.rrtok.npz").exists()
    # a JAX store's host planes as numpy build the same port store
    from weaviate_tpu_torch.interop import token_store_from_numpy

    ts = token_store_from_numpy(jt, jm, device="cpu")
    st, sm = ts.sync()
    np.testing.assert_array_equal(st.numpy(), jt)
    np.testing.assert_array_equal(sm.numpy(), jm)


def test_rerank_without_module_raises():
    idx = HNSWIndex(DIMS, config.HNSWIndexConfig(), device="cpu")
    idx.add_batch(np.arange(4), np.eye(4, DIMS, dtype=np.float32))
    with pytest.raises(ValueError, match="no rerank module"):
        idx.search(np.ones((1, DIMS), np.float32), 2,
                   rerank=tdev.RerankRequest(tdev.MaxSimRerank()))
    with pytest.raises(ValueError, match="set_tokens requires"):
        idx.set_tokens(np.arange(1), [np.ones((1, DIMS), np.float32)])


def _rr_cfg(mod):
    P, T = mod.Property, mod.DataType
    return mod.CollectionConfig(
        name="Reranked", properties=[P("bucket", T.INT)],
        vector_config=mod.HNSWIndexConfig(
            distance="l2-squared", precision="fp32", ef=32,
            ef_construction=32, max_connections=8, device_beam=True,
            rerank=mod.RerankModuleConfig(module="rerank-linear",
                                          params={"w_mean": 0.5},
                                          max_tokens=TMAX)))


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_reranked_collection_opens_across_packages(tmp_path, writer):
    """An HNSW collection with a rerank module and registered token sets,
    written by one package's ``DB``, opens in the other: the same
    reranked answers (the token planes and the module's parameters
    carried in the checkpoint and the schema)."""
    from weaviate_tpu.core.db import DB as JaxDB
    from weaviate_tpu.storage.objects import StorageObject as JaxObject
    from weaviate_tpu_torch.core.db import DB
    from weaviate_tpu_torch.storage.objects import StorageObject

    rng = np.random.default_rng(31)
    vecs = _tokens(rng, (200, DIMS))
    sets = [_tokens(rng, (1 + i % TMAX, DIMS)) for i in range(0, 200, 2)]
    root = str(tmp_path / "db")
    if writer == "jax":
        db, mod, cls = JaxDB(root), jdev, JaxObject
        cfg = _rr_cfg(jconfig)
    else:
        db, mod, cls = DB(root, device="cpu"), tdev, StorageObject
        cfg = _rr_cfg(config)
    col = db.create_collection(cfg)
    col.put_batch([cls(uuid=f"{i:08x}-0000-4000-8000-000000000000",
                       collection="Reranked", vector=vecs[i],
                       properties={"bucket": i % 5}) for i in range(200)])
    shard = next(iter(col._shards.values()))
    shard.vector_index().set_tokens(np.arange(0, 200, 2), sets)
    qt = _tokens(rng, (3, DIMS))
    q = vecs[10] + 0.05

    def page(c, m):
        req = m.RerankRequest(m.LinearRerank(w_mean=0.5), qt)
        return [(o.uuid, d) for o, d in c.vector_search(q, 5, rerank=req)]

    want = page(col, mod)
    db.close()
    other = DB(root, device="cpu") if writer == "jax" else JaxDB(root)
    got = page(other.get_collection("Reranked"),
               tdev if writer == "jax" else jdev)
    other.close()
    assert [u for u, _ in got] == [u for u, _ in want] and want
    np.testing.assert_allclose([d for _, d in got], [d for _, d in want],
                               rtol=TOL, atol=TOL)
