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

import probe_rerank

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


# ---------------------------------------------------------------------------
# B7a's partition (csrc/rerank.cu), modelled on the CPU
# ---------------------------------------------------------------------------

CARD_SMS = 132
CARD_SMEM = 232_448 - 64  # 227 KB a block, less the kernel's static part
WINDOW = trerank._WINDOW
COLS = trerank._COLS


def _b7a_model(cand, tokens, tmask, q, qm, kind, weights, out_k, plan,
               seen=None):
    """B7a as the kernel computes it under ``plan``: a CTA a (query,
    group of ``cpb`` candidates, block) -- with ``nblk`` blocks, block r of
    a candidate takes its kept tokens of kept rank [L r / nblk, L (r + 1)
    / nblk) -- each window of ``WINDOW`` (candidate, token) slots compacted
    into a list, its tiles of ``COLS`` tokens against the live query rows
    (and the mean row: linear) folded into the block's maxima and mean
    sums, the blocks combined by max (and sum), the query rows summed,
    then the last CTA's rank by counting. ``seen`` collects every (query,
    candidate slot, token) a tile takes."""
    b, c = cand.shape
    n, t, _ = tokens.shape
    linear = kind == 1
    w_max, w_mean, bias = weights
    scores = np.full((b, c), -np.inf, np.float32)
    for qi in range(b):
        live = np.nonzero(qm[qi])[0]
        rows = q[qi, live]
        if linear:
            mean = (q[qi, live].sum(0, dtype=np.float32)
                    / np.float32(max(len(live), 1)))
            rows = np.vstack([rows, mean[None]]).astype(np.float32)
        for g in range(plan.grid[1]):
            c0 = g * plan.cpb
            ncand = min(plan.cpb, c - c0)
            cid = [int(cand[qi, c0 + i]) if i < ncand
                   and 0 <= cand[qi, c0 + i] < n else -1
                   for i in range(plan.cpb)]
            best = np.full((plan.nblk, plan.cpb, len(live)), -np.inf,
                           np.float32)
            msum = np.zeros((plan.nblk, plan.cpb), np.float32)
            kept = [int(tmask[i].sum()) if i >= 0 else 0 for i in cid]
            for blk in range(plan.nblk):
                klo, khi = 0, 1 << 31
                if plan.nblk > 1:
                    klo = kept[0] * blk // plan.nblk
                    khi = kept[0] * (blk + 1) // plan.nblk
                base = 0
                slots = plan.cpb * t
                for w0 in range(0, slots, WINDOW):
                    flat = np.arange(w0, min(slots, w0 + WINDOW))
                    cl = flat // t
                    keep = np.array([cl_ < ncand and cid[cl_] >= 0
                                     and tmask[cid[cl_], f - cl_ * t]
                                     for f, cl_ in zip(flat, cl)], bool)
                    ranks = base + np.cumsum(keep) - 1
                    lst = flat[keep & (ranks >= klo) & (ranks < khi)]
                    base += int(keep.sum())
                    for col0 in range(0, len(lst), COLS):
                        cols = lst[col0:col0 + COLS]
                        owner = cols // t
                        toks = np.stack([tokens[cid[o], f - o * t]
                                         for f, o in zip(cols, owner)])
                        prods = rows @ toks.T                  # float32
                        for j, (f, o) in enumerate(zip(cols, owner)):
                            if seen is not None:
                                seen.append((qi, c0 + o, f - o * t))
                            best[blk, o] = np.maximum(
                                best[blk, o], prods[:len(live), j])
                            if linear:
                                msum[blk, o] += prods[len(live), j]
            for i in range(ncand):
                if cid[i] < 0:
                    continue
                m = best[:, i].max(axis=0)
                total = np.float32(np.where(np.isfinite(m), m, 0).sum(
                    dtype=np.float32))
                if linear:
                    cn = np.float32(max(kept[i], 1))
                    total = (np.float32(w_max) * total + np.float32(w_mean)
                             * (msum[:, i].sum(dtype=np.float32) / cn)
                             + np.float32(bias))
                scores[qi, c0 + i] = total
    ids = np.full((b, out_k), -1, np.int32)
    dists = np.full((b, out_k), 1e30, np.float32)
    for qi in range(b):
        for i in range(c):
            v = scores[qi, i]
            rank = int(((scores[qi] > v)
                        | ((scores[qi] == v) & (np.arange(c) < i))).sum())
            if rank < out_k and np.isfinite(v):
                ids[qi, rank], dists[qi, rank] = cand[qi, i], -v
    return ids, dists


def _b7a_case(seed, b=3, c=24, t=64, tq=5, d=20, n=90):
    """Token planes with kept prefixes and scattered masks, a fully masked
    row, twin rows (exact ties between ids), a repeated id, -1 pads,
    masked query tokens."""
    rng = np.random.default_rng(seed)
    tokens = _tokens(rng, (n, t, d))
    tmask = rng.random((n, t)) < 0.55
    tmask[1::3] = np.arange(t)[None, :] < rng.integers(1, t + 1,
                                                       (len(tmask[1::3]), 1))
    tmask[4] = False
    tokens[7], tmask[7] = tokens[8], tmask[8]
    cand = rng.integers(0, n, (b, c)).astype(np.int32)
    cand[:, :4] = [4, 8, 7, 9]
    cand[:, 5] = cand[:, 6]
    cand[:, -3:] = -1
    q = _tokens(rng, (b, tq, d))
    qm = rng.random((b, tq)) < 0.8
    qm[:, 0] = True
    qm[1, :] = [True] + [False] * (tq - 1)
    return cand, tokens, tmask, q, qm


# (b, c, t, tq, d): the main path's two shapes and the model's own
PLAN_SHAPES = [(1, 64, 256, 32, 128), (64, 32, 4, 4, 128),
               (2, 64, 4, 1, 768), (3, 1024, 256, 32, 128),
               (2, 100, 8, 5, 99), (2, 256, 16, 40, 128),
               (1, 64, 4, 64, 2048), (1, 20_000, 4, 1, 128),
               (1, 60_000, 4, 2, 64), (1, 65_535, 2048, 8, 16)]


@pytest.mark.parametrize("linear", [False, True])
@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_rerank_plan_covers_every_candidate_once(shape, linear):
    """The launch planner's grid takes every candidate of every query in
    one CTA group, within grid.y's 65,535 and 8 CTAs a cluster, in the
    shared memory of a block; the token blocks of a candidate cover its
    kept tokens once."""
    b, c, t, tq, d = shape
    plan = trerank.rerank_plan(b, c, t, tq, d, linear, CARD_SMS, CARD_SMEM)
    assert plan.grid[0] == b * plan.nblk and plan.grid[1] <= 65_535
    assert 1 <= plan.nblk <= 8 and plan.smem <= CARD_SMEM
    assert 4 * plan.rg >= tq + linear or plan.rg == 8
    if plan.cpb > 1:
        assert plan.nblk == 1 and plan.cpb * t <= WINDOW
    slots = [g * plan.cpb + i for g in range(plan.grid[1])
             for i in range(plan.cpb) if g * plan.cpb + i < c]
    assert slots == list(range(c))
    for kept in (0, 1, plan.nblk, t // 3, t):
        got = [r for blk in range(plan.nblk)
               for r in range(kept * blk // plan.nblk,
                              kept * (blk + 1) // plan.nblk)]
        assert got == list(range(kept))
    assert plan.smem >= 4 * trerank.rerank_smem_words(
        plan.rg, plan.cpb, tq, d, linear)
    # the main path's shapes fill the card: at least two CTAs an SM
    if shape in PLAN_SHAPES[:2]:
        assert plan.grid[0] * plan.grid[1] >= 2 * CARD_SMS
    with pytest.raises(ValueError, match="shared memory"):
        trerank.rerank_plan(b, c, t, 60_000, d, linear, CARD_SMS, CARD_SMEM)


@pytest.mark.parametrize("name", ["maxsim", "linear"])
@pytest.mark.parametrize("plan_at", ["card", "blocks", "groups", "one"])
def test_rerank_partition_model_matches_jax(name, plan_at):
    """The kernel's partition, modelled (``_b7a_model``), against JAX
    ``_rerank_stage``: ids equal (twin rows' exact ties in candidate
    order), negated scores within 1e-5, every kept token of every valid
    candidate taken once; at the card's plan and at others (more blocks
    than the card gives, several candidates a CTA, one CTA a candidate)."""
    import jax.numpy as jnp

    jm, tm = _modules(name)
    kind, w_max, w_mean, bias = tm.kernel_params()
    cand, tokens, tmask, q, qm = _b7a_case(21)
    b, c = cand.shape
    n, t, d = tokens.shape
    tq = q.shape[1]
    plan = trerank.rerank_plan(b, c, t, tq, d, kind == 1, CARD_SMS,
                               CARD_SMEM)
    plan = {"card": plan,
            "blocks": plan._replace(nblk=7, cpb=1, grid=(7 * b, c)),
            "groups": plan._replace(nblk=1, cpb=3, grid=(b, -(-c // 3))),
            "one": plan._replace(nblk=1, cpb=1, grid=(b, c))}[plan_at]
    if plan_at == "card":
        assert plan.nblk > 1  # so few candidates split their tokens
    seen = []
    out_k = 9
    got = _b7a_model(cand, tokens, tmask, q, qm, kind, (w_max, w_mean, bias),
                     out_k, plan, seen)
    ji, jd = jbeam._rerank_stage(
        jm, out_k, jnp.asarray(cand), jnp.asarray(tokens), jnp.asarray(tmask),
        jnp.asarray(q), jnp.asarray(qm))
    np.testing.assert_array_equal(got[0], np.asarray(ji))
    np.testing.assert_allclose(got[1], np.asarray(jd), rtol=TOL, atol=TOL)
    want = sorted((qi, j, int(k)) for qi in range(b) for j in range(c)
                  if 0 <= cand[qi, j] < n
                  for k in np.nonzero(tmask[cand[qi, j]])[0])
    assert sorted(seen) == want
    # an id past the plane is invalid, as in the port's plain version (JAX
    # gathers past its end)
    cand[0, -4] = n + 5
    got = _b7a_model(cand, tokens, tmask, q, qm, kind, (w_max, w_mean, bias),
                     out_k, plan)
    pi, pd = trerank.rerank_topk_plain(
        *(torch.from_numpy(x) for x in (cand, tokens, tmask, q, qm)), tm,
        out_k)
    np.testing.assert_array_equal(got[0], pi.numpy())
    np.testing.assert_allclose(got[1], pd.numpy(), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("kernel,copy", [
    (k, c) for k in sorted(probe_rerank.COPIES)
    for c in sorted(probe_rerank.COPIES[k])])
def test_probe_copies_apply_to_the_kernel_source(kernel, copy):
    # probe_rerank.py's copies replace text the kernel source holds exactly
    # once, so a kernel edit that drops one fails here
    src = probe_rerank.SOURCES[kernel].read_text()
    for old, _new in probe_rerank.COPIES[kernel][copy]:
        assert src.count(old) == 1, repr(old)
    assert probe_rerank.copies_of(kernel, src)[copy] != \
        src + probe_rerank.APPENDED
