"""Multi-target search (port slice 7a) against the JAX package on the CPU.

- Every function of ``query/multi_target.py`` against JAX's.
- ``mt_join_topk_plain`` (kernel B7b's plain version) against JAX
  ``_mt_dedup`` + ``_masked_scores`` + ``_mt_join`` + ``_mt_topk`` on pools
  with duplicates across targets, ids missing a target and ids past a
  target's capacity, under the three joins: ids equal, joined distances
  within 1e-5 (float32 sums of the same products in another order).
- ``device_multi_search`` against JAX's on a raw and an SQ leg of the same
  graphs, unfiltered and filtered: ids equal, distances within 1e-5.
- ``Collection.multi_target_search`` against JAX's over the five
  combinations, unfiltered and filtered, and the host oracle
  (``_multi_target_search_host``) against JAX's: the same uuids,
  distances within 1e-5.
- A join that raises makes ``multi_target_search`` raise (no host route).
"""

import numpy as np
import pytest
import torch

from weaviate_tpu.core.db import DB as JaxDB
from weaviate_tpu.index.hnsw import HNSWIndex as JaxHNSW
from weaviate_tpu.inverted.filters import Where as JWhere
from weaviate_tpu.ops import device_beam as jbeam
from weaviate_tpu.query import multi_target as jmt
from weaviate_tpu.schema import config as jconfig
from weaviate_tpu.storage.objects import StorageObject as JaxObject
from weaviate_tpu_torch.core.db import DB
from weaviate_tpu_torch.index.hnsw import HNSWIndex
from weaviate_tpu_torch.inverted.filters import Where
from weaviate_tpu_torch.ops import device_beam as tbeam
from weaviate_tpu_torch.query import multi_target as tmt
from weaviate_tpu_torch.schema import config
from weaviate_tpu_torch.storage.objects import StorageObject

TOL = 1e-5
DIMS = {"a": 16, "b": 8}
N, K = 300, 5
COMBOS = [("sum", None), ("average", None), ("minimum", None),
          ("manualWeights", {"a": 0.7, "b": 0.3}),
          ("relativeScore", {"a": 2.0, "b": 1.0})]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_multi_target_helpers_match_jax():
    rng = np.random.default_rng(0)
    q, v = rng.standard_normal((2, 12)).astype(np.float32)
    for metric in ("l2-squared", "dot", "cosine", "manhattan", "hamming"):
        assert tmt.np_distance(q, v, metric) == jmt.np_distance(q, v, metric)
    with pytest.raises(ValueError):
        tmt.np_distance(q, v, "nope")
    targets = ["a", "b", "c"]
    for combo, w in COMBOS + [("relativeScore", None)]:
        assert tmt.join_mode(combo) == jmt.join_mode(combo)
        np.testing.assert_array_equal(tmt.weight_row(targets, combo, w),
                                      jmt.weight_row(targets, combo, w))
    bad = [([], "sum", None), (["a", "a"], "sum", None),
           (["a", "z"], "sum", None), (["a"], "nope", None),
           (["a", "b"], "sum", {"a": 1.0}),
           (["a", "b"], "manualWeights", {"a": 1.0}),
           (["a", "b"], "relativeScore", {"z": 1.0})]
    for args in bad:
        with pytest.raises(ValueError) as te:
            tmt.validate_multi_target(*args, {"a", "b", "c"})
        with pytest.raises(ValueError) as je:
            jmt.validate_multi_target(*args, {"a", "b", "c"})
        assert str(te.value) == str(je.value)
    tmt.validate_multi_target(["a", "b"], "manualWeights",
                              {"a": 1.0, "b": 2.0}, {"a", "b"})
    per = {t: {k: float(rng.random()) for k in range(7)} for t in "ab"}
    for combo, w in COMBOS:
        assert tmt.combine_multi_target(per, combo, w) == \
            jmt.combine_multi_target(per, combo, w)
    assert tmt.combine_multi_target({"a": {}}, "sum") == []


def _join_case(seed, targets=2):
    """Two or three targets' raw rows, graphs' present masks and pools
    with duplicates across targets, -1 pads, ids absent from a target and
    ids past a target's capacity."""
    rng = np.random.default_rng(seed)
    b, fetch, caps = 3, 8, (60, 48, 60)
    legs = []
    for t in range(targets):
        d = 8 + 4 * t
        rows = rng.standard_normal((caps[t], d)).astype(np.float32)
        present = rng.random(caps[t]) < 0.9
        q = rng.standard_normal((b, d)).astype(np.float32)
        pool = rng.integers(0, 60, (b, fetch + 4)).astype(np.int32)
        pool[:, 1] = pool[:, 0]                  # a repeat in one pool
        pool[:, fetch - 1] = -1                  # a pad
        legs.append(dict(rows=rows, present=present, q=q, pool=pool))
    legs[1]["pool"][:, :3] = legs[0]["pool"][:, :3]  # repeats across pools
    w = rng.random((b, targets)).astype(np.float32)
    return legs, w, fetch


def _scorers(mod, legs, metric):
    return [mod.RawScorer(metric, "fp32") for _ in legs]


@pytest.mark.parametrize("join", ["weighted", "minimum", "relative"])
@pytest.mark.parametrize("targets", [2, 3])
@pytest.mark.parametrize("metric", ["l2-squared", "dot"])
def test_mt_join_plain_matches_jax(join, targets, metric):
    import jax.numpy as jnp

    legs, w, fetch = _join_case(targets, targets)
    # JAX: the program's steps after its walks
    jc = jbeam._mt_dedup(jnp.concatenate(
        [jnp.asarray(leg["pool"][:, :fetch]) for leg in legs], axis=1))
    per_d, valid_all = [], jc >= 0
    for leg, sc in zip(legs, _scorers(jbeam, legs, metric)):
        cap = leg["present"].shape[0]
        safe = jnp.clip(jc, 0, cap - 1)
        ok = (jc >= 0) & (jc < cap) & jnp.take(jnp.asarray(leg["present"]),
                                                safe)
        per_d.append(jbeam._masked_scores(
            sc, jnp.asarray(leg["q"]), jnp.where(ok, jc, -1),
            (jnp.asarray(leg["rows"]),)))
        valid_all &= ok
    combined = jbeam._mt_join(join, jnp.asarray(w),
                              jnp.stack(per_d, axis=-1), valid_all)
    ji, jd = jbeam._mt_topk(jc, combined, fetch)
    ti, td = tbeam.mt_join_topk_plain(
        _scorers(tbeam, legs, metric), [torch.from_numpy(x["q"]) for x in legs],
        [(torch.from_numpy(x["rows"]),) for x in legs],
        [torch.from_numpy(x["present"]) for x in legs],
        [torch.from_numpy(x["pool"]) for x in legs], torch.from_numpy(w),
        fetch, join)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=TOL,
                               atol=TOL)
    # the dispatcher takes the plain version for CPU tensors
    launches = tbeam.mt_join_topk_cuda.launches
    ri, _ = tbeam.mt_join_topk(
        _scorers(tbeam, legs, metric), [torch.from_numpy(x["q"]) for x in legs],
        [(torch.from_numpy(x["rows"]),) for x in legs],
        [torch.from_numpy(x["present"]) for x in legs],
        [torch.from_numpy(x["pool"]) for x in legs], torch.from_numpy(w),
        fetch, join)
    np.testing.assert_array_equal(ri.numpy(), ti.numpy())
    assert tbeam.mt_join_topk_cuda.launches == launches


def test_mt_join_cuda_checks_arguments():
    legs, w, fetch = _join_case(5)
    args = (_scorers(tbeam, legs, "l2-squared"),
            [torch.from_numpy(x["q"]) for x in legs],
            [(torch.from_numpy(x["rows"]),) for x in legs],
            [torch.from_numpy(x["present"]) for x in legs],
            [torch.from_numpy(x["pool"]) for x in legs])
    with pytest.raises(ValueError, match="join"):
        tbeam.mt_join_topk_cuda(*args, torch.from_numpy(w), fetch, "max")
    with pytest.raises(ValueError, match="weights"):
        tbeam.mt_join_topk_cuda(*args, torch.from_numpy(w[:1]), fetch,
                                "weighted")
    with pytest.raises(ValueError, match="fetch"):
        tbeam.mt_join_topk_cuda(*args, torch.from_numpy(w), 4096, "weighted")


def _index_pair(dims, quant, vecs):
    def cfg(mod):
        kw = dict(distance="l2-squared", precision="fp32", ef=32,
                  ef_construction=32, max_connections=8, device_beam=True,
                  flat_search_cutoff=0)
        if quant:
            kw["quantizer"] = mod.SQConfig(rescore_limit=16)
        return mod.HNSWIndexConfig(**kw)

    j = JaxHNSW(dims, cfg(jconfig))
    t = HNSWIndex(dims, cfg(config), device="cpu")
    for idx in (j, t):
        idx.add_batch(np.arange(len(vecs)), vecs)
    return j, t


@pytest.mark.parametrize("filtered", [False, True])
@pytest.mark.parametrize("join", ["weighted", "relative"])
def test_device_multi_search_matches_jax_raw_and_sq_legs(filtered, join):
    import jax.numpy as jnp

    rng = np.random.default_rng(8)
    va = rng.standard_normal((N, DIMS["a"])).astype(np.float32)
    vb = rng.standard_normal((N, DIMS["b"])).astype(np.float32)
    ja, ta = _index_pair(DIMS["a"], False, va)
    jb, tb = _index_pair(DIMS["b"], True, vb)
    b = 4
    qa, qb = va[:b] + 0.05, vb[:b] + 0.05
    allow = (np.arange(N) % 2 == 0) if filtered else None
    expand = 2 if filtered else 0
    w = rng.random((b, 2)).astype(np.float32)
    jl = [idx.multi_walk_inputs(q, K, 8, allow_list=allow, expand=expand)
          for idx, q in ((ja, qa), (jb, qb))]
    tl = [idx.multi_walk_inputs(q, K, b, allow_list=allow, expand=expand)
          for idx, q in ((ta, qa), (tb, qb))]

    def call(mod, legs, weights, eps_key):
        fetch = min(leg["keep_k"] or leg["ef_pad"] for leg in legs)
        return mod.device_multi_search(
            scorers=tuple(leg["scorer"] for leg in legs), weights=weights,
            queries=tuple(leg["q"] for leg in legs),
            operands=tuple(leg["operands"] for leg in legs),
            adjacency=tuple(leg["adj"] for leg in legs),
            present=tuple(leg["present"] for leg in legs),
            eps=tuple(leg[eps_key] for leg in legs),
            upper_adjs=tuple(leg["upper_adj"] for leg in legs),
            upper_slots=tuple(leg["upper_slots"] for leg in legs),
            efs=tuple(leg["ef_pad"] for leg in legs),
            max_steps=max(4 * leg["ef_pad"] + 64 for leg in legs),
            fetch=fetch, join=join,
            allows=tuple(leg["allow"] for leg in legs),
            keep_ks=tuple(leg["keep_k"] for leg in legs),
            expands=tuple(leg["expand"] for leg in legs))

    wp = np.concatenate([w, np.repeat(w[:1], 8 - b, axis=0)])
    ji, jd = call(jbeam, jl, jnp.asarray(wp), "eps")
    ti, td = call(tbeam, tl, w, "eps")
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji)[:b])
    np.testing.assert_allclose(td.numpy(), np.asarray(jd)[:b], rtol=TOL,
                               atol=TOL)
    assert (ti.numpy() >= 0).any()


def _mt_cfg(mod, quant_b=False):
    def hnsw(quant):
        kw = dict(distance="l2-squared", precision="fp32", ef=48,
                  ef_construction=32, max_connections=8, device_beam=True)
        if quant:
            kw["quantizer"] = mod.SQConfig(rescore_limit=16)
        return mod.HNSWIndexConfig(**kw)

    P, T = mod.Property, mod.DataType
    return mod.CollectionConfig(
        name="Multi", properties=[P("bucket", T.INT)],
        vector_config=mod.FlatIndexConfig(distance="l2-squared",
                                          precision="fp32"),
        named_vectors={"a": hnsw(False), "b": hnsw(quant_b)})


def _mt_objects(cls, vecs, missing=()):
    out = []
    for i in range(N):
        nv = {t: vecs[t][i] for t in vecs
              if not (t == "b" and i in missing)}
        out.append(cls(uuid=f"{i:08x}-0000-4000-8000-000000000000",
                       collection="Multi", named_vectors=nv,
                       properties={"bucket": i % 10}))
    return out


@pytest.fixture(scope="module")
def mt_cols(tmp_path_factory):
    root = tmp_path_factory.mktemp("mt")
    rng = np.random.default_rng(3)
    vecs = {t: rng.standard_normal((N, d)).astype(np.float32)
            for t, d in DIMS.items()}
    jdb, tdb = JaxDB(str(root / "j")), DB(str(root / "t"), device="cpu")
    jcol = jdb.create_collection(_mt_cfg(jconfig, quant_b=True))
    tcol = tdb.create_collection(_mt_cfg(config, quant_b=True))
    missing = set(range(0, N, 17))
    jcol.put_batch(_mt_objects(JaxObject, vecs, missing))
    tcol.put_batch(_mt_objects(StorageObject, vecs, missing))
    qs = [{t: vecs[t][r] + 0.05 for t in vecs} for r in (1, 50, 99, 200)]
    yield jcol, tcol, qs
    jdb.close()
    tdb.close()


def _rows(res):
    return [o.uuid for o, _ in res], [d for _, d in res]


@pytest.mark.parametrize("combo", range(len(COMBOS)))
@pytest.mark.parametrize("filtered", [False, True])
def test_collection_multi_target_search_matches_jax(mt_cols, combo,
                                                    filtered):
    jcol, tcol, qs = mt_cols
    combination, weights = COMBOS[combo]
    jf = JWhere.lt("bucket", 6) if filtered else None
    tf = Where.lt("bucket", 6) if filtered else None
    join0 = tbeam.mt_join_topk_cuda.launches
    for q in qs:
        ju, jd = _rows(jcol.multi_target_search(
            q, k=K, combination=combination, weights=weights, flt=jf))
        d0 = tbeam.dispatch_count()
        tu, td = _rows(tcol.multi_target_search(
            q, k=K, combination=combination, weights=weights, flt=tf))
        # one multi-target search on the device route (on CPU tensors the
        # plain versions, so no kernel launch)
        assert tbeam.dispatch_count() - d0 == 1
        assert tu == ju and tu
        np.testing.assert_allclose(td, jd, rtol=TOL, atol=TOL)
        hu, hd = _rows(tcol._multi_target_search_host(
            q, k=K, combination=combination, weights=weights, flt=tf))
        ju2, jd2 = _rows(jcol._multi_target_search_host(
            q, k=K, combination=combination, weights=weights, flt=jf))
        assert hu == ju2
        np.testing.assert_allclose(hd, jd2, rtol=TOL, atol=TOL)
    assert tbeam.mt_join_topk_cuda.launches == join0


def test_shard_multi_target_search_and_ineligible_route(mt_cols):
    jcol, tcol, qs = mt_cols
    shard = next(iter(tcol._shards.values()))
    assert shard.multi_target_device_eligible(("a", "b"))
    assert not shard.multi_target_device_eligible(("a",))
    res = shard.multi_target_search(qs[0], K, "sum")
    assert res.ids.shape == (1, K) and (res.ids >= 0).all()
    # a demoted target has no device walk: the host oracle answers, as in
    # the JAX package
    idx = shard.vector_index("b")
    jidx = next(iter(jcol._shards.values())).vector_index("b")
    idx.demote_device()
    jidx.demote_device()
    try:
        assert not shard.multi_target_device_eligible(("a", "b"))
        ju, jd = _rows(jcol.multi_target_search(qs[1], k=K,
                                                combination="minimum"))
        tu, td = _rows(tcol.multi_target_search(qs[1], k=K,
                                                combination="minimum"))
        assert tu == ju
        np.testing.assert_allclose(td, jd, rtol=TOL, atol=TOL)
    finally:
        idx.promote_device()
        jidx.promote_device()


def test_failed_join_raises_through_the_entry_point(mt_cols, monkeypatch):
    """A join that fails raises through ``multi_target_search``: no host
    route takes over."""
    _, tcol, qs = mt_cols

    def broken(*args, **kwargs):
        raise RuntimeError("mt_join_topk launch failed")

    monkeypatch.setattr(tbeam, "mt_join_topk", broken)
    with pytest.raises(RuntimeError, match="launch failed"):
        tcol.multi_target_search(qs[2], k=K, combination="sum")


def test_request_shape_errors_match_jax(mt_cols):
    jcol, tcol, qs = mt_cols
    for bad in ({"a": qs[0]["a"], "z": qs[0]["b"]},
                {"a": qs[0]["a"], "b": np.zeros(3, np.float32)}):
        with pytest.raises(ValueError):
            jcol.multi_target_search(bad, k=K)
        with pytest.raises(ValueError):
            tcol.multi_target_search(bad, k=K)
