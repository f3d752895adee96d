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

import re

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


# ---------------------------------------------------------------------------
# B7b's partition (mt_join_kernel, csrc/device_beam.cu), modelled on the CPU
# ---------------------------------------------------------------------------

CARD_SMEM = 232_448 - 256  # 227 KB a block, less the kernel's static part
PQ_SEGS, PQ_CENTS, PQ_DSUB = 8, 256, 2


def _bf16(x: np.ndarray) -> np.ndarray:
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
        torch.bfloat16).float().numpy()


def _pq_leg(rng, cap, b):
    """A PQ target of random codes into random codebooks (no fit needed
    for a join): its rows' decoded squared norms, its queries."""
    codes = rng.integers(0, PQ_CENTS, (cap, PQ_SEGS)).astype(np.uint8)
    cb = rng.standard_normal((PQ_SEGS, PQ_CENTS, PQ_DSUB)).astype(np.float32)
    dec = cb[np.arange(PQ_SEGS), codes.astype(np.int64)].reshape(cap, -1)
    return dict(kind="pq", codes=codes, cb=cb,
                dsq=(dec * dec).sum(1).astype(np.float32),
                q=rng.standard_normal((b, PQ_SEGS * PQ_DSUB)).astype(
                    np.float32))


def _cluster_case(seed):
    """A raw, a PQ and a raw dot target: pools with repeats inside and
    across targets, -1 pads, members missing a target, twin rows (exact
    ties of the joined distance) in every target."""
    rng = np.random.default_rng(seed)
    b, fetch, cap = 3, 16, 70
    legs = [dict(kind="raw", metric="l2-squared",
                 rows=rng.standard_normal((cap, 12)).astype(np.float32),
                 q=rng.standard_normal((b, 12)).astype(np.float32)),
            _pq_leg(rng, cap, b),
            dict(kind="raw", metric="dot",
                 rows=rng.standard_normal((cap, 8)).astype(np.float32),
                 q=rng.standard_normal((b, 8)).astype(np.float32))]
    for leg in legs:
        leg["present"] = rng.random(cap) < 0.85
        leg["present"][[5, 6]] = True
        leg["pool"] = rng.integers(0, cap, (b, fetch + 3)).astype(np.int32)
        leg["pool"][:, :2] = [5, 6]
        leg["pool"][:, 4] = leg["pool"][:, 3]
        leg["pool"][:, fetch - 2:fetch] = -1
        if leg["kind"] == "raw":
            leg["rows"][6] = leg["rows"][5]
        else:
            leg["codes"][6] = leg["codes"][5]
            leg["dsq"][6] = leg["dsq"][5]
    legs[1]["pool"][:, 5:9] = legs[0]["pool"][:, 5:9]
    w = (0.2 + rng.random((b, len(legs)))).astype(np.float32)
    return legs, w, fetch


def _leg_args(mod, legs, frame):
    scorers, queries, operands, present, pools = [], [], [], [], []
    for leg in legs:
        if leg["kind"] == "raw":
            scorers.append(mod.RawScorer(leg["metric"], "fp32"))
            operands.append((frame(leg["rows"]),))
        else:
            scorers.append(mod.PQScorer("l2-squared"))
            operands.append((frame(leg["codes"]), frame(leg["cb"]),
                             frame(leg["dsq"])))
        queries.append(frame(leg["q"]))
        present.append(frame(leg["present"]))
        pools.append(frame(leg["pool"]))
    return scorers, queries, operands, present, pools


def _b7b_model(legs, w, fetch, join, plan, seen=None):
    """B7b as the kernel computes it under ``plan``: per query row, the
    union's slots in pool order, each live id present in every target
    kept at its lowest slot (the members, in slot order); CTA r of
    ``ranks`` scores members [r V / R, (r + 1) V / R) under every target
    (PQ through the ADC table, its segments split in slices of ceil(M /
    R), a lookup reading the slice that holds its segment); the first
    CTA's relative min-max, join and rank by counting (the lower id on
    ties: the sorted union's order). ``seen`` collects every (row,
    member, target) scored."""
    b = w.shape[0]
    ids = np.full((b, fetch), -1, np.int32)
    out = np.full((b, fetch), 1e30, np.float32)
    for qi in range(b):
        members = []
        for x in np.concatenate([leg["pool"][qi, :fetch] for leg in legs]):
            if x >= 0 and int(x) not in members and all(
                    x < len(leg["present"]) and leg["present"][x]
                    for leg in legs):
                members.append(int(x))
        v_n = len(members)
        dist = np.zeros((len(legs), v_n), np.float32)
        for r in range(plan.ranks):
            for v in range(v_n * r // plan.ranks, v_n * (r + 1) // plan.ranks):
                x = members[v]
                for t, leg in enumerate(legs):
                    if seen is not None:
                        seen.append((qi, v, t))
                    q = leg["q"][qi]
                    if leg["kind"] == "raw" and leg["metric"] == "l2-squared":
                        diff = q - leg["rows"][x]
                        dist[t, v] = (diff * diff).sum(dtype=np.float32)
                    elif leg["kind"] == "raw":
                        dist[t, v] = -(q * leg["rows"][x]).sum(
                            dtype=np.float32)
                    else:
                        per = -(-PQ_SEGS // plan.ranks)
                        table = np.einsum("sj,scj->sc",
                                          _bf16(q).reshape(PQ_SEGS, -1),
                                          _bf16(leg["cb"])).astype(np.float32)
                        slices = [table[o * per:(o + 1) * per]
                                  for o in range(plan.ranks)]
                        ip = np.float32(0)
                        for s, code in enumerate(leg["codes"][x]):
                            ip += slices[s // per][s % per][code]
                        dist[t, v] = max(np.float32(
                            (q * q).sum(dtype=np.float32) - 2 * ip
                            + leg["dsq"][x]), 0)
        if join == "minimum":
            comb = dist.min(0)
        elif join == "relative":
            lo = dist.min(1, keepdims=True) if v_n else 0
            span = (dist.max(1, keepdims=True) - lo) if v_n else 1
            span = np.where(span > 0, span, 1).astype(np.float32)
            comb = (((dist - lo) / span) * w[qi][:, None]).sum(0)
        else:
            comb = (dist * w[qi][:, None]).sum(0)
        order = np.array(members)
        for i in range(v_n):
            rank = int(((comb < comb[i]) | ((comb == comb[i])
                                            & (order < order[i]))).sum())
            if rank < fetch and comb[i] < 1e30:
                ids[qi, rank], out[qi, rank] = members[i], comb[i]
    return ids, out


@pytest.mark.parametrize("targets", [1, 2, 3, 8])
@pytest.mark.parametrize("fetch", [1, 16, 64, 512])
def test_mt_join_plan_covers_every_member_once(targets, fetch):
    """The launch planner: up to 8 CTAs a query row, within the shared
    memory of a block; the CTAs' member slices cover every member once
    whatever the union holds, and each PQ table's slices its segments."""
    shapes = tuple((4, 1536, 96, 256) if t % 2 else (0, 768, 0, 0)
                   for t in range(targets))
    plan = tbeam.mt_join_plan(3, shapes, fetch, CARD_SMEM)
    assert 1 <= plan.ranks <= 8 and plan.grid == 3 * plan.ranks
    assert plan.upad >= targets * fetch and plan.smem <= CARD_SMEM
    for v_n in sorted({0, 1, plan.ranks, targets * fetch // 2,
                       targets * fetch}):
        got = [v for r in range(plan.ranks)
               for v in range(v_n * r // plan.ranks,
                              v_n * (r + 1) // plan.ranks)]
        assert got == list(range(v_n))
    per = -(-96 // plan.ranks)
    assert sorted(s for r in range(plan.ranks)
                  for s in range(r * per, min(96, (r + 1) * per))) == \
        list(range(96))
    # the main path's shape: 8 CTAs, no table
    main = tbeam.mt_join_plan(1, ((0, 768, 0, 0), (0, 256, 0, 0)), 64,
                              CARD_SMEM)
    assert (main.ranks, main.tables) == (8, 0)


@pytest.mark.parametrize("join", ["weighted", "minimum", "relative"])
@pytest.mark.parametrize("plan_at", ["card", "two", "one"])
def test_mt_join_cluster_model_matches_jax(join, plan_at):
    """The kernel's partition, modelled (``_b7b_model``), against JAX's
    join after its walks (``_mt_dedup``, ``_masked_scores``, ``_mt_join``,
    ``_mt_topk``) on a raw, a PQ and a raw dot target: ids equal (twin
    rows' exact ties in union order), joined distances within 1e-5, every
    (member, target) scored once; at the card's plan (the PQ table split
    over 8 CTAs) and at 2 and 1 CTAs a row."""
    import jax.numpy as jnp

    legs, w, fetch = _cluster_case(31)
    shapes = tuple((0, leg["q"].shape[1], 0, 0) if leg["kind"] == "raw"
                   else (4, PQ_SEGS * PQ_DSUB, PQ_SEGS, PQ_CENTS)
                   for leg in legs)
    plan = tbeam.mt_join_plan(w.shape[0], shapes, fetch, CARD_SMEM)
    assert plan.ranks == 3 and plan.tables == 2
    plan = {"card": plan, "two": plan._replace(ranks=2),
            "one": plan._replace(ranks=1)}[plan_at]
    seen = []
    got = _b7b_model(legs, w, fetch, join, plan, seen)
    scorers, queries, operands, present, pools = _leg_args(
        jbeam, legs, jnp.asarray)
    jc = jbeam._mt_dedup(jnp.concatenate([p[:, :fetch] for p in pools],
                                         axis=1))
    per_d, valid_all = [], jc >= 0
    for sc, q, ops, pres in zip(scorers, queries, operands, present):
        cap = pres.shape[0]
        ok = (jc >= 0) & (jc < cap) & jnp.take(pres, jnp.clip(jc, 0, cap - 1))
        per_d.append(jbeam._masked_scores(sc, q, jnp.where(ok, jc, -1), ops))
        valid_all &= ok
    ji, jd = jbeam._mt_topk(jc, jbeam._mt_join(
        join, jnp.asarray(w), jnp.stack(per_d, axis=-1), valid_all), fetch)
    np.testing.assert_array_equal(got[0], np.asarray(ji))
    np.testing.assert_allclose(got[1], np.asarray(jd), rtol=TOL, atol=TOL)
    # the twins' exact tie, the lower id first
    row = list(got[0][0])
    assert row.index(5) + 1 == row.index(6)
    per_row = {}
    for qi, v, t in seen:
        per_row.setdefault(qi, []).append((v, t))
    for qi, pairs in per_row.items():
        v_n = max(v for v, _ in pairs) + 1
        assert sorted(pairs) == [(v, t) for v in range(v_n)
                                 for t in range(len(legs))]
    # and the port's plain version gives the same page
    ti, td = tbeam.mt_join_topk_plain(
        *_leg_args(tbeam, legs, torch.from_numpy), torch.from_numpy(w),
        fetch, join)
    np.testing.assert_array_equal(got[0], ti.numpy())
    np.testing.assert_allclose(got[1], td.numpy(), rtol=TOL, atol=TOL)


class _Lib:
    """A stand-in library whose functions keep the signatures ``declare``
    gives them."""

    def __getattr__(self, name):
        fn = type("Fn", (), {})()
        setattr(self, name, fn)
        return fn


def _c_params(source, fn: str) -> int:
    import re

    sig = re.search(rf"^int {fn}\(([^)]*)\)", source, re.M | re.S)
    return len(sig.group(1).split(","))


@pytest.mark.parametrize("module,fn", [
    ("device_beam", "mt_join_topk"), ("device_beam", "mt_join_device_info"),
    ("device_beam", "device_beam_search"), ("rerank", "rerank_topk"),
    ("rerank", "rerank_device_info")])
def test_declared_signatures_match_the_sources(module, fn):
    """ctypes passes what ``declare`` lists: as many arguments as the C
    entry point takes."""
    import importlib

    mod = importlib.import_module(f"weaviate_tpu_torch.ops.{module}")
    lib = mod.declare(_Lib())
    src = (tbeam.__file__.rsplit("/", 2)[0] + f"/csrc/{module}.cu")
    with open(src) as f:
        assert len(getattr(lib, fn).argtypes) == _c_params(f.read(), fn)


def test_packed_calls_match_the_sources():
    """The packed launch arguments are as long as the C entry points read:
    B7a's RerankCall, B7b's MtCall and per target 8 addresses, 11 ints
    and 2 floats."""
    from weaviate_tpu_torch.ops import rerank as trerank

    assert trerank._CALL.size == trerank.CONST["kCallBytes"]
    with open(tbeam.__file__.rsplit("/", 2)[0] + "/csrc/device_beam.cu") as f:
        head = int(re.search(r"constexpr int kMtHeadBytes = (\d+);",
                             f.read()).group(1))
    for t in range(1, tbeam.MT_MAX_TARGETS + 1):
        assert tbeam._MT_CALL[t].size == head + t * (8 * 8 + 11 * 4 + 2 * 4)
