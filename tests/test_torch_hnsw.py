"""Parity: the port's HNSW index (``weaviate_tpu_torch/index/hnsw/``,
``index/dynamic.py``) against the JAX package's, on the CPU.

Construction draws random levels and links in lockstep batches, so the
build and the walk are tested apart:

- ``HostGraph`` and ``HNSWCommitLog``: the same edits write byte-identical
  logs and equal snapshots, and each package replays the other's log.
- The same ``levels`` from the same seeded generator.
- Walks on one graph: a graph the JAX index built and flushed to
  ``graph.npz`` loads into the port, and the same queries give the same
  ids on >= 0.99 of the (query, rank) slots, distances within rtol 1e-5,
  on the host walk and on the fused walk (plain version on the CPU).
- The port's own builds clear the JAX tests' recall gates
  (``tests/test_hnsw.py`` shapes: 2000 x 32, M = 16, ef_construction 96,
  ef 64, recall@10 >= 0.95 against brute force).
- Tombstones are traversed but never returned; ``cleanup_tombstones``
  rewires around them; ``DynamicIndex`` cuts over to HNSW.
- Filtered search on the fused walk (the planner's ``PLAN_BEAM``): the
  ``keep_k`` and the allow mask that reach ``device_search`` are the JAX
  index's (padded to the capacity, a resident plane's device mirror), and
  ``tests/test_filter_planner.py``'s off-mesh sweep, cut to 2,000 rows,
  holds recall within 0.005 of the exact pre-filtered scan per plan.
- An HNSW DB directory written by one package opens in the other with the
  same uuids, after a close and after a crash that leaves a commit log.
"""

import os

import numpy as np
import pytest
import torch

from weaviate_tpu.core.db import DB as JaxDB
from weaviate_tpu.index.hnsw import HNSWIndex as JaxHNSW
from weaviate_tpu.index.hnsw.commitlog import HNSWCommitLog as JaxLog
from weaviate_tpu.index.hnsw.graph import HostGraph as JaxGraph
from weaviate_tpu.schema import config as jconfig
from weaviate_tpu.storage.objects import StorageObject as JaxObject
from weaviate_tpu_torch.core.db import DB
from weaviate_tpu_torch.index.dynamic import DynamicIndex
from weaviate_tpu_torch.index.hnsw import HNSWIndex
from weaviate_tpu_torch.index.hnsw.commitlog import HNSWCommitLog
from weaviate_tpu_torch.index.hnsw.graph import HostGraph
from weaviate_tpu_torch.ops import device_beam as tbeam
from weaviate_tpu_torch.schema import config
from weaviate_tpu_torch.storage.objects import StorageObject

N, DIMS, K = 2000, 32, 10
MIN_ID_AGREEMENT = 0.99
RECALL_GATE = 0.95  # tests/test_hnsw.py


def _cfg(mod, **kw):
    base = dict(distance="l2-squared", precision="fp32", max_connections=16,
                ef_construction=96, ef=64, flat_search_cutoff=50)
    return mod.HNSWIndexConfig(**{**base, **kw})


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain walk runs many small torch ops: one thread each, beside
    the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(11)
    vecs = rng.standard_normal((N, DIMS)).astype(np.float32)
    queries = rng.standard_normal((50, DIMS)).astype(np.float32)
    return vecs, queries


def brute_force(vecs, queries, k, metric="l2-squared"):
    if metric == "cosine":
        vecs = vecs / np.linalg.norm(vecs, axis=1, keepdims=True)
        queries = queries / np.linalg.norm(queries, axis=1, keepdims=True)
        d = -queries @ vecs.T
    else:
        d = ((queries[:, None, :] - vecs[None]) ** 2).sum(-1)
    return np.argsort(d, axis=1, kind="stable")[:, :k]


def recall(got, want):
    return sum(len(set(g[g >= 0]) & set(w)) for g, w in zip(got, want)) \
        / want.size


# -- graph and commit log ---------------------------------------------------


def _edit(graph_cls, log_cls, logdir, seed=3):
    """One seeded sequence of graph edits, logged."""
    rng = np.random.default_rng(seed)
    g = graph_cls(m=4, capacity=16)
    g.log = log_cls(logdir)
    for node in range(40):
        g.add_node(node, int(rng.integers(0, 3)))
    for node in range(40):
        for level in range(int(g.levels[node]) + 1):
            nb = rng.choice(40, size=g.width(level) // 2, replace=False)
            g.set_neighbors(level, node, nb[nb != node])
        # replay skips an edge the row has, so append a new one
        fresh = np.setdiff1d(np.arange(40), g.get_neighbors(0, node))
        g.append_neighbor(0, node, int(rng.choice(fresh)))
    for node in (3, 17, int(g.entrypoint)):
        g.add_tombstone(node)
    g.remove_node_hard(5)
    g.log.close()
    return g


def _arrays_equal(a, b):
    da, db = a.to_arrays(), b.to_arrays()
    assert da.keys() == db.keys()
    for key in da:
        np.testing.assert_array_equal(np.asarray(da[key]), np.asarray(db[key]),
                                      err_msg=key)


def test_graph_and_commit_log_write_what_jax_writes(tmp_path):
    tg = _edit(HostGraph, HNSWCommitLog, str(tmp_path / "t"))
    jg = _edit(JaxGraph, JaxLog, str(tmp_path / "j"))
    _arrays_equal(tg, jg)
    files = sorted(os.listdir(tmp_path / "t"))
    assert files == sorted(os.listdir(tmp_path / "j")) and files
    for f in files:
        assert (tmp_path / "t" / f).read_bytes() == \
            (tmp_path / "j" / f).read_bytes()
    # the snapshot format: either package loads the other's graph.npz
    for src, dst_cls in ((tg, JaxGraph), (jg, HostGraph)):
        path = tmp_path / f"{dst_cls.__module__}.npz"
        np.savez_compressed(path, **src.to_arrays())
        with np.load(path) as z:
            _arrays_equal(dst_cls.from_arrays({k: z[k] for k in z.files}), src)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_each_package_replays_the_others_log(tmp_path, writer):
    wg, wl, rg, rl = ((JaxGraph, JaxLog, HostGraph, HNSWCommitLog)
                      if writer == "jax" else
                      (HostGraph, HNSWCommitLog, JaxGraph, JaxLog))
    src = _edit(wg, wl, str(tmp_path / "log"))
    replayed = rg(m=4, capacity=16)
    applied = rl(str(tmp_path / "log")).replay_into(replayed)
    assert applied > 100
    _arrays_equal(replayed, src)
    assert replayed.tombstones == src.tombstones
    assert replayed.entrypoint == src.entrypoint


def test_levels_match_jax_for_the_same_seed():
    t = HNSWIndex(DIMS, _cfg(config), device="cpu")
    j = JaxHNSW(DIMS, _cfg(jconfig))
    for n in (1, 100, 4096):
        np.testing.assert_array_equal(t._level_for_new(n), j._level_for_new(n))


# -- walks on one graph -------------------------------------------------------


@pytest.fixture(scope="module")
def jax_built(corpus, tmp_path_factory):
    """A JAX build flushed to graph.npz, and the port index that loads it
    (vectors re-put: ``add_batch`` skips the nodes the graph has)."""
    vecs, _ = corpus
    path = str(tmp_path_factory.mktemp("jax_hnsw"))
    j = JaxHNSW(DIMS, _cfg(jconfig), path=path)
    j.add_batch(np.arange(N), vecs)
    j.flush()
    t = HNSWIndex(DIMS, _cfg(config), path=path, device="cpu")
    assert t.count() == N and t.graph.entrypoint == j.graph.entrypoint
    t.add_batch(np.arange(N), vecs)
    _arrays_equal(t.graph, j.graph)
    return j, t, path


@pytest.mark.parametrize("walk", ["host", "fused"])
def test_walks_on_a_jax_built_graph_match(corpus, jax_built, walk):
    from weaviate_tpu.ops import device_beam as jbeam

    vecs, queries = corpus
    j, t, path = jax_built
    if walk == "host":
        jr, tr = j.search(queries, K), t.search(queries, K)
    else:
        # the JAX fused walk on the same graph, and the port's index with
        # device_beam on (its plain version on the CPU)
        jd = JaxHNSW(DIMS, _cfg(jconfig, device_beam=True), path=path)
        jd.add_batch(np.arange(N), vecs)
        td = HNSWIndex(DIMS, _cfg(config, device_beam=True), path=path,
                       device="cpu")
        td.add_batch(np.arange(N), vecs)
        before = (jbeam.dispatch_count(), tbeam.dispatch_count())
        jr, tr = jd.search(queries, K), td.search(queries, K)
        assert jbeam.dispatch_count() - before[0] == 1
        assert tbeam.dispatch_count() - before[1] == 1
    same = tr.ids == jr.ids
    assert same.mean() >= MIN_ID_AGREEMENT, same.mean()
    np.testing.assert_allclose(tr.dists[same], jr.dists[same], rtol=1e-5,
                               atol=1e-5)
    assert recall(tr.ids, brute_force(vecs, queries, K)) >= RECALL_GATE


# -- the port's own builds ---------------------------------------------------


@pytest.mark.parametrize("metric", ["l2-squared", "cosine"])
def test_batched_construction_builds_the_jax_loops_graph(metric):
    """The port runs the selection heuristic's sort and accept loop on the
    device and links and backlinks in batched passes; the JAX index's
    loops (linking, heuristic, cleanup), bound to the same index, are the
    reference: the same graph, edge for edge, through inserts, deletes and
    cleanup."""
    import types

    vecs = np.random.default_rng(5).standard_normal((1000, 16)).astype(
        np.float32)
    graphs = []
    for loops in (False, True):
        idx = HNSWIndex(16, _cfg(config, distance=metric, max_connections=6,
                                 ef_construction=32, insert_batch=400),
                        device="cpu")
        if loops:
            for name in ("_select_heuristic_batch", "cleanup_tombstones"):
                setattr(idx, name,
                        types.MethodType(getattr(JaxHNSW, name), idx))
            # the JAX loops take the batch's levels (registered in the
            # graph by now) and read its pairwise block on the host
            idx._link_level = types.MethodType(
                lambda self, level, ids, sub, res_ids, res_d, bb:
                JaxHNSW._link_level(self, level, ids, self.graph.levels[ids],
                                    sub, res_ids, res_d, bb.cpu().numpy()),
                idx)
            idx._mesh_mirror = lambda: None
        idx.add_batch(np.arange(1000), vecs)
        idx.delete(np.arange(0, 1000, 5))
        idx.cleanup_tombstones()
        graphs.append(idx.graph)
    _arrays_equal(*graphs)


@pytest.fixture(scope="module")
def port_built(corpus):
    """The port's own build at the JAX gate's shapes, the fused walk at
    layer 0 of construction (its plain version on the CPU)."""
    vecs, _ = corpus
    idx = HNSWIndex(DIMS, _cfg(config, device_beam=True), device="cpu")
    idx.add_batch(np.arange(N), vecs)
    return idx


@pytest.mark.parametrize("walk", ["host", "fused"])
def test_port_build_clears_the_recall_gate(corpus, port_built, walk):
    vecs, queries = corpus
    idx = port_built
    want = brute_force(vecs, queries, K)
    idx._device_beam = (tbeam.DeviceAdjacency(idx.graph, "cpu")
                        if walk == "fused" else None)
    res = idx.search(queries, K)
    assert recall(res.ids, want) >= RECALL_GATE
    assert (np.diff(res.dists, axis=1) >= -1e-6).all()
    # a node queried by its own vector comes back first
    res = idx.search(vecs[123:124], K)
    assert res.ids[0, 0] == 123 and res.dists[0, 0] == pytest.approx(0, abs=1e-4)


def test_port_build_cosine_clears_the_recall_gate(corpus):
    vecs, queries = corpus
    idx = HNSWIndex(DIMS, _cfg(config, distance="cosine", device_beam=True),
                    device="cpu")
    idx.add_batch(np.arange(1000), vecs[:1000])
    want = brute_force(vecs[:1000], queries, K, metric="cosine")
    assert recall(idx.search(queries, K).ids, want) >= RECALL_GATE


@pytest.mark.parametrize("beam", [False, True], ids=["host", "fused"])
def test_tombstones_traversed_never_returned_then_cleaned(corpus, beam):
    vecs, queries = corpus
    idx = HNSWIndex(DIMS, _cfg(config, ef_construction=64, device_beam=beam),
                    device="cpu")
    idx.add_batch(np.arange(1000), vecs[:1000])
    dead = np.arange(0, 1000, 4)
    idx.delete(dead)
    assert idx.count() == 750 and len(idx.graph.tombstones) == 250
    res = idx.search(queries, K)
    assert not set(res.ids.ravel().tolist()) & set(dead.tolist())
    live = np.setdiff1d(np.arange(1000), dead)
    want = live[brute_force(vecs[live], queries, K)]
    assert recall(res.ids, want) >= 0.9
    assert idx.cleanup_tombstones() == 250
    assert not idx.graph.tombstones and idx.count() == 750
    assert not (set(idx.graph.layer0[idx.graph.levels >= 0].ravel().tolist())
                & set(dead.tolist()))
    assert recall(idx.search(queries, K).ids, want) >= 0.9


def test_dynamic_index_cuts_over_to_hnsw(corpus):
    vecs, queries = corpus
    idx = DynamicIndex(DIMS, config.DynamicIndexConfig(
        distance="l2-squared", precision="fp32", threshold=500,
        hnsw={"max_connections": 16, "ef_construction": 64, "ef": 64,
              "device_beam": True}), device="cpu")
    idx.add_batch(np.arange(300), vecs[:300])
    assert not idx.upgraded and idx.stats()["type"] == "dynamic[flat]"
    want = brute_force(vecs[:300], queries, K)
    assert recall(idx.search(queries, K).ids, want) == 1.0
    idx.add_batch(np.arange(300, 1000), vecs[300:1000])
    assert idx.wait_cutover(timeout=120.0)
    assert idx.upgraded and idx.stats()["type"] == "dynamic[hnsw]"
    assert isinstance(idx.inner, HNSWIndex) and idx.inner._device_beam
    assert idx.count() == 1000
    # the graph was built over the flat index's store: no copy of the corpus
    assert str(idx.inner.store.device) == "cpu"
    want = brute_force(vecs[:1000], queries, K)
    assert recall(idx.search(queries, K).ids, want) >= RECALL_GATE


# -- filtered search on the fused walk ----------------------------------------


@pytest.fixture(scope="module")
def beam_pair(corpus, jax_built):
    """The JAX index and the port's, both with the fused walk on, on the
    JAX build's graph."""
    vecs, _ = corpus
    _, _, path = jax_built
    jd = JaxHNSW(DIMS, _cfg(jconfig, device_beam=True), path=path)
    jd.add_batch(np.arange(N), vecs)
    td = HNSWIndex(DIMS, _cfg(config, device_beam=True), path=path,
                   device="cpu")
    td.add_batch(np.arange(N), vecs)
    assert td.graph.capacity == jd.graph.capacity
    return jd, td


def _walk_call_args(monkeypatch, jd, td, queries, jallow, tallow):
    """The arguments each index's filtered search hands ``device_search``,
    and the two results."""
    from weaviate_tpu.ops import device_beam as jbeam

    seen = {}

    def spy(mod, key):
        real = mod.device_search

        def wrapped(*a, **kw):
            seen[key] = kw
            return real(*a, **kw)
        monkeypatch.setattr(mod, "device_search", wrapped)

    spy(jbeam, "jax")
    spy(tbeam, "torch")
    jr = jd.search(queries, K, allow_list=jallow)
    tr = td.search(queries, K, allow_list=tallow)
    return seen["jax"], seen["torch"], jr, tr


def _same_result(jr, tr, allowed):
    same = tr.ids == jr.ids
    assert same.mean() >= MIN_ID_AGREEMENT, same.mean()
    np.testing.assert_allclose(tr.dists[same], jr.dists[same], rtol=1e-5,
                               atol=1e-5)
    live = tr.ids[tr.ids >= 0]
    assert len(live) and allowed[live].all()


def test_kept_track_is_fetch_pad_wide_with_a_short_allow_list(
        corpus, beam_pair, monkeypatch):
    """Divergence 1 and 2 of an ad-hoc mask shorter than the capacity: the
    kept track is ``fetch_pad`` wide (32 for k = 10, not fetch = 20) and
    the mask reaches the walk zero-padded to the graph's capacity, as in
    the JAX index."""
    vecs, queries = corpus
    jd, td = beam_pair
    allow = np.arange(N) % 2 == 0
    assert len(allow) < td.graph.capacity
    jkw, tkw, jr, tr = _walk_call_args(monkeypatch, jd, td, queries, allow,
                                       allow)
    assert tkw["keep_k"] == jkw["keep_k"] == 32
    assert tkw["expand"] == jkw["expand"]
    ta, ja = np.asarray(tkw["allow"]), np.asarray(jkw["allow"])
    assert ta.dtype == bool and len(ta) == td.graph.capacity
    np.testing.assert_array_equal(ta, ja)
    _same_result(jr, tr, allow)


def test_resident_plane_reaches_the_walk_as_its_device_mask(
        corpus, beam_pair, monkeypatch):
    """Divergence 2 for a resident plane: the walk gets the plane's cached
    device mirror at the graph's capacity (``plane.device_mask(cap)``), the
    same bits as the JAX plane's."""
    from weaviate_tpu.inverted.filters import Where as JWhere
    from weaviate_tpu.query.planner import FilterPlane as JPlane
    from weaviate_tpu_torch.inverted.filters import Where
    from weaviate_tpu_torch.query.planner import FilterPlane

    vecs, queries = corpus
    jd, td = beam_pair
    mask = np.arange(N) % 3 != 0
    jplane, tplane = JPlane(JWhere.lt("n", 2)), FilterPlane(
        Where.lt("n", 2), device="cpu")
    jplane.rebuild(mask)
    tplane.rebuild(mask)
    jkw, tkw, jr, tr = _walk_call_args(monkeypatch, jd, td, queries, jplane,
                                       tplane)
    cap = td.graph.capacity
    assert tkw["allow"] is tplane.device_mask(cap)
    assert tkw["keep_k"] == jkw["keep_k"]
    np.testing.assert_array_equal(tkw["allow"].numpy(),
                                  np.asarray(jkw["allow"]))
    _same_result(jr, tr, mask)


# tests/test_filter_planner.py's off-mesh sweep, cut to 2,000 rows: 100
# blobs of 20 docs, queries near their allowed blobs (the tenant-search
# shape). ef 64 and M 8 keep the planner's cost race where the JAX test's
# 6,000 rows put it: the beam from 1% to 50%.
N_F, D_F, BLOB_F = 2_000, 16, 20


@pytest.fixture(scope="module")
def blob_index():
    rng = np.random.default_rng(7)
    centers = rng.standard_normal((N_F // BLOB_F, D_F)).astype(np.float32)
    grp = np.arange(N_F) % (N_F // BLOB_F)
    vecs = (centers[grp]
            + 0.15 * rng.standard_normal((N_F, D_F))).astype(np.float32)
    idx = HNSWIndex(D_F, config.HNSWIndexConfig(
        distance="l2-squared", precision="fp32", max_connections=8,
        ef_construction=64, ef=64, flat_search_cutoff=15,
        filter_flat_selectivity=0.002, device_beam=True), device="cpu")
    idx.add_batch(np.arange(N_F), vecs)
    return idx, vecs, grp, rng


def _plan_case(idx, vecs, grp, rng, mask, blobs, want_plan, use_plane, tag,
               expect_dispatch=None):
    """One filtered batch: the plan taken, the dispatches, no disallowed id,
    recall@10 within 0.005 of the exact pre-filtered scan."""
    from weaviate_tpu_torch.inverted.filters import Where
    from weaviate_tpu_torch.monitoring.metrics import PLANNER_PLANS
    from weaviate_tpu_torch.query.planner import (
        PLAN_BEAM, PLAN_EXACT, PLAN_OVERFETCH, PLAN_UNFILTERED, FilterPlane)

    plans = (PLAN_UNFILTERED, PLAN_EXACT, PLAN_BEAM, PLAN_OVERFETCH)
    rows = np.concatenate([np.nonzero(grp == b)[0] for b in blobs])
    pick = rng.choice(rows, 16, replace=False)
    q = (vecs[pick] + 0.05 * rng.standard_normal(
        (16, D_F))).astype(np.float32)
    allow = mask
    if use_plane:
        allow = FilterPlane(Where.eq("fixture", tag), device="cpu")
        allow.rebuild(mask)
    snap = {p: PLANNER_PLANS.value(plan=p) for p in plans}
    d0 = tbeam.dispatch_count()
    res = idx.search(q, K, allow_list=allow)
    delta = {p: PLANNER_PLANS.value(plan=p) - snap[p] for p in plans
             if PLANNER_PLANS.value(plan=p) > snap[p]}
    assert delta == {want_plan: 1}, (tag, delta)
    if expect_dispatch is not None:
        assert tbeam.dispatch_count() - d0 == expect_dispatch, tag
    live = res.ids[res.ids >= 0]
    assert len(live) and mask[live].all(), (tag, "disallowed id leaked")
    allowed = np.nonzero(mask)[0]
    d2 = ((q[:, None, :] - vecs[allowed][None]) ** 2).sum(-1)
    want = allowed[np.argsort(d2, axis=1, kind="stable")[:, :K]]
    hit = sum(len(set(g[g >= 0].tolist()) & set(w.tolist()))
              for g, w in zip(res.ids, want))
    r = hit / (len(want) * min(K, len(allowed)))
    assert r >= 1.0 - 0.005, (tag, r)


def test_parity_sweep_off_mesh(blob_index):
    """Port of ``tests/test_filter_planner.py::test_parity_sweep_off_mesh``:
    each selectivity's plan reaches recall@10 within 0.005 of the exact
    pre-filtered scan, plane and ad-hoc mask, per plan type."""
    from weaviate_tpu_torch.query.planner import PLAN_BEAM, PLAN_EXACT

    idx, vecs, grp, rng = blob_index
    # 0.1%: 2 allowed docs <= k -> the exact guard
    tiny = np.zeros(N_F, bool)
    tiny[np.nonzero(grp == 7)[0][:2]] = True
    _plan_case(idx, vecs, grp, rng, tiny, [7], PLAN_EXACT, False,
               "sel=0.001", expect_dispatch=0)
    # 1%: one blob; the cost race picks the filtered beam (expansion 2)
    _plan_case(idx, vecs, grp, rng, grp == 7, [7], PLAN_BEAM, False,
               "sel=0.01/mask")
    _plan_case(idx, vecs, grp, rng, grp == 7, [7], PLAN_BEAM, True,
               "sel=0.01/plane")
    # 10% and 50%: the beam with and without residency
    _plan_case(idx, vecs, grp, rng, grp < 10, range(10), PLAN_BEAM, True,
               "sel=0.10/plane")
    _plan_case(idx, vecs, grp, rng, grp < 50, range(50), PLAN_BEAM, True,
               "sel=0.50/plane")
    _plan_case(idx, vecs, grp, rng, grp < 50, range(50), PLAN_BEAM, False,
               "sel=0.50/mask")


def test_one_dispatch_at_one_percent_off_mesh(blob_index):
    """Port of ``tests/test_filter_planner.py::
    test_one_dispatch_at_one_percent_off_mesh``: 1% allowed, the filtered
    beam, exactly one walk for the whole batch, recall within 0.005."""
    from weaviate_tpu_torch.query.planner import PLAN_BEAM

    idx, vecs, grp, rng = blob_index
    _plan_case(idx, vecs, grp, rng, grp == 13, [13], PLAN_BEAM, True,
               "one-dispatch", expect_dispatch=1)


# -- the DB directory crosses ----------------------------------------------


def _records(n=600, seed=5):
    rng = np.random.default_rng(seed)
    vecs = rng.standard_normal((n, DIMS)).astype(np.float32)
    recs = []
    for i in range(n):
        u = rng.bytes(16).hex()
        recs.append(dict(
            uuid=f"{u[:8]}-{u[8:12]}-4{u[13:16]}-8{u[17:20]}-{u[20:32]}",
            collection="Doc", vector=vecs[i],
            properties={"bucket": i % 10}, creation_time_ms=1,
            update_time_ms=1))
    return recs


def _collection_cfg(mod):
    return mod.CollectionConfig(
        name="Doc", properties=[mod.Property("bucket", mod.DataType.INT)],
        vector_config=_cfg(mod, ef_construction=64, max_connections=8,
                           insert_batch=128))


def _open(mod, root):
    return JaxDB(root) if mod == "jax" else DB(root, device="cpu")


def _uuids(col, queries):
    return [[o.uuid for o, _ in row]
            for row in col.vector_search_batch(queries, K)]


def _crash_leaving_commit_logs(db):
    """Objects and delta logs durable, the HNSW graphs not condensed: the
    commit logs carry the edits since the last snapshot."""
    pending = 0
    for col in db._collections.values():
        for shard in col._shards.values():
            shard.async_queue.flush()
            shard._delta.flush()
            shard.store.flush_all()
            shard._persist_counter()
            shard._persist_meta()
            for idx in shard._vector_indexes.values():
                idx._commitlog.flush()
                pending += idx._commitlog.pending_bytes
    db.cycles.stop()
    return pending


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("how", ["close", "crash"])
def test_hnsw_db_directory_opens_in_the_other_package(tmp_path, writer, how):
    mod = jconfig if writer == "jax" else config
    cls = JaxObject if writer == "jax" else StorageObject
    recs = _records()
    root = str(tmp_path / "db")
    db = _open(writer, root)
    col = db.create_collection(_collection_cfg(mod))
    col.put_batch([cls(**r) for r in recs[:400]])
    db.flush()  # a graph snapshot; the rest rides the commit log
    col.put_batch([cls(**r) for r in recs[400:]])
    q = np.stack([r["vector"] for r in recs[:16]]) + 0.05
    want = _uuids(col, q)
    assert all(len(r) == K for r in want)
    if how == "close":
        db.close()
    else:
        assert _crash_leaving_commit_logs(db) > 0
    reader = "torch" if writer == "jax" else "jax"
    db2 = _open(reader, root)
    try:
        col2 = db2.get_collection("Doc")
        assert col2.count() == len(recs)
        idx = next(iter(col2._shards.values())).vector_index()
        assert type(idx).__name__ == "HNSWIndex" and idx.count() == len(recs)
        assert _uuids(col2, q) == want
    finally:
        db2.close()


# -- quantized backends: HNSW + BQ / SQ (slice 4a) -----------------------------


def _clustered(seed, n, d, clusters=32, spread=0.15):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((clusters, d)).astype(np.float32)
    assign = rng.integers(0, clusters, size=n)
    return (centers[assign] + spread * rng.standard_normal((n, d))).astype(
        np.float32)


def _qcfg(mod, kind, **kw):
    quant = {"bq": mod.BQConfig(rescore_limit=60),
             "sq": mod.SQConfig(rescore_limit=60)}[kind]
    base = dict(distance="l2-squared", ef=32, ef_construction=48,
                max_connections=8, insert_batch=400, flat_search_cutoff=0,
                quantizer=quant)
    return mod.HNSWIndexConfig(**{**base, **kw})


def _recall(ids, gt):
    k = gt.shape[1]
    return float(np.mean([len(set(ids[i]) & set(gt[i])) / k
                          for i in range(len(gt))]))


@pytest.mark.parametrize("kind,metric,beam", [
    ("bq", "l2-squared", True), ("bq", "cosine", False),
    ("sq", "l2-squared", True), ("sq", "cosine", True),
])
def test_quantized_construction_builds_the_jax_graph(kind, metric, beam):
    """HNSW + BQ/SQ builds the JAX index's graph edge for edge: the upper
    levels on the host walk in code space, layer 0 in the fused walk's
    plain version (when on), the selection heuristic over exact pairwise
    distances of the originals (``pairwise_device``, float32 products of
    the same rows). Through deletes, the searches return JAX's ids."""
    vecs = _clustered(21, 1000, 32)
    q = vecs[::50][:16] + 0.02
    j = JaxHNSW(32, _qcfg(jconfig, kind, distance=metric, device_beam=beam))
    t = HNSWIndex(32, _qcfg(config, kind, distance=metric, device_beam=beam),
                  device="cpu")
    for idx in (j, t):
        idx.add_batch(np.arange(1000), vecs)
    _arrays_equal(j.graph, t.graph)
    assert t.store is None and t.backend.quantized
    for idx in (j, t):
        idx.delete(np.arange(0, 1000, 4))
    jr, tr = j.search(q, 10), t.search(q, 10)
    np.testing.assert_array_equal(tr.ids, jr.ids)
    np.testing.assert_allclose(tr.dists, jr.dists, rtol=1e-5, atol=1e-5)
    assert not np.isin(tr.ids, np.arange(0, 1000, 4)).any()
    st = t.stats()
    assert (st["quantizer"], st["fitted"]) == (kind, True)
    assert st["codes_hbm_bytes"] == t.backend.codes.nbytes > 0
    assert not t.save_vectors("unused") and t.load_vectors("unused") is None


@pytest.mark.parametrize("kind,floor", [("sq", 0.90), ("bq", 0.80)])
def test_quantized_search_is_one_dispatch_at_host_walk_recall(kind, floor):
    """The contract of ``tests/test_device_beam_quantized.py``: the whole
    walk of a batch in one dispatch, recall@10 within 0.005 of the host
    walk on the same index; tombstones traversable, never returned; a
    filtered walk keeps allowed ids only."""
    from weaviate_tpu_torch.ops import device_beam as beam

    corpus = _clustered(22, 1200, 32)
    idx = HNSWIndex(32, _qcfg(config, kind, ef=64, ef_construction=96,
                              max_connections=16, insert_batch=1024,
                              device_beam=True), device="cpu")
    idx.add_batch(np.arange(1200), corpus)
    rng = np.random.default_rng(23)
    q = (corpus[rng.choice(1200, 24, replace=False)]
         + 0.02 * rng.standard_normal((24, 32))).astype(np.float32)
    before = beam.dispatch_count()
    dev = idx.search(q, 10)
    assert beam.dispatch_count() - before == 1
    gt = brute_force(corpus, q, 10)
    saved = idx._device_beam
    idx._device_beam = None
    try:
        host = idx.search(q, 10)
    finally:
        idx._device_beam = saved
    assert _recall(dev.ids, gt) >= floor
    assert _recall(dev.ids, gt) >= _recall(host.ids, gt) - 0.005

    allow = np.zeros(idx.graph.capacity, bool)
    allow[rng.choice(1200, 720, replace=False)] = True
    idx.config.flat_search_cutoff = 10
    idx.config.ef = 48
    before = beam.dispatch_count()
    res = idx.search(q, 10, allow_list=allow)
    assert beam.dispatch_count() - before == 1
    live = res.ids[res.ids >= 0]
    assert len(live) and allow[live].all()

    dead = np.arange(0, 1200, 3)
    idx.delete(dead)
    for al in (None, np.ones(idx.graph.capacity, bool)):
        res = idx.search(q, 20, allow_list=al)
        live = res.ids[res.ids >= 0]
        assert len(live) and not np.isin(live, dead).any()


def test_unfitted_or_demoted_codes_take_the_host_path():
    """Lifecycle states, not fallbacks: before the SQ quantizer trains the
    walk runs on the host over the originals, and the first search after
    training takes the device walk; demoted codes are served on the warm
    tier (host originals); neither launches the fused walk."""
    from weaviate_tpu_torch.ops import device_beam as beam

    corpus = _clustered(24, 1200, 32)
    idx = HNSWIndex(32, _qcfg(config, "sq", device_beam=True), device="cpu")
    idx.add_batch(np.arange(64), corpus[:64])
    assert not idx.backend.quantizer.fitted
    assert idx.backend.device_scorer() is None
    before = beam.dispatch_count()
    res = idx.search(corpus[:4], 5)
    assert beam.dispatch_count() == before
    np.testing.assert_array_equal(res.ids[:, 0], np.arange(4))
    idx.add_batch(np.arange(64, 1200), corpus[64:])
    assert idx.backend.quantizer.fitted
    before = beam.dispatch_count()
    res = idx.search(corpus[:4], 5)
    assert beam.dispatch_count() - before == 1
    np.testing.assert_array_equal(res.ids[:, 0], np.arange(4))
    assert idx.demote_device() > 0 and not idx.device_resident
    assert idx.backend.device_scorer() is None
    before = beam.dispatch_count()
    res = idx.search(corpus[:4], 5)
    assert beam.dispatch_count() == before
    np.testing.assert_array_equal(res.ids[:, 0], np.arange(4))
    assert idx.promote_device() > 0
    idx.search(corpus[:4], 5)
    assert beam.dispatch_count() - before == 1


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_quantized_index_directory_opens_in_the_other_package(tmp_path,
                                                               writer):
    """``graph.npz`` + ``quantizer.msgpack`` written by one package open in
    the other: the same graph and quantizer state, and, once the codes are
    rebuilt from the vectors, the same answers."""
    vecs = _clustered(25, 800, 32)
    q = vecs[::40] + 0.02
    path = str(tmp_path / "idx")
    mods = {"jax": (JaxHNSW, jconfig), "torch": (HNSWIndex, config)}
    cls, mod = mods[writer]
    kw = {} if writer == "jax" else {"device": "cpu"}
    w = cls(32, _qcfg(mod, "sq", distance="cosine"), path=path, **kw)
    w.add_batch(np.arange(800), vecs)
    want = w.search(q, 10)
    w.close()
    assert os.path.exists(os.path.join(path, "quantizer.msgpack"))
    cls, mod = mods["torch" if writer == "jax" else "jax"]
    kw = {"device": "cpu"} if writer == "jax" else {}
    r = cls(32, _qcfg(mod, "sq", distance="cosine"), path=path, **kw)
    _arrays_equal(r.graph, w.graph)
    assert r.backend.quantizer.state_dict() == w.backend.quantizer.state_dict()
    r.add_batch(np.arange(800), vecs)  # codes rebuild; nodes are present
    _arrays_equal(r.graph, w.graph)
    got = r.search(q, 10)
    np.testing.assert_array_equal(got.ids, want.ids)
    np.testing.assert_allclose(got.dists, want.dists, rtol=1e-5, atol=1e-5)
