"""Parity: the port's fused HNSW walk (``weaviate_tpu_torch/ops/
device_beam.py``) against the JAX package's ``device_search``, on the CPU.

- ``DeviceAdjacency.sync``/``sync_upper`` give the JAX mirror's arrays for
  the same ``HostGraph``, after incremental inserts too.
- The plain ``_fused_search`` (the CUDA kernel's plain version) against
  JAX ``device_search`` on a graph the JAX index built: with and without
  upper tables, l2-squared fp32 and cosine bf16, with tombstoned and
  absent nodes, and with ``max_steps`` binding. Same ids on >= 0.99 of the
  (query, rank) slots; distances of matched slots within rtol 1e-5 (fp32)
  and 1e-3 (bf16): both sides sum the same float32 (or bf16-rounded)
  products, in another order.
- The filtered walk (``allow``/``keep_k``/``expand``, the kept track and
  the two-hop widening) against JAX ``device_search``: l2-squared fp32 and
  cosine bf16, ``expand`` 0/1/2/4, ``keep_k`` 8/32, allow masks at 1%,
  10% and 50%, tombstoned and absent nodes and a binding ``max_steps``.
  Beam and kept ids equal, distances within 1e-5.
- The quantized scorers: the plain walk with ``BQScorer`` (packed sign
  bits) equals JAX's exactly, ids and distances (integer distances, and
  ties on nearly every hop at D = 16); with ``SQScorer`` (byte codes) for
  l2-squared, dot and cosine the ids agree on >= 0.99 of the slots and
  matched distances within 1e-5 (float32 sums of the same bf16 products in
  another order); so with ``PQScorer`` (codes through JAX-trained
  codebooks) and ``RQScorer`` (rotated queries against per-row affine
  codes). Filtered walks included, and the widths the kernel's code-row
  paths branch on: PQ at config 3's 96 segments of 16, an SQ row of 99
  bytes (not a multiple of 16), and a filtered SQ walk whose frontier is
  160 (M0 32, expand 4). All four row types pass the kernel's argument
  checks.
- ``dispatch_count()`` goes up by exactly one per launch of a search: one
  for a batch whose visited bitsets fit the budget.
- The rerank stage after the walk (slice 7a) answers as JAX's; the
  kernel's argument checks refuse what it does not take; ``probe_device_beam.py``'s
  clock64 copy still applies to the kernel source.

The JAX side compiles one program per shape and static arguments, so the
cases share a few.
"""

import numpy as np
import pytest
import torch

from weaviate_tpu.index.hnsw import HNSWIndex as JaxHNSW
from weaviate_tpu.ops import device_beam as jbeam
from weaviate_tpu.schema import config as jconfig
from weaviate_tpu_torch.index.hnsw import HNSWIndex
from weaviate_tpu_torch.index.hnsw.graph import HostGraph
from weaviate_tpu_torch.ops import device_beam as tbeam
from weaviate_tpu_torch.schema import config

import probe_device_beam as probe

N, DIMS, B, EF = 1500, 16, 16, 32
MIN_ID_AGREEMENT = 0.99
RTOL = {"fp32": 1e-5, "bf16": 1e-3}
# the filtered walk: ids equal, distances within this (both sides sum the
# same float32 or bf16-rounded products of D = 16, in another order)
FILTERED_TOL = 1e-5
SELECTIVITIES = (0.01, 0.1, 0.5)


def _vectors(seed, n, d=DIMS):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain walk runs many small torch ops: one thread each, beside
    the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def jax_index():
    """A JAX HNSW build (host walk) over N seeded rows: its graph feeds
    both walks."""
    import jax.numpy as jnp  # noqa: F401  (JAX on the CPU, conftest)

    idx = JaxHNSW(DIMS, jconfig.HNSWIndexConfig(
        distance="l2-squared", precision="fp32", max_connections=8,
        ef_construction=48, ef=EF))
    idx.add_batch(np.arange(N), _vectors(1, N))
    return idx


def _walk_inputs(graph, corpus, normalize):
    """Both packages' device inputs for one graph: (jax tuple, torch
    tuple) of (queries, corpus, adjacency, present, eps, upper, slots)."""
    import jax.numpy as jnp

    jm = jbeam.DeviceAdjacency(graph)
    adj, present = jm.sync()
    ua, us = jm.sync_upper()
    q = _vectors(5, B)
    c = corpus
    if normalize:
        q = q / np.linalg.norm(q, axis=1, keepdims=True)
        # capacity rows past the corpus are zeros: keep them finite
        c = c / np.maximum(np.linalg.norm(c, axis=1, keepdims=True), 1e-12)
    eps = np.full(B, graph.entrypoint, np.int32)
    j = (jnp.asarray(q), jnp.asarray(c), adj, present, eps, ua, us)
    t = tuple(torch.from_numpy(np.array(a)) for a in (q, c, adj, present, eps,
                                                       ua, us))
    return j, t


def _compare(jout, tout, precision):
    ji, jd = (np.asarray(a) for a in jout)
    ti, td = (a.numpy() for a in tout)
    assert ti.shape == ji.shape and ti.dtype == np.int32
    same = ti == ji
    assert same.mean() >= MIN_ID_AGREEMENT, same.mean()
    live = same & (ji >= 0)
    np.testing.assert_allclose(td[live], jd[live], rtol=RTOL[precision],
                               atol=1e-6)
    return same.mean()


@pytest.mark.parametrize("metric,precision", [("l2-squared", "fp32"),
                                              ("cosine", "bf16")])
@pytest.mark.parametrize("upper", [True, False], ids=["upper", "layer0"])
def test_plain_walk_matches_jax_device_search(jax_index, metric, precision,
                                              upper):
    g = jax_index.graph
    corpus = np.asarray(jax_index.store.corpus)[: g.capacity]
    (jq, jc, jadj, jpres, jeps, jua, jus), (tq, tc, tadj, tpres, teps, tua,
                                            tus) = _walk_inputs(
        g, corpus, metric == "cosine")
    if not upper:
        jua = jus = None
        tua, tus = tbeam._empty_upper("cpu")
    jout = jbeam.device_search(
        jbeam.RawScorer(metric, precision), jq, (jc,), jadj, jpres, jeps,
        ef=EF, max_steps=4 * EF + 64, upper_adj=jua, upper_slots=jus)
    tout = tbeam._fused_search(
        tbeam.RawScorer(metric, precision), tq, (tc,), tadj, tpres, teps,
        tua, tus, EF, 4 * EF + 64)
    _compare(jout, tout, precision)


def test_plain_walk_tombstones_absent_nodes_and_max_steps(jax_index):
    """Tombstoned nodes stay present and traversable; hard-removed nodes are
    absent (present False) and never scored; a small max_steps cuts both
    the descent and the beam."""
    import jax.numpy as jnp

    g = HostGraph.from_arrays(jax_index.graph.to_arrays())
    for node in range(0, N, 7):
        g.add_tombstone(node)
    for node in range(3, N, 11):
        if node != g.entrypoint:
            g.levels[node] = -1  # absent: present False, edges to it stay
    corpus = np.asarray(jax_index.store.corpus)[: g.capacity]
    (jq, jc, jadj, jpres, jeps, jua, jus), (tq, tc, tadj, tpres, teps, tua,
                                            tus) = _walk_inputs(g, corpus, False)
    assert not bool(np.asarray(jpres)[3])
    sc = ("l2-squared", "fp32")
    beams = []
    for steps in (4 * EF + 64, 5):
        jout = jbeam.device_search(
            jbeam.RawScorer(*sc), jq, (jc,), jadj, jpres, jeps, ef=EF,
            max_steps=steps, upper_adj=jua, upper_slots=jus)
        tout = tbeam._fused_search(tbeam.RawScorer(*sc), tq, (tc,), tadj,
                                   tpres, teps, tua, tus, EF, steps)
        _compare(jout, tout, "fp32")
        ids = tout[0].numpy()
        absent = ~np.asarray(jpres)
        assert not absent[ids[ids >= 0]].any()
        beams.append(ids)
    # max_steps binds: five expansions leave another beam than the full walk
    assert not np.array_equal(beams[0], beams[1])
    # the tombstoned nodes are traversed: some come back from the walk
    assert np.isin(ids, np.arange(0, N, 7)).any()


def _allow_mask(n, selectivity, seed=9):
    return np.random.default_rng(seed).random(n) < selectivity


def _compare_filtered(jout, tout):
    """Beam and kept track: ids equal, distances within FILTERED_TOL."""
    assert len(jout) == len(tout) == 4
    for ja, ta in zip(jout, tout):
        ja, ta = np.asarray(ja), ta.numpy()
        assert ta.shape == ja.shape and ta.dtype == ja.dtype
        if ja.dtype == np.int32:
            np.testing.assert_array_equal(ta, ja)
        else:
            np.testing.assert_allclose(ta, ja, rtol=FILTERED_TOL,
                                       atol=FILTERED_TOL)


@pytest.mark.parametrize("metric,precision,expand,keep_k", [
    ("l2-squared", "fp32", 0, 8), ("l2-squared", "fp32", 1, 32),
    ("l2-squared", "fp32", 2, 8), ("l2-squared", "fp32", 4, 32),
    ("cosine", "bf16", 0, 32), ("cosine", "bf16", 1, 8),
    ("cosine", "bf16", 2, 32), ("cosine", "bf16", 4, 8),
])
def test_plain_filtered_walk_matches_jax(jax_index, metric, precision,
                                         expand, keep_k):
    """The kept track and the two-hop widening at 1%, 10% and 50% allowed:
    the same beam and kept track as JAX ``_fused_search``."""
    import jax.numpy as jnp

    g = jax_index.graph
    corpus = np.asarray(jax_index.store.corpus)[: g.capacity]
    (jq, jc, jadj, jpres, jeps, jua, jus), (tq, tc, tadj, tpres, teps, tua,
                                            tus) = _walk_inputs(
        g, corpus, metric == "cosine")
    kept = []
    for sel in SELECTIVITIES:
        allow = _allow_mask(g.capacity, sel)
        jout = jbeam.device_search(
            jbeam.RawScorer(metric, precision), jq, (jc,), jadj, jpres, jeps,
            ef=EF, max_steps=4 * EF + 64, upper_adj=jua, upper_slots=jus,
            allow=jnp.asarray(allow), keep_k=keep_k, expand=expand)
        tout = tbeam.fused_search(
            tbeam.RawScorer(metric, precision), tq, (tc,), tadj, tpres, teps,
            tua, tus, EF, 4 * EF + 64, allow=torch.from_numpy(allow),
            keep_k=keep_k, expand=expand)
        _compare_filtered(jout, tout)
        ids = tout[2].numpy()
        assert allow[ids[ids >= 0]].all()
        kept.append(int((ids >= 0).sum()))
    # the track fills as the filter opens
    assert 0 < kept[0] <= kept[-1] == B * keep_k


def test_plain_filtered_walk_tombstones_absent_nodes_and_max_steps(jax_index):
    """Tombstoned nodes stay traversable and may be kept; absent nodes are
    neither scored nor kept; a binding max_steps cuts the filtered walk."""
    import jax.numpy as jnp

    g = HostGraph.from_arrays(jax_index.graph.to_arrays())
    for node in range(0, N, 7):
        g.add_tombstone(node)
    for node in range(3, N, 11):
        if node != g.entrypoint:
            g.levels[node] = -1
    corpus = np.asarray(jax_index.store.corpus)[: g.capacity]
    (jq, jc, jadj, jpres, jeps, jua, jus), (tq, tc, tadj, tpres, teps, tua,
                                            tus) = _walk_inputs(g, corpus, False)
    allow = _allow_mask(g.capacity, 0.1)
    sc = ("l2-squared", "fp32")
    kept = []
    for steps in (4 * EF + 64, 5):
        jout = jbeam.device_search(
            jbeam.RawScorer(*sc), jq, (jc,), jadj, jpres, jeps, ef=EF,
            max_steps=steps, upper_adj=jua, upper_slots=jus,
            allow=jnp.asarray(allow), keep_k=16, expand=2)
        tout = tbeam._fused_search(
            tbeam.RawScorer(*sc), tq, (tc,), tadj, tpres, teps, tua, tus, EF,
            steps, allow=torch.from_numpy(allow), keep_k=16, expand=2)
        _compare_filtered(jout, tout)
        ids = tout[2].numpy()
        assert not (~np.asarray(jpres))[ids[ids >= 0]].any()
        kept.append(ids)
    assert not np.array_equal(kept[0], kept[1])
    assert np.isin(kept[0], np.arange(0, N, 7)).any()


def test_device_adjacency_matches_jax_mirror_after_inserts():
    jidx = JaxHNSW(DIMS, jconfig.HNSWIndexConfig(
        distance="l2-squared", precision="fp32", max_connections=8,
        ef_construction=32, insert_batch=128))
    vecs = _vectors(2, 700)
    jidx.add_batch(np.arange(300), vecs[:300])
    g = jidx.graph
    jm, tm = jbeam.DeviceAdjacency(g), tbeam.DeviceAdjacency(g, "cpu")

    def check():
        ja, jp = jm.sync()
        ta, tp = tm.sync()
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        jua, jus = jm.sync_upper()
        tua, tus = tm.sync_upper()
        np.testing.assert_array_equal(tua.numpy(), np.asarray(jua))
        np.testing.assert_array_equal(tus.numpy(), np.asarray(jus))
        assert ta.dtype == torch.int32 and tp.dtype == torch.bool

    check()
    g.dirty_hook = lambda *n: (jm.mark_dirty(*n), tm.mark_dirty(*n))
    first = tm.sync()[0]
    jidx.add_batch(np.arange(300, 500), vecs[300:500])   # dirty rows
    check()
    # the dirty-row scatter is out of place: a walk holding the old tensor
    # keeps it
    assert tm.sync()[0] is not first
    jidx.delete(np.arange(0, 40))
    jidx.add_batch(np.arange(500, 700), vecs[500:700])   # may grow capacity
    check()
    assert tm.nbytes > 0
    assert tm.drop_device() > 0 and tm.nbytes == 0
    check()
    # an edge to a node past the capacity read (a torn read during a
    # grow) reaches the mirror as -1, never as an index past its rows
    node = int(np.flatnonzero(g.levels >= 0)[0])
    g.layer0[node, 0] = g.capacity + 3
    tm.mark_dirty(node)
    assert int(tm.sync()[0][node, 0]) == -1


def test_dispatch_count_is_one_per_sub_batch(monkeypatch):
    """One launch a search while the rows' visited bitsets fit
    ``_VISITED_BUDGET``; past it, one launch per as many rows as fit."""
    from weaviate_tpu_torch.index.hnsw import hnsw as thnsw

    idx = HNSWIndex(DIMS, config.HNSWIndexConfig(
        distance="l2-squared", precision="fp32", max_connections=8,
        ef_construction=32, ef=EF, device_beam=True), device="cpu")
    idx.add_batch(np.arange(400), _vectors(3, 400))
    words = -(-idx.graph.capacity // 32)
    assert idx._sub_batch() == thnsw._VISITED_BUDGET // (4 * words)
    for budget in (thnsw._VISITED_BUDGET, 4 * words * 48):
        monkeypatch.setattr(thnsw, "_VISITED_BUDGET", budget)
        sub_b = idx._sub_batch()
        for rows in (1, 64, 130):
            before = tbeam.dispatch_count()
            launches = tbeam.fused_search.launches
            res = idx.search(_vectors(4, rows), 5)
            assert tbeam.dispatch_count() - before == -(-rows // sub_b)
            # on the CPU the wrapper runs the plain version: no kernel launch
            assert tbeam.fused_search.launches == launches
            assert res.ids.shape == (rows, 5) and (res.ids >= 0).all()
    assert sub_b == 48


def _tiny_walk_args(**over):
    corpus = torch.zeros((64, DIMS))
    args = dict(
        scorer=tbeam.RawScorer("l2-squared", "fp32"), queries=corpus[:2],
        operands=(corpus,), adjacency=torch.full((64, 8), -1, dtype=torch.int32),
        present=torch.ones(64, dtype=torch.bool),
        eps=torch.zeros(2, dtype=torch.int32),
        upper_adj=tbeam._empty_upper("cpu")[0],
        upper_slots=tbeam._empty_upper("cpu")[1], ef=16, max_steps=8)
    args.update(over)
    return args


@pytest.mark.parametrize("kw,where", [
    (dict(allow=np.ones(64, bool)), "slice 5"),
    (dict(keep_k=8), "slice 5"),
    (dict(expand=2), "slice 5"),
    (dict(rerank_k=4), "slice 7"),
])
def test_fused_search_raises_for_later_slices(jax_index, kw, where):
    """The filter arguments of slice 5 answer as JAX ``device_search``
    does: each alone leaves the walk unfiltered (no kept track without both
    ``allow`` and ``keep_k``). The rerank stage (slice 7a) answers as JAX's
    does: the walk's first ``rerank_k`` beam entries rescored by MaxSim
    against their own rows as 1-token sets, the ids equal, the negated
    scores within FILTERED_TOL."""
    import jax.numpy as jnp

    g = jax_index.graph
    corpus = np.asarray(jax_index.store.corpus)[: g.capacity]
    (jq, jc, jadj, jpres, jeps, jua, jus), (tq, tc, tadj, tpres, teps, tua,
                                            tus) = _walk_inputs(g, corpus, False)
    if where == "slice 7":
        from weaviate_tpu.modules.device import MaxSimRerank as JMaxSim
        from weaviate_tpu_torch.modules.device import MaxSimRerank

        qm = np.ones((B, 1), bool)
        tm = np.ones((corpus.shape[0], 1), bool)
        jout = jbeam.device_search(
            jbeam.RawScorer("l2-squared", "fp32"), jq, (jc,), jadj, jpres,
            jeps, ef=EF, max_steps=4 * EF + 64, upper_adj=jua,
            upper_slots=jus, rerank=JMaxSim(), rerank_k=kw["rerank_k"],
            rerank_q=jq[:, None, :], rerank_qmask=jnp.asarray(qm),
            rerank_tokens=jc[:, None, :], rerank_tmask=jnp.asarray(tm))
        tout = tbeam.fused_search(
            tbeam.RawScorer("l2-squared", "fp32"), tq, (tc,), tadj, tpres,
            teps, tua, tus, EF, 4 * EF + 64, rerank=MaxSimRerank(),
            rerank_k=kw["rerank_k"], rerank_q=tq[:, None, :],
            rerank_qmask=torch.from_numpy(qm),
            rerank_tokens=tc[:, None, :].contiguous(),
            rerank_tmask=torch.from_numpy(tm))
        assert len(jout) == len(tout) == 4
        np.testing.assert_array_equal(tout[0].numpy(), np.asarray(jout[0]))
        np.testing.assert_array_equal(tout[2].numpy(), np.asarray(jout[2]))
        np.testing.assert_allclose(tout[3].numpy(), np.asarray(jout[3]),
                                   rtol=FILTERED_TOL, atol=FILTERED_TOL)
        return
    if "allow" in kw:
        kw = dict(allow=_allow_mask(g.capacity, 0.5))
    jout = jbeam.device_search(
        jbeam.RawScorer("l2-squared", "fp32"), jq, (jc,), jadj, jpres, jeps,
        ef=EF, max_steps=4 * EF + 64, upper_adj=jua, upper_slots=jus,
        **{k: jnp.asarray(v) if k == "allow" else v for k, v in kw.items()})
    tout = tbeam.fused_search(
        tbeam.RawScorer("l2-squared", "fp32"), tq, (tc,), tadj, tpres, teps,
        tua, tus, EF, 4 * EF + 64,
        **{k: torch.from_numpy(v) if k == "allow" else v
           for k, v in kw.items()})
    assert len(jout) == len(tout) == 2
    for ja, ta in zip(jout, tout):
        np.testing.assert_allclose(ta.numpy(), np.asarray(ja),
                                   rtol=FILTERED_TOL, atol=FILTERED_TOL)


def test_fused_search_plain_on_cpu_returns_beam():
    ids, d = tbeam.fused_search(**_tiny_walk_args())
    assert ids.dtype == torch.int32 and d.dtype == torch.float32
    assert ids[:, 0].tolist() == [0, 0] and (ids[:, 1:] == -1).all()
    assert (d[:, 1:] == tbeam._INF).all()


@pytest.mark.parametrize("over,match", [
    (dict(ef=1024), "ef"),
    (dict(adjacency=torch.full((64, 256), -1, dtype=torch.int32)), "width"),
    (dict(queries=torch.zeros((2, 8))), "queries"),
    (dict(eps=torch.zeros(2, dtype=torch.int64)), "eps"),
    (dict(present=torch.ones(64, dtype=torch.uint8)), "present"),
    (dict(allow=torch.ones(64, dtype=torch.uint8), keep_k=8), "allow"),
    (dict(allow=torch.ones(64, dtype=torch.bool), keep_k=32), "keep_k"),
    (dict(allow=torch.ones(64, dtype=torch.bool), keep_k=8, expand=9),
     "frontier"),
    (dict(adjacency=torch.full((64, 128), -1, dtype=torch.int32),
          allow=torch.ones(64, dtype=torch.bool), keep_k=8, expand=5),
     "frontier"),
])
def test_kernel_wrapper_refuses_what_the_kernel_does_not_take(over, match):
    a = _tiny_walk_args(**over)
    with pytest.raises(ValueError, match=match):
        tbeam._check_kernel_args(
            a["scorer"], a["queries"], a["operands"], a["adjacency"],
            a["present"], a["eps"], a["upper_adj"], a["upper_slots"],
            a["ef"], a["max_steps"], a.get("allow"), a.get("keep_k", 0),
            a.get("expand", 0))
    with pytest.raises(TypeError, match="scorer"):
        tbeam._check_kernel_args(object(), *[None] * 9)


def test_largest_admitted_walk_fits_a_blocks_shared_memory():
    """The widest walk the wrapper's checks admit (D, beam, kept track and
    frontier at their limits) passes them, and its plain version walks it.
    Whether one query's state fits a block's shared memory is the C side's
    check against the card's; ``chip_smoke.py`` launches this walk there
    and holds it against the plain version."""
    m0 = tbeam.MAX_WIDTH
    expand = tbeam.MAX_FRONTIER // m0 - 1
    gen = torch.Generator().manual_seed(3)
    corpus = torch.randn((64, tbeam.MAX_DIMS), generator=gen)
    adj = torch.full((64, m0), -1, dtype=torch.int32)
    adj[:, :16] = torch.rand((64, 64), generator=gen).argsort(1)[:, :16]
    allow = torch.arange(64) % 2 == 0
    args = _tiny_walk_args(
        queries=torch.randn((2, tbeam.MAX_DIMS), generator=gen),
        operands=(corpus,), adjacency=adj, allow=allow, ef=tbeam.MAX_EF,
        keep_k=tbeam.MAX_EF, expand=expand, max_steps=4 * tbeam.MAX_EF + 64)
    tbeam._check_kernel_args(
        args["scorer"], args["queries"], args["operands"],
        args["adjacency"], args["present"], args["eps"], args["upper_adj"],
        args["upper_slots"], args["ef"], args["max_steps"], args["allow"],
        args["keep_k"], args["expand"])
    ids, d, kept, kept_d = tbeam.fused_search(**args)
    assert ids.shape == d.shape == (2, tbeam.MAX_EF)
    assert kept.shape == kept_d.shape == (2, tbeam.MAX_EF)
    # every node is reached from the entrypoint, so the beam holds all 64
    assert sorted(ids[0][ids[0] >= 0].tolist()) == list(range(64))
    assert bool(allow[kept[kept >= 0].long()].all())
    assert int((kept[0] >= 0).sum()) == 32


@pytest.mark.parametrize("old,new", probe.COUNTERS + [
    edit for edits in probe.COPIES.values() for edit in edits], ids=[
    f"counters_{i}" for i in range(len(probe.COUNTERS))] + [
    f"copy_{name}_{i}" for name, edits in probe.COPIES.items()
    for i in range(len(edits))])
def test_probe_copies_apply_to_the_kernel_source(old, new):
    # probe_device_beam.py's clock64 copy and its copies with one constant
    # changed replace lines the kernel source holds exactly once, so a
    # kernel edit that drops one fails here
    src = probe.SOURCE.read_text()
    assert src.count(old) == 1, repr(old)
    assert probe.edited([(old, new)]) != src


@pytest.mark.parametrize("filtered", [False, True], ids=["beam", "kept"])
def test_walk_bound_counts_only_the_walks_own_work(filtered):
    """``chip_smoke.walk_bound``: B2's bound holds the rows the walk scored
    and kept and the adjacency rows it expanded; the rows the kernel scored
    before the visited test and the rows it read ahead for another node
    move only ``overhead_bytes``."""
    import chip_smoke

    a = _tiny_walk_args()
    args = (a["scorer"], a["queries"], a["operands"], a["adjacency"],
            a["present"], a["eps"], a["upper_adj"], a["upper_slots"],
            a["ef"], a["max_steps"])
    kw = dict(allow=torch.ones(64, dtype=torch.bool), keep_k=8) \
        if filtered else {}
    # per query: expansions, scored, adjacency rows, upper rows,
    # speculative rows, read-ahead rows lost
    stats = torch.tensor([[10, 200, 12, 0, 0, 0], [8, 150, 9, 0, 0, 0]],
                         dtype=torch.int32)
    ms, by, work = chip_smoke.walk_bound(args, kw, stats)
    over = stats.clone()
    over[:, 4:] = torch.tensor([[30, 4], [20, 3]])
    ms2, by2, work2 = chip_smoke.walk_bound(args, kw, over)
    assert (ms2, by2, work2["bytes"]) == (ms, by, work["bytes"])
    row = DIMS * 4 + 1 + (1 if filtered else 0)
    keep = 8 if filtered else 0
    assert work["bytes"] == (2 * DIMS * 4 + 350 * row + 21 * 8 * 4
                             + 2 * (a["ef"] + keep) * 8)
    assert work["overhead_bytes"] == {"speculative_rows": 0,
                                      "read_ahead_lost": 0}
    assert work2["overhead_bytes"] == {"speculative_rows": 50 * row,
                                       "read_ahead_lost": 7 * 8 * 4}


# -- the quantized scorers ----------------------------------------------------

QUANT_SQ_TOL = 1e-5


def _quant_inputs(jax_index, kind, metric, dims=DIMS, segments=4):
    """Both packages' scorer, queries and operands for a BQ, SQ, PQ or RQ
    walk over the JAX index's rows (or, at another width, seeded rows of
    ``dims``), encoded once by the JAX quantizer (PQ: its ``segments``
    codebooks trained by the JAX k-means)."""
    import jax.numpy as jnp
    from weaviate_tpu.compression import quantizers as jq

    g = jax_index.graph
    rows = np.asarray(jax_index.store.corpus)[: g.capacity]
    q = _vectors(5, B)
    if dims != DIMS:
        rows, q = _vectors(11, g.capacity, dims), _vectors(5, B, dims)
    if metric in ("dot", "cosine"):
        rows = rows / np.maximum(np.linalg.norm(rows, axis=1, keepdims=True),
                                 1e-12)
        q = q / np.linalg.norm(q, axis=1, keepdims=True)
    if kind == "bq":
        quant = jq.BinaryQuantizer(DIMS, metric)
        enc = quant.encode(rows)
        qp = np.asarray(quant.prep(q))
        j = (jbeam.BQScorer(DIMS), jnp.asarray(qp),
             (jnp.asarray(enc["packed"]), jnp.asarray(enc["popcount"])))
        t = (tbeam.BQScorer(DIMS), torch.from_numpy(qp.view(np.int32).copy()),
             (torch.from_numpy(enc["packed"].view(np.int32)),
              torch.from_numpy(enc["popcount"])))
        return j, t
    if kind == "pq":
        quant = jq.ProductQuantizer(dims, metric,
                                    jconfig.PQConfig(segments=segments))
        quant.fit(rows)
        enc = quant.encode(rows)
        j = (jbeam.PQScorer(metric), jnp.asarray(q),
             (jnp.asarray(enc["codes"]), jnp.asarray(quant.codebooks),
              jnp.asarray(enc["dec_sqnorm"])))
        t = (tbeam.PQScorer(metric), torch.from_numpy(q),
             (torch.from_numpy(np.ascontiguousarray(enc["codes"])),
              torch.from_numpy(quant.codebooks.copy()),
              torch.from_numpy(enc["dec_sqnorm"])))
        return j, t
    if kind == "rq":
        quant = jq.RotationalQuantizer(dims, metric)
        quant.fit(rows)
        enc = quant.encode(rows)
        planes = [enc[f] for f in ("codes", "lower", "step", "dec_sqnorm")]
        q_rot = quant.rotate(q)
        j = (jbeam.RQScorer(metric), jnp.asarray(q_rot),
             tuple(jnp.asarray(a) for a in planes))
        t = (tbeam.RQScorer(metric), torch.from_numpy(q_rot),
             tuple(torch.from_numpy(a) for a in planes))
        return j, t
    quant = jq.ScalarQuantizer(dims, metric)
    quant.fit(rows)
    enc = quant.encode(rows)
    j = (jbeam.SQScorer(metric), jnp.asarray(q),
         (jnp.asarray(enc["codes"]), jnp.asarray(enc["dec_sqnorm"]),
          jnp.float32(quant.a), jnp.float32(quant.s)))
    t = (tbeam.SQScorer(metric), torch.from_numpy(q),
         (torch.from_numpy(enc["codes"]), torch.from_numpy(enc["dec_sqnorm"]),
          quant.a, quant.s))
    return j, t


# the widths the kernel's code-row paths branch on: kind -> (row type,
# dims, PQ segments, a graph of M0 32)
WIDE_CODES = {"pq_96x16": ("pq", 1536, 96, False),
              "sq_99": ("sq", 99, 4, False),
              "sq_m32": ("sq", DIMS, 4, True)}


@pytest.mark.parametrize("kind,metric,flt", [
    ("bq", "l2-squared", None), ("bq", "l2-squared", (0.1, 8, 1)),
    ("bq", "cosine", (0.5, 32, 2)),
    ("sq", "l2-squared", None), ("sq", "dot", (0.1, 8, 1)),
    ("sq", "cosine", None), ("sq", "cosine", (0.5, 32, 4)),
    ("pq", "l2-squared", None), ("pq", "dot", (0.1, 8, 1)),
    ("pq", "cosine", (0.5, 32, 2)),
    ("rq", "l2-squared", (0.1, 8, 1)), ("rq", "dot", None),
    ("rq", "cosine", None),
    ("pq_96x16", "l2-squared", None), ("sq_99", "dot", (0.1, 8, 1)),
    ("sq_m32", "l2-squared", (0.5, 32, 4)),
])
def test_plain_quantized_walk_matches_jax(jax_index, kind, metric, flt):
    """The plain walk over BQ, SQ, PQ and RQ code planes against JAX
    ``device_search`` on the same graph, unfiltered and filtered: BQ equal
    in every id and distance, SQ, PQ and RQ ids on >= 0.99 of the slots and
    matched distances within 1e-5. ``WIDE_CODES`` holds the yardstick at
    the widths the kernel branches on: PQ rows of 96 codes into 16-d
    centroids (1536-d), SQ rows of 99 bytes, and a frontier of 160 (a
    seeded random graph of M0 32, no upper layers, expand 4)."""
    import jax.numpy as jnp

    g = jax_index.graph
    kind, dims, segments, m32 = WIDE_CODES.get(kind, (kind, DIMS, 4, False))
    (js, jq, jops), (ts, tq, tops) = _quant_inputs(jax_index, kind, metric,
                                                   dims, segments)
    jm = jbeam.DeviceAdjacency(g)
    adj, present = jm.sync()
    ua, us = jm.sync_upper()
    eps = np.full(B, g.entrypoint, np.int32)
    if m32:
        rng = np.random.default_rng(13)
        adj = rng.integers(0, g.capacity, (g.capacity, 32)).astype(np.int32)
        present = np.ones(g.capacity, bool)
        ua, us = None, None
    t_adj = tuple(torch.from_numpy(np.array(a)) for a in (adj, present, eps))
    t_adj += tbeam._empty_upper("cpu") if m32 else tuple(
        torch.from_numpy(np.array(a)) for a in (ua, us))
    kw_j, kw_t = {}, {}
    if flt:
        sel, keep, expand = flt
        allow = _allow_mask(g.capacity, sel)
        kw_j = dict(allow=jnp.asarray(allow), keep_k=keep, expand=expand)
        kw_t = dict(allow=torch.from_numpy(allow), keep_k=keep, expand=expand)
    jout = jbeam.device_search(js, jq, jops, adj, present, eps, ef=EF,
                               max_steps=4 * EF + 64, upper_adj=ua,
                               upper_slots=us, **kw_j)
    tout = tbeam.fused_search(ts, tq, tops, *t_adj[:3], t_adj[3], t_adj[4],
                              EF, 4 * EF + 64, **kw_t)
    assert len(jout) == len(tout) == (4 if flt else 2)
    for pair in range(len(tout) // 2):
        ji, jd = (np.asarray(a) for a in jout[2 * pair:2 * pair + 2])
        ti, td = (a.numpy() for a in tout[2 * pair:2 * pair + 2])
        if kind == "bq":
            np.testing.assert_array_equal(ti, ji)
            np.testing.assert_array_equal(td, jd)
            continue
        same = ti == ji
        assert same.mean() >= MIN_ID_AGREEMENT, same.mean()
        live = same & (ji >= 0)
        np.testing.assert_allclose(td[live], jd[live], rtol=QUANT_SQ_TOL,
                                   atol=QUANT_SQ_TOL)
    if flt:
        ids = tout[2].numpy()
        assert allow[ids[ids >= 0]].all()


@pytest.mark.parametrize("kind", ["bq", "sq", "pq", "rq"])
def test_quantized_scorers_reach_the_kernel_checks(jax_index, kind):
    """BQ, SQ, PQ and RQ walks pass the kernel's argument checks with their
    own row types (and the plain walk takes them); a query of the wrong
    width or type is refused."""
    _, (ts, tq, tops) = _quant_inputs(jax_index, kind, "l2-squared")
    n = tops[0].shape[0]
    a = _tiny_walk_args(scorer=ts, queries=tq[:2].contiguous(),
                        operands=tops,
                        adjacency=torch.full((n, 8), -1, dtype=torch.int32),
                        present=torch.ones(n, dtype=torch.bool))
    tbeam._check_kernel_args(
        a["scorer"], a["queries"], a["operands"], a["adjacency"],
        a["present"], a["eps"], a["upper_adj"], a["upper_slots"], a["ef"],
        a["max_steps"])
    ids, _ = tbeam.fused_search(**a)
    assert ids[:, 0].tolist() == [0, 0]
    bad = dict(a, queries=tq[:2].float() if kind == "bq"
               else tq[:2, :4].contiguous())
    with pytest.raises(ValueError, match="queries"):
        tbeam._check_kernel_args(
            bad["scorer"], bad["queries"], bad["operands"], bad["adjacency"],
            bad["present"], bad["eps"], bad["upper_adj"], bad["upper_slots"],
            bad["ef"], bad["max_steps"])


@pytest.mark.parametrize("kind", ["raw", "sq", "rq", "pq"])
def test_walk_bound_counts_operations_at_their_types_rate(kind):
    """``chip_smoke.walk_bound`` turns a float32 row's operations into time
    at the float32 rate and a code row's bf16 products (SQ, RQ, PQ) at the
    bf16 rate: PQ at config 3's widths (96 segments of 16) is then bound by
    its bytes."""
    import chip_smoke

    n, d, m = 64, 1536, 96
    codes = torch.zeros((n, d), dtype=torch.uint8)
    norms = torch.zeros(n)
    scorer, operands, rate = {
        "raw": (tbeam.RawScorer("l2-squared", "fp32"),
                (torch.zeros((n, d)),), chip_smoke.FP32_FLOP_S),
        "sq": (tbeam.SQScorer("l2-squared"), (codes, norms, 0.0, 1.0),
               chip_smoke.BF16_FLOP_S),
        "rq": (tbeam.RQScorer("l2-squared"), (codes, norms, norms, norms),
               chip_smoke.BF16_FLOP_S),
        "pq": (tbeam.PQScorer("l2-squared"),
               (codes[:, :m].contiguous(),
                torch.zeros((m, 256, d // m), dtype=torch.bfloat16), norms),
               chip_smoke.BF16_FLOP_S),
    }[kind]
    a = _tiny_walk_args(scorer=scorer, queries=torch.zeros((2, d)),
                        operands=operands)
    args = (a["scorer"], a["queries"], a["operands"], a["adjacency"],
            a["present"], a["eps"], a["upper_adj"], a["upper_slots"],
            a["ef"], a["max_steps"])
    stats = torch.tensor([[10, 2000, 12, 0, 0, 0], [8, 1500, 9, 0, 0, 0]],
                         dtype=torch.int32)
    ms, by, work = chip_smoke.walk_bound(args, {}, stats)
    assert work["flops"] == 3500 * (3 if kind == "raw" else 2) * d
    t_bytes = work["bytes"] / chip_smoke.HBM_BYTES_S
    t_ops = work["flops"] / rate
    assert ms == pytest.approx(max(t_bytes, t_ops) * 1e3, rel=1e-12)
    assert by == ("bytes" if t_bytes >= t_ops else "operations")
    if kind == "pq":
        assert by == "bytes"


@pytest.mark.parametrize("kind", ["bq", "sq"])
def test_walk_bound_counts_the_scorers_row_bytes(jax_index, kind):
    """``chip_smoke.walk_bound`` counts a BQ row as its words and popcount,
    an SQ row as its codes and decoded norm."""
    import chip_smoke

    _, (ts, tq, tops) = _quant_inputs(jax_index, kind, "l2-squared")
    a = _tiny_walk_args(scorer=ts, queries=tq[:2].contiguous(),
                        operands=tops)
    args = (a["scorer"], a["queries"], a["operands"], a["adjacency"],
            a["present"], a["eps"], a["upper_adj"], a["upper_slots"],
            a["ef"], a["max_steps"])
    stats = torch.tensor([[10, 200, 12, 0, 0, 0], [8, 150, 9, 0, 0, 0]],
                         dtype=torch.int32)
    _, _, work = chip_smoke.walk_bound(args, {}, stats)
    row = (4 + 4) if kind == "bq" else (DIMS + 4)
    assert work["bytes"] == (tq[:2].numel() * tq.element_size()
                             + 350 * (row + 1) + 21 * 8 * 4
                             + 2 * a["ef"] * 8)
