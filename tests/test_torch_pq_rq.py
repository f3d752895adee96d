"""Parity: the port's product and rotational quantizers (PQ, RQ) against the
JAX package's, on the CPU.

- State carried across: a JAX ``ProductQuantizer``'s or
  ``RotationalQuantizer``'s ``state_dict()`` loads into the port
  (``interop.quantizer_from_state``) and the port's into JAX, and both
  packages then encode the same planes. RQ's codes, ``lower``, ``step`` and
  ``dec_sqnorm`` are bit-identical (the same host numpy code); PQ's codes
  may differ only where a row's two nearest centroids lie within float32
  rounding of each other (XLA's and torch's sums in another order), which
  the test checks, and its ``dec_sqnorm`` is equal wherever the codes are.
  A ``dims`` that shrinks PQ's segments and an ``rdims`` that pads (D = 40)
  are covered, and so is RQ's ``bits=1``.
- The plain scans (``_pq_search_plain``, ``_rq_search_plain``) and the
  gathers against JAX's ``pq_search``/``rq_search`` and gathers, l2, dot
  and cosine, masked and unmasked: distances within 1e-4 (float32 sums of
  the same bf16 products in another order), ids equal wherever the
  distances do not tie within 1e-5.
- Ports of ``test_compressed_recall_floor[pq/rq]`` and
  ``test_hnsw_compressed_recall[pq/rq]``: the port at JAX's floors and
  within 0.005 of JAX's own recall on the same data.
- An HNSW index's ``quantizer.msgpack`` carries PQ's codebooks and RQ's
  rotation through the port's reopen and the JAX index's open.
"""

import numpy as np
import pytest
import torch

from tests.test_compression import clustered, exact_topk, recall_at_k
from weaviate_tpu.compression import quantizers as jq
from weaviate_tpu.index.flat import make_flat as jmake_flat
from weaviate_tpu.index.hnsw import HNSWIndex as JaxHNSW
from weaviate_tpu.ops import quantized as jqops
from weaviate_tpu.schema import config as jconfig
from weaviate_tpu_torch import interop
from weaviate_tpu_torch.compression import (
    ProductQuantizer,
    RotationalQuantizer,
    build_quantizer,
)
from weaviate_tpu_torch.index.flat import QuantizedFlatIndex, make_flat
from weaviate_tpu_torch.index.hnsw import HNSWIndex
from weaviate_tpu_torch.ops import quantized as qops
from weaviate_tpu_torch.schema import config

METRICS = ("l2-squared", "dot", "cosine")
# distances: float32 sums of the same bf16 products in another order
DIST_TOL = 1e-4
# ids must agree where the distances are this far apart
TIE_TOL = 1e-5
# recall: the port within this of JAX's on the same data
RECALL_SLACK = 0.005


def _vectors(seed, n, d):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(
        np.float32)


def _jax_pq(d, metric, segments, data):
    j = jq.ProductQuantizer(d, metric, jconfig.PQConfig(segments=segments))
    j.fit(data)
    return j


# -- state carried across, and the encodes ---------------------------------


@pytest.mark.parametrize("d,segments", [(32, 8), (30, 8), (24, 0)],
                         ids=["dsub4", "shrinks_to_6", "default_d4"])
def test_pq_state_from_jax_encodes_the_same_codes(d, segments):
    v = clustered(np.random.default_rng(d), 1500, d, n_clusters=12)
    j = _jax_pq(d, "l2-squared", segments, v)
    t = interop.quantizer_from_state(j.state_dict(), config.PQConfig(
        segments=segments), device="cpu")
    assert isinstance(t, ProductQuantizer)
    assert (t.m, t.dsub, t.centroids) == (j.m, j.dsub, j.centroids)
    if d == 30:
        assert t.m == 6  # 8 does not divide 30: shrunk to a divisor
    assert t.fields() == j.fields()
    np.testing.assert_array_equal(t.codebooks, j.codebooks)
    x = _vectors(7, 400, d)
    je, te = j.encode(x), t.encode(x)
    jc, tc = np.asarray(je["codes"]), te["codes"]
    assert tc.dtype == np.uint8 and tc.shape == (400, t.m)
    diff = np.argwhere(jc != tc)
    # a differing code is a near tie: its centroid and JAX's lie within
    # float32 rounding of the segment
    for row, seg in diff:
        piece = x[row, seg * t.dsub:(seg + 1) * t.dsub].astype(np.float64)
        cb = j.codebooks[seg].astype(np.float64)
        dj = ((piece - cb[jc[row, seg]]) ** 2).sum()
        dt = ((piece - cb[tc[row, seg]]) ** 2).sum()
        assert abs(dj - dt) <= 1e-5 * (1.0 + dj), (row, seg, dj, dt)
    assert len(diff) <= 0.01 * jc.size
    same = (jc == tc).all(axis=1)
    np.testing.assert_array_equal(te["dec_sqnorm"][same],
                                  np.asarray(je["dec_sqnorm"])[same])
    np.testing.assert_array_equal(t.decode(tc[same]),
                                  j.decode(jc[same]))


@pytest.mark.parametrize("d,bits", [(40, 8), (64, 8), (40, 1)],
                         ids=["pads_to_64", "d64", "bits1"])
def test_rq_state_from_jax_encodes_the_same_planes(d, bits):
    v = _vectors(3, 300, d)
    j = jq.RotationalQuantizer(d, "cosine", jconfig.RQConfig(bits=bits))
    j.fit(v)
    t = interop.quantizer_from_state(j.state_dict(),
                                     config.RQConfig(bits=bits))
    assert isinstance(t, RotationalQuantizer)
    assert t.rdims == j.rdims == 64
    np.testing.assert_array_equal(t.rotation, j.rotation)
    assert t.fields() == j.fields()
    je, te = j.encode(v), t.encode(v)
    assert set(te) == set(je)
    for key in je:
        assert te[key].dtype == np.asarray(je[key]).dtype, key
        np.testing.assert_array_equal(te[key], np.asarray(je[key]))
    tq = t.prep(v[:5], "cpu")
    jqr = np.asarray(j.prep(v[:5]))
    if bits == 1:
        np.testing.assert_array_equal(tq.numpy().view(np.uint32), jqr)
    else:
        np.testing.assert_array_equal(tq.numpy(), jqr)


@pytest.mark.parametrize("kind", ["pq", "rq"])
def test_state_round_trips_in_both_directions(kind):
    v = _vectors(11, 800, 24)
    cfg = (config.PQConfig(segments=6) if kind == "pq"
           else config.RQConfig())
    t = build_quantizer(cfg, 24, "dot", device="cpu")
    t.fit(v)
    # port -> JAX
    jcls = jq.ProductQuantizer if kind == "pq" else jq.RotationalQuantizer
    j = jcls(24, "dot")
    j.load_state_dict(t.state_dict())
    te, je = t.encode(v[:50]), j.encode(v[:50])
    for key in je:
        np.testing.assert_array_equal(te[key], np.asarray(je[key]))
    # JAX -> port, and port -> port
    for state in (j.state_dict(), t.state_dict()):
        back = interop.quantizer_from_state(state, cfg, device="cpu")
        assert back.state_dict() == t.state_dict()
        again = back.encode(v[:50])
        for key in te:
            np.testing.assert_array_equal(again[key], te[key])


# -- the scans and the gathers ---------------------------------------------


def _assert_topk_matches(got, want):
    """(dists, ids) against JAX's: distances within DIST_TOL, ids equal
    wherever the distance differs from its neighbours' by more than
    TIE_TOL."""
    td, ti = (a.numpy() for a in got)
    jd, ji = (np.asarray(a) for a in want)
    np.testing.assert_allclose(td, jd, rtol=DIST_TOL, atol=DIST_TOL)
    gap = np.diff(jd, axis=1)
    alone = np.ones_like(jd, bool)
    alone[:, 1:] &= gap > TIE_TOL
    alone[:, :-1] &= gap > TIE_TOL
    np.testing.assert_array_equal(ti[alone], ji[alone])
    assert alone.mean() > 0.5


def _pq_state(metric):
    d = 48
    rows = clustered(np.random.default_rng(5), 1200, d, n_clusters=16)
    q = rows[:9] + 0.05 * _vectors(6, 9, d)
    if metric != "l2-squared":
        rows = rows / np.linalg.norm(rows, axis=1, keepdims=True)
        q = q / np.linalg.norm(q, axis=1, keepdims=True)
    j = _jax_pq(d, metric, 12, rows)
    enc = j.encode(rows)
    return j, rows, q, np.ascontiguousarray(enc["codes"]), enc["dec_sqnorm"]


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
def test_pq_search_plain_and_gather_match_jax(metric, masked):
    import jax.numpy as jnp

    j, rows, q, codes, dsq = _pq_state(metric)
    mask = np.random.default_rng(1).random(len(rows)) > 0.3 if masked \
        else None
    want = jqops.pq_search(jnp.asarray(q), jnp.asarray(codes),
                           jnp.asarray(j.codebooks), jnp.asarray(dsq),
                           None if mask is None else jnp.asarray(mask),
                           metric, 20, 256)
    tcb = torch.from_numpy(j.codebooks.copy())
    args = (torch.from_numpy(q), torch.from_numpy(codes), tcb,
            torch.from_numpy(dsq),
            None if mask is None else torch.from_numpy(mask), metric, 20)
    got = qops._pq_search_plain(*args, 256)
    _assert_topk_matches(got, want)
    # the wrapper (CPU tensors: the plain version), and the bf16 codebook
    # copy the quantizer keeps: the same distances
    for cb in (tcb, tcb.to(torch.bfloat16)):
        wd, wi = qops.pq_search(*args[:2], cb, *args[3:], chunk=256)
        assert torch.equal(wd, got[0]) and torch.equal(wi, got[1])
    ids = np.random.default_rng(2).integers(0, len(rows), (9, 30))
    jg = jqops.pq_gather_distance(jnp.asarray(q), jnp.asarray(codes),
                                  jnp.asarray(j.codebooks), jnp.asarray(ids),
                                  jnp.asarray(dsq), metric)
    tg = qops.pq_gather_distance(torch.from_numpy(q), torch.from_numpy(codes),
                                 tcb.to(torch.bfloat16), torch.from_numpy(ids),
                                 torch.from_numpy(dsq), metric)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=DIST_TOL,
                               atol=DIST_TOL)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
def test_rq_search_plain_and_gather_match_jax(metric, masked):
    import jax.numpy as jnp

    rows = clustered(np.random.default_rng(8), 1500, 40, n_clusters=16)
    q = rows[:9] + 0.05 * _vectors(9, 9, 40)
    if metric != "l2-squared":
        rows = rows / np.linalg.norm(rows, axis=1, keepdims=True)
        q = q / np.linalg.norm(q, axis=1, keepdims=True)
    j = jq.RotationalQuantizer(40, metric)
    j.fit(rows)
    enc = j.encode(rows)
    planes = [enc[f] for f in ("codes", "lower", "step", "dec_sqnorm")]
    q_rot = j.rotate(q)
    mask = np.random.default_rng(1).random(len(rows)) > 0.5 if masked \
        else None
    want = jqops.rq_search(jnp.asarray(q_rot), *map(jnp.asarray, planes),
                           None if mask is None else jnp.asarray(mask),
                           metric, 25, 512)
    args = (torch.from_numpy(q_rot), *map(torch.from_numpy, planes),
            None if mask is None else torch.from_numpy(mask), metric, 25)
    got = qops._rq_search_plain(*args, 512)
    _assert_topk_matches(got, want)
    wd, wi = qops.rq_search(*args, chunk=512)
    assert torch.equal(wd, got[0]) and torch.equal(wi, got[1])
    ids = np.random.default_rng(3).integers(0, len(rows), (9, 30))
    jg = jqops.rq_gather_distance(jnp.asarray(q_rot), jnp.asarray(planes[0]),
                                  jnp.asarray(ids),
                                  *map(jnp.asarray, planes[1:]), metric)
    tg = qops.rq_gather_distance(torch.from_numpy(q_rot),
                                 torch.from_numpy(planes[0]),
                                 torch.from_numpy(ids),
                                 *map(torch.from_numpy, planes[1:]), metric)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=DIST_TOL,
                               atol=DIST_TOL)


# -- the indexes: JAX's recall gates, ported --------------------------------


@pytest.mark.parametrize("kind,floor", [("rq", 0.92), ("pq", 0.80)])
def test_compressed_recall_floor_ported(rng, kind, floor):
    """JAX's ``test_compressed_recall_floor[pq/rq]`` on the port's flat
    index, beside JAX's own index on the same data."""
    n, d, k, nq = 3000, 64, 10, 32
    corpus = clustered(rng, n, d)
    queries = (corpus[rng.choice(n, nq, replace=False)]
               + 0.02 * rng.standard_normal((nq, d))).astype(np.float32)

    def qcfg(mod):
        return (mod.PQConfig(segments=16, rescore_limit=100) if kind == "pq"
                else mod.RQConfig(rescore_limit=80))

    t = make_flat(d, config.FlatIndexConfig(
        distance="l2-squared", quantizer=qcfg(config)), device="cpu")
    j = jmake_flat(d, jconfig.FlatIndexConfig(distance="l2-squared",
                                             quantizer=qcfg(jconfig)))
    assert isinstance(t, QuantizedFlatIndex)
    want = exact_topk(queries, corpus, k)
    recalls = []
    for idx in (t, j):
        idx.add_batch(np.arange(n), corpus)
        assert idx.quantizer.fitted
        recalls.append(recall_at_k(idx.search(queries, k).ids, want))
    assert recalls[0] >= floor, recalls
    assert abs(recalls[0] - recalls[1]) <= RECALL_SLACK, recalls


@pytest.mark.parametrize("kind,floor", [("rq", 0.88), ("pq", 0.75)])
def test_hnsw_compressed_recall_ported(rng, kind, floor):
    """JAX's ``test_hnsw_compressed_recall[pq/rq]`` on the port's HNSW
    index (the fused walk's plain version on the CPU), beside JAX's own
    index on the same data."""
    n, d, nq, k = 1500, 32, 24, 10
    corpus = clustered(rng, n, d)

    def cfg(mod):
        quant = (mod.PQConfig(segments=8, rescore_limit=80) if kind == "pq"
                 else mod.RQConfig(rescore_limit=60))
        return mod.HNSWIndexConfig(distance="l2-squared", quantizer=quant,
                                   ef_construction=96, max_connections=16,
                                   flat_search_cutoff=0, device_beam=True)

    t = HNSWIndex(d, cfg(config), device="cpu")
    j = JaxHNSW(d, cfg(jconfig))
    for idx in (t, j):
        idx.add_batch(np.arange(n), corpus)
    queries = (corpus[rng.choice(n, nq, replace=False)]
               + 0.02 * rng.standard_normal((nq, d))).astype(np.float32)
    want = exact_topk(queries, corpus, k)
    recalls = [recall_at_k(idx.search(queries, k).ids, want)
               for idx in (t, j)]
    assert t.stats()["quantizer"] == kind
    assert recalls[0] >= floor, recalls
    assert abs(recalls[0] - recalls[1]) <= RECALL_SLACK, recalls


@pytest.mark.parametrize("kind", ["pq", "rq"])
def test_quantizer_msgpack_round_trips_codebooks_and_rotations(tmp_path,
                                                               kind):
    """An HNSW + PQ/RQ index's ``quantizer.msgpack`` carries the trained
    codebooks or rotation: the port's reopen and the JAX index's open of
    the same directory hold the port's state exactly."""
    d = 24
    v = _vectors(13, 600, d)

    def cfg(mod):
        quant = (mod.PQConfig(segments=6, rescore_limit=20) if kind == "pq"
                 else mod.RQConfig(rescore_limit=20))
        return mod.HNSWIndexConfig(distance="l2-squared", quantizer=quant,
                                   ef_construction=32, max_connections=8)

    path = str(tmp_path / "idx")
    t = HNSWIndex(d, cfg(config), path=path, device="cpu")
    t.add_batch(np.arange(600), v)
    t.close()
    field = "codebooks" if kind == "pq" else "rotation"
    want = getattr(t.backend.quantizer, field)
    again = HNSWIndex(d, cfg(config), path=path, device="cpu")
    j = JaxHNSW(d, cfg(jconfig), path=path)
    for q in (again.backend.quantizer, j.backend.quantizer):
        assert q.fitted
        np.testing.assert_array_equal(getattr(q, field), want)
    assert again.backend.quantizer.state_dict() == \
        t.backend.quantizer.state_dict()
