"""Parity: weaviate_tpu_torch FlatIndex against the JAX FlatIndex on the same
numpy-seeded writes and queries, on the CPU — every metric and precision,
with and without an allow list, chunked scans, deletes, capacity growth,
k beyond the live rows, range search, the warm tier, the fused-kernel route
and a JAX checkpoint served by the port.

Ids must be identical. Distances: float32 rtol 1e-5 / atol 1e-4, bf16
precision rtol 1e-4 / atol 1e-3 (same products, sums in another order).
"""

import numpy as np
import pytest
import torch

from weaviate_tpu.index.flat import FlatIndex as JaxFlat
from weaviate_tpu.schema.config import FlatIndexConfig as JaxConfig
from weaviate_tpu_torch.index.flat import FlatIndex, make_flat
from weaviate_tpu_torch.ops import fused_flat
from weaviate_tpu_torch.schema.config import FlatIndexConfig
from weaviate_tpu_torch.utils.runtime_config import FLAT_APPROX_RECALL_DEFAULT

TOL = {"fp32": dict(rtol=1e-5, atol=1e-4), "bf16": dict(rtol=1e-4, atol=1e-3)}
DIMS = 16


def _pair(**cfg):
    return (JaxFlat(DIMS, JaxConfig(**cfg)),
            FlatIndex(DIMS, FlatIndexConfig(**cfg), device="cpu"))


def _vectors(n, metric, rng):
    v = rng.standard_normal((n, DIMS)).astype(np.float32)
    return np.round(v) if metric == "hamming" else v


def _same(a, b, precision="bf16"):
    np.testing.assert_array_equal(b.ids, a.ids)
    live = a.ids >= 0
    np.testing.assert_allclose(b.dists[live], a.dists[live], **TOL[precision])
    assert (b.dists[~live] == a.dists[~live]).all()


def _both(j, t, fn):
    fn(j)
    fn(t)


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("metric", ["l2-squared", "dot", "cosine",
                                    "manhattan", "hamming"])
def test_search_matches_jax(metric, precision):
    rng = np.random.default_rng(0)
    j, t = _pair(distance=metric, precision=precision, initial_capacity=100,
                 search_chunk_size=1000)
    vecs = _vectors(400, metric, rng)
    _both(j, t, lambda x: x.add_batch(np.arange(400), vecs))
    q = _vectors(6, metric, rng)
    q[:3] = vecs[:3] + (0 if metric == "hamming" else 0.05)
    allow = rng.random(5000) > 0.4
    _same(j.search(q, 10), t.search(q, 10), precision)
    _same(j.search(q, 10, allow), t.search(q, 10, allow), precision)
    # deletes, then growth past the first page: 8192 rows in chunks of 1000
    _both(j, t, lambda x: x.delete(np.arange(0, 400, 3)))
    more = _vectors(2, metric, rng)
    _both(j, t, lambda x: x.add_batch(np.array([4500, 7]), more))
    assert t.capacity == j.capacity == 8192
    assert t.count() == j.count()
    _same(j.search(q, 10), t.search(q, 10), precision)
    _same(j.search(q, 10, allow[:4600]), t.search(q, 10, allow[:4600]),
          precision)
    assert t.stats() == {k: v for k, v in j.stats().items()}


@pytest.mark.parametrize("metric", ["l2-squared", "cosine", "hamming"])
def test_k_beyond_live_and_range_search(metric):
    rng = np.random.default_rng(1)
    j, t = _pair(distance=metric, precision="fp32")
    vecs = _vectors(5, metric, rng)
    _both(j, t, lambda x: x.add_batch(np.array([0, 2, 4, 6, 8]), vecs))
    q = _vectors(3, metric, rng)
    a, b = j.search(q, 8), t.search(q, 8)
    _same(a, b, "fp32")
    assert (b.ids[:, 5:] == -1).all()
    # a radius between two returned distances, not on one of them
    radius = float(np.mean(np.sort(a.dists[:, :5].ravel())[6:8]))
    _same(j.search_by_distance(q, radius), t.search_by_distance(q, radius),
          "fp32")


def test_warm_tier_matches_jax():
    rng = np.random.default_rng(2)
    j, t = _pair(distance="l2-squared")
    vecs = _vectors(300, "l2-squared", rng)
    _both(j, t, lambda x: x.add_batch(np.arange(300), vecs))
    _both(j, t, lambda x: x.delete(np.arange(10)))
    q = vecs[10:14] + 0.01
    before = t.search(q, 5)
    assert t.hbm_bytes() == j.hbm_bytes()
    assert t.demote_device() == j.demote_device()
    assert not t.device_resident and t.hbm_bytes() == 0
    assert t.host_tier_bytes() == j.host_tier_bytes()
    allow = np.zeros(300, bool)
    allow[100:] = True
    for al in (None, allow):
        a, b = j.search(q, 5, al), t.search(q, 5, al)
        np.testing.assert_array_equal(b.ids, a.ids)
        np.testing.assert_array_equal(b.dists, a.dists)
    assert t.promote_device() == j.promote_device()
    assert t.device_resident
    after = t.search(q, 5)
    np.testing.assert_array_equal(after.ids, before.ids)
    _same(j.search(q, 5), after)


def test_fused_kernel_route_gives_jax_exact_ids(monkeypatch):
    """l2 / bf16 / approximate selection allowed / k <= 64 takes the fused
    kernel; at this size the fold is 1, which is exact selection."""
    rng = np.random.default_rng(3)
    calls = []
    real = fused_flat.fused_flat_topk

    def spy(*a, **kw):
        calls.append(kw["live_rows"])
        return real(*a, **kw)

    monkeypatch.setattr(fused_flat, "fused_flat_topk", spy)
    j, t = _pair(distance="l2-squared", precision="bf16",
                 flat_approx_recall=0.99)
    vecs = _vectors(2000, "l2-squared", rng)
    _both(j, t, lambda x: x.add_batch(np.arange(2000), vecs))
    _both(j, t, lambda x: x.delete(np.arange(0, 2000, 5)))
    q = vecs[1:9] + 0.1 * rng.standard_normal((8, DIMS)).astype(np.float32)
    allow = rng.random(2000) > 0.5
    for k, al in ((10, None), (64, None), (10, allow)):
        _same(j.search(q, k, al), t.search(q, k, al))
    assert len(calls) == 3
    assert fused_flat.fold_width(2048, 10, calls[0]) == 1
    # exact requests and k > 64 take flat_search
    _same(j.search(q, 65), t.search(q, 65))
    _same(j.search(q, 10, approx_recall=0.0), t.search(q, 10, approx_recall=0.0))
    assert len(calls) == 3


def test_unset_approx_recall_follows_runtime_default(monkeypatch):
    calls = []
    monkeypatch.setattr(fused_flat, "fused_flat_topk",
                        lambda *a, **kw: calls.append(1) or (
                            torch.zeros(1, 3), torch.zeros(1, 3, dtype=torch.int32)))
    t = FlatIndex(DIMS, FlatIndexConfig(distance="l2-squared"), device="cpu")
    t.add_batch(np.arange(5), np.ones((5, DIMS), np.float32))
    t.search(np.ones(DIMS, np.float32), 3)
    assert calls == []  # default 0.0: exact
    FLAT_APPROX_RECALL_DEFAULT.set_override(0.9)
    try:
        t.search(np.ones(DIMS, np.float32), 3)
    finally:
        FLAT_APPROX_RECALL_DEFAULT.clear_override()
    assert calls == [1]


def test_jax_checkpoint_serves_same_ids(tmp_path):
    rng = np.random.default_rng(4)
    j = JaxFlat(DIMS, JaxConfig(distance="cosine", precision="fp32"))
    vecs = _vectors(500, "cosine", rng)
    j.add_batch(np.arange(500), vecs)
    j.delete(np.arange(0, 500, 4))
    path = str(tmp_path / "flat.ckpt")
    assert j.save_vectors(path, {"shard": "s0"})
    t = FlatIndex(DIMS, FlatIndexConfig(distance="cosine", precision="fp32"),
                  device="cpu")
    assert t.load_vectors(path) == {"shard": "s0"}
    assert t.count() == j.count() and t.contains(5) and not t.contains(4)
    q = vecs[:5] + 0.01
    _same(j.search(q, 10), t.search(q, 10), "fp32")


def test_device_and_factory_rules():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FlatIndex(DIMS)
    with pytest.raises(ValueError, match="query dims"):
        FlatIndex(DIMS, device="cpu").search(np.ones((1, 3), np.float32), 1)


def test_make_flat_refuses_quantizer():
    """make_flat builds the quantized flat index for every quantizer: BQ
    and SQ (slice 4a), PQ and RQ (slice 4b, once refused), each answering
    as JAX's make_flat does."""
    from weaviate_tpu.index.flat import make_flat as jmake_flat
    from weaviate_tpu.schema import config as jconfig
    from weaviate_tpu_torch.index.flat import QuantizedFlatIndex
    from weaviate_tpu_torch.schema.config import (
        BQConfig,
        PQConfig,
        RQConfig,
        SQConfig,
    )

    assert isinstance(make_flat(DIMS, device="cpu"), FlatIndex)
    vecs = np.random.default_rng(8).standard_normal((700, DIMS)).astype(
        np.float32)
    for tq, jq in ((BQConfig(), jconfig.BQConfig()),
                   (SQConfig(), jconfig.SQConfig()),
                   (PQConfig(), jconfig.PQConfig()),
                   (RQConfig(), jconfig.RQConfig())):
        t = make_flat(DIMS, FlatIndexConfig(distance="l2-squared",
                                            quantizer=tq), device="cpu")
        j = jmake_flat(DIMS, jconfig.FlatIndexConfig(distance="l2-squared",
                                                     quantizer=jq))
        assert isinstance(t, QuantizedFlatIndex)
        for idx in (t, j):
            idx.add_batch(np.arange(700), vecs)
        np.testing.assert_array_equal(t.search(vecs[:5], 4).ids,
                                      j.search(vecs[:5], 4).ids)


def test_config_defaults_and_checks_match_jax():
    j, t = JaxConfig(), FlatIndexConfig()
    for f in ("index_type", "distance", "precision", "initial_capacity",
              "search_chunk_size", "flat_approx_recall"):
        assert getattr(t, f) == getattr(j, f)
    t.validate()
    for bad in (dict(distance="l1"), dict(precision="fp16"),
                dict(flat_approx_recall=1.0), dict(flat_approx_recall=-0.5),
                dict(index_type="ivf")):
        with pytest.raises(ValueError):
            FlatIndexConfig(**bad).validate()
        with pytest.raises(ValueError):
            JaxConfig(**bad).validate()
    # every index type the JAX package takes validates in the port
    for kind in ("flat", "hnsw", "dynamic", "multivector", "hfresh"):
        FlatIndexConfig(index_type=kind).validate()
        JaxConfig(index_type=kind).validate()
