"""Parity: weaviate_tpu_torch/ops/distance.py and ops/topk.py against the JAX
package's ops, on the same numpy-seeded inputs, on the CPU.

Tolerances: float32 rtol 1e-5 / atol 1e-4 (float32 sums in another order);
bf16 precision rtol 1e-4 / atol 1e-3 (the same bf16-rounded products, float32
sums in another order). Ids must be identical.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from weaviate_tpu.ops import distance as jd
from weaviate_tpu.ops import topk as jt
from weaviate_tpu_torch.ops import distance as td
from weaviate_tpu_torch.ops import topk as tt

TOL = {"fp32": dict(rtol=1e-5, atol=1e-4), "bf16": dict(rtol=1e-4, atol=1e-3)}


def _data(metric, b=4, n=50, d=16, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, d)).astype(np.float32)
    c = rng.standard_normal((n, d)).astype(np.float32)
    if metric == "hamming":  # few distinct values, so dimensions can match
        q, c = np.round(q), np.round(c)
    if metric == "cosine":
        q = q / np.linalg.norm(q, axis=1, keepdims=True)
        c = c / np.linalg.norm(c, axis=1, keepdims=True)
    return q, c


def _close(t, j, precision):
    np.testing.assert_allclose(t.numpy(), np.asarray(j, np.float32),
                               **TOL[precision])


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("metric", td.METRICS)
def test_pairwise_distance(metric, precision):
    q, c = _data(metric)
    sq = (c * c).sum(1).astype(np.float32)
    for norms in (None, sq):
        j = jd.pairwise_distance(jnp.asarray(q), jnp.asarray(c), metric,
                                 None if norms is None else jnp.asarray(norms),
                                 precision)
        t = td.pairwise_distance(torch.from_numpy(q), torch.from_numpy(c),
                                 metric,
                                 None if norms is None else torch.from_numpy(norms),
                                 precision)
        _close(t, j, precision)


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("metric", td.METRICS)
def test_gather_and_pairwise_within_candidates(metric, precision):
    q, c = _data(metric, seed=1)
    ids = np.random.default_rng(2).integers(0, len(c), (4, 8)).astype(np.int32)
    j = jd.gather_distance(jnp.asarray(q), jnp.asarray(c), jnp.asarray(ids),
                           metric, precision)
    t = td.gather_distance(torch.from_numpy(q), torch.from_numpy(c),
                           torch.from_numpy(ids), metric, precision)
    _close(t, j, precision)
    j = jd.candidate_pairwise(jnp.asarray(c), jnp.asarray(ids), metric,
                              precision)
    t = td.candidate_pairwise(torch.from_numpy(c), torch.from_numpy(ids),
                              metric, precision)
    _close(t, j, precision)
    v = c[ids]
    j = jd.vectors_pairwise(jnp.asarray(v), metric, precision)
    t = td.vectors_pairwise(torch.from_numpy(v), metric, precision)
    _close(t, j, precision)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_normalize(dtype):
    v = np.random.default_rng(3).standard_normal((6, 16)).astype(np.float32)
    v[0] = 0.0  # the eps floor
    j = jd.normalize(jnp.asarray(v, getattr(jnp, dtype)))
    t = td.normalize(torch.from_numpy(v).to(getattr(torch, dtype)))
    assert str(t.dtype).endswith(dtype)
    _close(t.float(), np.asarray(j.astype(jnp.float32)),
           "fp32" if dtype == "float32" else "bf16")


def _ties(b=3, n=40, seed=4):
    """Distances with many exact ties (a few distinct values)."""
    return np.random.default_rng(seed).integers(0, 6, (b, n)).astype(np.float32)


def test_select_topk_exact_with_ties():
    d = _ties()
    for k in (1, 5, 40):
        jv, ji = jd.select_topk(jnp.asarray(d), k)
        tv, ti = td.select_topk(torch.from_numpy(d), k, approx_recall=0.9)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_topk_merges_with_ties():
    rng = np.random.default_rng(5)
    va, vb = _ties(n=7, seed=6), _ties(n=9, seed=7)
    ia = rng.integers(0, 100, va.shape).astype(np.int32)
    ib = rng.integers(0, 100, vb.shape).astype(np.int32)
    jv, ji = jt.merge_topk(*map(jnp.asarray, (va, ia, vb, ib)), 6)
    tv, ti = tt.merge_topk(*map(torch.from_numpy, (va, ia, vb, ib)), 6)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))

    vs = rng.integers(0, 4, (5, 3, 4)).astype(np.float32)
    is_ = rng.integers(0, 100, (5, 3, 4)).astype(np.int32)
    jv, ji = jt.merge_candidate_stack(jnp.asarray(vs), jnp.asarray(is_), 7)
    tv, ti = tt.merge_candidate_stack(torch.from_numpy(vs),
                                      torch.from_numpy(is_), 7)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))

    d = _ties(seed=8)
    for mask in (None, rng.random(40) > 0.5, rng.random((3, 40)) > 0.5):
        jv, ji = jt.masked_topk(jnp.asarray(d), 25,
                                None if mask is None else jnp.asarray(mask))
        tv, ti = tt.masked_topk(torch.from_numpy(d), 25,
                                None if mask is None else torch.from_numpy(mask))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("metric", td.METRICS)
def test_flat_search(metric, precision):
    q, c = _data(metric, b=5, n=103, d=16, seed=9)
    rng = np.random.default_rng(10)
    valid = rng.random(103) > 0.2
    allow = rng.random(103) > 0.3
    sq = (c * c).sum(1).astype(np.float32)
    for chunk, k, use_valid, use_allow in ((0, 10, False, False),
                                           (25, 10, True, False),
                                           (8, 10, True, True),
                                           (40, 120, False, True)):
        jkw = dict(k=k, metric=metric, chunk_size=chunk, precision=precision,
                   valid_mask=jnp.asarray(valid) if use_valid else None,
                   allow_mask=jnp.asarray(allow) if use_allow else None,
                   corpus_sqnorms=jnp.asarray(sq) if metric == "l2-squared"
                   else None)
        tkw = dict(k=k, metric=metric, chunk_size=chunk, precision=precision,
                   valid_mask=torch.from_numpy(valid) if use_valid else None,
                   allow_mask=torch.from_numpy(allow) if use_allow else None,
                   corpus_sqnorms=torch.from_numpy(sq)
                   if metric == "l2-squared" else None)
        if k > 103:  # k beyond the corpus: JAX's top_k refuses, so pad here
            jkw["k"] = 103
        jv, ji = jd.flat_search(jnp.asarray(q), jnp.asarray(c), **jkw)
        tv, ti = td.flat_search(torch.from_numpy(q), torch.from_numpy(c), **tkw)
        assert ti.dtype == torch.int32 and tv.dtype == torch.float32
        jv, ji = np.asarray(jv), np.asarray(ji)
        np.testing.assert_array_equal(ti.numpy()[:, :jv.shape[1]], ji)
        _close(tv[:, :jv.shape[1]], jv, precision)
        if k > 103:
            assert (ti.numpy()[:, 103:] == -1).all()
            assert (tv.numpy()[:, 103:] == td.MASK_DISTANCE).all()
