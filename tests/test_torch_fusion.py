"""Parity: the port's hybrid fusion (``ops/fusion.py``, kernel B6b's plain
version, and ``query/fusion.py``) against the JAX package's, on the CPU,
for both algorithms.

Tolerance: fused scores to 1e-5 relative (float32 on both device sides;
the host twins sum in Python floats); page order exactly wherever
neighbouring fused scores differ by more than that, and exactly on the
engineered ties, where both sides put the earlier-inserted key first.
"""

import numpy as np
import pytest
import torch

from weaviate_tpu.ops import fusion as jfusion
from weaviate_tpu.query import fusion as jqfusion
from weaviate_tpu_torch.ops import fusion
from weaviate_tpu_torch.query import fusion as qfusion

RTOL = 1e-5
ALGOS = sorted(qfusion.FUSION_ALGORITHMS)


def _random_sets(rng, n_keys=40, sizes=(17, 23)):
    keys = [f"k{i:03d}" for i in range(n_keys)]
    sets = []
    for sz in sizes:
        pick = rng.choice(n_keys, size=sz, replace=False)
        scores = np.sort(rng.normal(size=sz).astype(np.float32))[::-1]
        sets.append([(keys[int(p)], float(s))
                     for p, s in zip(pick, scores)])
    return sets


def _assert_pages(got, want):
    gk, gs = [k for k, _ in got], np.asarray([s for _, s in got])
    wk, ws = [k for k, _ in want], np.asarray([s for _, s in want])
    assert len(gk) == len(wk)
    np.testing.assert_allclose(gs, ws, rtol=RTOL, atol=1e-6)
    for i in (i for i in range(len(gk)) if gk[i] != wk[i]):
        near = [ws[x] for x in (i - 1, i + 1) if 0 <= x < len(ws)]
        assert any(abs(n - ws[i]) <= RTOL * abs(ws[i]) for n in near), i


@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("sizes", [(17, 23), (1, 40), (32, 32, 5)])
def test_fuse_result_sets_matches_jax(algo, sizes):
    rng = np.random.default_rng(len(sizes) * 7 + sizes[0])
    for _ in range(3):
        sets = _random_sets(rng, sizes=sizes)
        weights = list(rng.random(len(sizes)))
        got = qfusion.fuse_result_sets(sets, weights, 10, algo,
                                       device="cpu")
        _assert_pages(got, jqfusion.fuse_result_sets(sets, weights, 10,
                                                     algo))
        # and the host twin, the port's own oracle
        _assert_pages(got, qfusion.FUSION_ALGORITHMS[algo](sets, weights,
                                                           10))


def test_ranked_fusion_tie_order_matches_host_and_jax():
    """x leads leg A and y leads leg B at rank 0 with equal weights: equal
    sums. The earlier-inserted key (x) comes first on every side."""
    a = [("x", 9.0), ("z", 1.0)]
    b = [("y", 5.0), ("z", 0.5)]
    host = qfusion.ranked_fusion([a, b], [0.5, 0.5], 3)
    dev = qfusion.fuse_result_sets([a, b], [0.5, 0.5], 3, "rankedFusion",
                                   device="cpu")
    jdev = jqfusion.fuse_result_sets([a, b], [0.5, 0.5], 3, "rankedFusion")
    assert host[1][1] == host[2][1]
    assert [k for k, _ in dev] == [k for k, _ in jdev] == ["z", "x", "y"]
    assert [k for k, _ in host] == ["z", "x", "y"]


def test_relative_fusion_single_distinct_score():
    """A leg with one distinct score (and a one-entry leg) normalises to
    1.0 on every side."""
    a = [("x", 7.0), ("y", 7.0), ("z", 7.0)]
    b = [("y", 0.25)]
    dev = qfusion.fuse_result_sets([a, b], [0.5, 0.5], 4,
                                   "relativeScoreFusion", device="cpu")
    jdev = jqfusion.fuse_result_sets([a, b], [0.5, 0.5], 4,
                                     "relativeScoreFusion")
    assert [k for k, _ in dev] == [k for k, _ in jdev] == ["y", "x", "z"]
    np.testing.assert_allclose([s for _, s in dev], [s for _, s in jdev],
                               rtol=1e-6)
    assert dict(dev)["y"] == pytest.approx(1.0)


def test_fusion_empty_and_unknown():
    assert qfusion.fuse_result_sets([], [], 5, "rankedFusion",
                                    device="cpu") == []
    assert qfusion.fuse_result_sets([[], []], [0.5, 0.5], 5,
                                    "relativeScoreFusion", device="cpu") == []
    with pytest.raises(ValueError, match="unknown fusion"):
        qfusion.fuse_result_sets([[("a", 1.0)]], [1.0], 5, "bogusFusion",
                                 device="cpu")
    with pytest.raises(ValueError, match="unknown fusion"):
        fusion.fuse_topk([[0]], [[1.0]], [1.0], 5, "bogusFusion", 1,
                         device="cpu")


def test_assemble_slots_keeps_insertion_order():
    sets = [[("b", 3.0), ("a", 2.0)], [("c", 1.0), ("a", 9.0), ("d", 0.5)],
            [("d", 1.0), ("e", 0.0)]]
    got = qfusion.assemble_slots(sets)
    assert got == jqfusion.assemble_slots(sets)
    keys, slots, scores = got
    assert keys == ["b", "a", "c", "d", "e"]
    assert slots == [[0, 1], [2, 1, 3], [3, 4]]
    assert scores == [[3.0, 2.0], [1.0, 9.0, 0.5], [1.0, 0.0]]


@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("legs,width,union,k", [
    (2, 32, 64, 10), (3, 8, 16, 16), (1, 64, 64, 5), (4, 128, 256, 40)])
def test_topk_kernels_plain_versions_match_jax(algo, legs, width, union, k):
    """The dense entry points on raw slot matrices: -1 pads, a slot
    repeated within a leg, slots past the union (dropped), equal scores."""
    rng = np.random.default_rng(legs * 1000 + width + k)
    slots = rng.integers(0, union + 4, (legs, width)).astype(np.int32)
    slots[rng.random((legs, width)) < 0.2] = -1
    slots[0, 1] = slots[0, 0] = 3  # a repeat within one leg
    scores = np.round(rng.normal(size=(legs, width)), 1).astype(np.float32)
    weights = rng.random(legs).astype(np.float32)
    if algo == "rankedFusion":
        jv, ji = jfusion.ranked_fusion_topk(slots, weights, k, union)
        tv, ti = fusion.ranked_fusion_topk(
            torch.from_numpy(slots), torch.from_numpy(weights), k, union)
    else:
        jv, ji = jfusion.relative_score_fusion_topk(slots, scores, weights,
                                                    k, union)
        tv, ti = fusion.relative_score_fusion_topk(
            torch.from_numpy(slots), torch.from_numpy(scores),
            torch.from_numpy(weights), k, union)
    jv, ji = np.asarray(jv), np.asarray(ji)
    tv, ti = tv.numpy(), ti.numpy()
    np.testing.assert_allclose(tv, jv, rtol=RTOL, atol=1e-6)
    np.testing.assert_array_equal(ti == -1, ji == -1)
    for i in np.nonzero(ti != ji)[0]:
        assert abs(jv[i] - jv[i - 1 if i else i + 1]) <= RTOL * abs(jv[i])


def test_one_dispatch_a_fusion():
    before = fusion.dispatch_count()
    qfusion.fuse_result_sets(_random_sets(np.random.default_rng(1)),
                             [0.5, 0.5], 10, "relativeScoreFusion",
                             device="cpu")
    assert fusion.dispatch_count() == before + 1
