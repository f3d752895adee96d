"""Parity: the port's segmented k-means (``compression/kmeans.py``) against
the JAX package's, on the CPU.

- From the same seed both draw the same initial picks (numpy's
  ``default_rng``), and on well-separated data ten Lloyd iterations give the
  same codebooks to 1e-4.
- The distortion falls at least as far as in JAX's
  ``test_segmented_kmeans_reduces_distortion`` (and below its 0.5 floor).
- Ties follow JAX: the assignment takes the first of equal centroids, and
  the empty-cluster reseed takes the farthest points with the lower point
  first on equal residuals (``lax.top_k``), the i-th empty slot the i-th.
"""

import numpy as np
import pytest
import torch

from weaviate_tpu.compression import kmeans as jk
from weaviate_tpu_torch.compression import kmeans as tk

# float32 sums in another order (XLA's and torch's), over a few iterations
CODEBOOK_TOL = 1e-4


def _clustered(seed, n, d, clusters, spread=0.15):
    rng = np.random.default_rng(seed)
    centers = 3.0 * rng.standard_normal((clusters, d)).astype(np.float32)
    assign = rng.integers(0, clusters, size=n)
    return (centers[assign]
            + spread * rng.standard_normal((n, d))).astype(np.float32)


@pytest.mark.parametrize("segments,n,d,c", [(1, 512, 16, 8), (4, 600, 4, 16),
                                            (3, 256, 5, 256), (2, 200, 5, 256)],
                         ids=["one_segment", "four_segments", "n_equals_c",
                              "n_below_c"])
def test_segmented_kmeans_matches_jax(segments, n, d, c):
    data = np.stack([_clustered(s, n, d, 8) for s in range(segments)])
    if n < c:
        # the reseed takes c farthest points: both packages refuse
        with pytest.raises(ValueError):
            jk.segmented_kmeans(data, c, iters=10, seed=3)
        with pytest.raises(ValueError, match="at least"):
            tk.segmented_kmeans(data, c, iters=10, seed=3, device="cpu")
        return
    want = jk.segmented_kmeans(data, c, iters=10, seed=3)
    got = tk.segmented_kmeans(data, c, iters=10, seed=3, device="cpu")
    assert got.shape == want.shape == (segments, c, d)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(want), rtol=CODEBOOK_TOL,
                               atol=CODEBOOK_TOL)


def test_segmented_kmeans_reduces_distortion_as_far_as_jax(rng):
    # JAX's test's data: the shared fixture's seed and its generator
    from tests.test_compression import clustered

    data = clustered(rng, 512, 16, n_clusters=8)[None, :, :]
    got = tk.segmented_kmeans(data, 8, iters=10, device="cpu")
    want = np.asarray(jk.segmented_kmeans(data, 8, iters=10))

    def distortion(cents):
        return ((data[0][:, None, :] - cents[0][None, :, :]) ** 2).sum(
            -1).min(1).mean()

    assert distortion(got) < 0.5
    assert distortion(got) <= distortion(want) + 1e-5


def test_assign_codes_takes_the_first_of_tied_centroids():
    rng = np.random.default_rng(2)
    cents = rng.standard_normal((2, 6, 3)).astype(np.float32)
    cents[:, 4] = cents[:, 1]  # slots 1 and 4 tie exactly
    cents[:, 5] = cents[:, 1]
    data = np.concatenate([cents[:, [1, 1, 4]], rng.standard_normal(
        (2, 40, 3)).astype(np.float32)], axis=1)
    want = np.asarray(jk.assign_codes(data, cents))
    got = tk.assign_codes(data, cents, device="cpu")
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    assert (got[:, :3] == 1).all()
    wide = np.concatenate([cents, cents[:, :1].repeat(300, axis=1)], axis=1)
    np.testing.assert_array_equal(
        tk.assign_codes(data, wide, device="cpu"),
        np.asarray(jk.assign_codes(data, wide)))
    assert tk.assign_codes(data, wide, device="cpu").dtype == np.int32


def test_empty_cluster_reseed_takes_the_farthest_points_lower_first():
    # four centroids, two of which no point is near: both clusters go empty
    # and reseed to the farthest points. Points 2, 5 and 7 sit at the same
    # residual (duplicates), the largest: the reseed takes 2 then 5.
    pts = np.zeros((1, 8, 2), np.float32)
    pts[0, :, 0] = [0.0, 0.1, 5.0, -0.1, 0.05, 5.0, 0.2, 5.0]
    pts[0, :, 1] = [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0]
    init = np.array([[[0.0, 0.0], [5.0, 0.0], [100.0, 100.0],
                      [-100.0, -100.0]]], np.float32)
    # one iteration with every point at 0 or 5 leaves no residual tie; so
    # start from a centroid set that puts the 5s with the 0s
    init2 = np.array([[[1.0, 0.0], [90.0, 90.0], [100.0, 100.0],
                       [-100.0, -100.0]]], np.float32)
    for start in (init, init2):
        want = np.asarray(jk._lloyd(pts, start, 1, 256))
        got = tk._lloyd(torch.from_numpy(pts), torch.from_numpy(start), 1,
                        256).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    got = tk._lloyd(torch.from_numpy(pts), torch.from_numpy(init2), 1,
                    256).numpy()
    # clusters 1-3 empty: reseeded to the farthest points 2, 5, 7 in order
    np.testing.assert_array_equal(got[0, 1:], pts[0, [2, 5, 7]])


def test_entry_points_default_to_the_card(monkeypatch):
    """``segmented_kmeans`` and ``assign_codes`` run on the card unless the
    caller names a device, as every entry point of the port does: with no
    card and no device they refuse instead of fitting on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = np.zeros((2, 8, 4), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tk.segmented_kmeans(data, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tk.assign_codes(data, np.zeros((2, 4, 4), np.float32))
