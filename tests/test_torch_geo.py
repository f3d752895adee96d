"""The geo index (port slice 7b) against the JAX package on the CPU.

- ``haversine_m``, ``within_range``, ``knn``, deletes and re-adds with the
  host path (below ``_DEVICE_CUTOFF``): the same numpy float64 code in
  both packages, so ids and meters are equal; the port's whole-column
  ``add_batch`` (ids repeated within a batch and across batches) and its
  O(N) ``knn`` selection leave the JAX index's rows, valid bits and
  answers.
- The device path, with ``_DEVICE_CUTOFF`` set to 0 in both modules at run
  time: the port's torch ops against JAX's float32 program on the same
  points, meters within 2e-6 relative + 0.05 m (float32 transcendentals
  of two libraries); ``within_range`` ids equal but for points whose
  JAX distance lies within that tolerance of the radius, each such point
  checked; ``knn`` ids equal but for swaps within that tolerance.
"""

import numpy as np
import pytest

from weaviate_tpu.index import geo as jgeo
from weaviate_tpu_torch.index import geo as tgeo

RTOL, ATOL = 2e-6, 0.05


def _points(seed, n=4000):
    rng = np.random.default_rng(seed)
    lat = rng.uniform(-89.0, 89.0, n)
    lon = rng.uniform(-180.0, 180.0, n)
    # a cluster around Berlin, so small radii hit many points
    lat[: n // 4] = 52.52 + rng.normal(0, 0.5, n // 4)
    lon[: n // 4] = 13.405 + rng.normal(0, 0.8, n // 4)
    return np.arange(10, 10 + n) * 3, lat, lon


def _pair(seed, n=4000):
    ids, lat, lon = _points(seed, n)
    j, t = jgeo.GeoIndex(), tgeo.GeoIndex(device="cpu")
    for g in (j, t):
        g.add_batch(ids, lat, lon)
        for d in ids[::17]:
            g.delete(int(d))
        for d, la, lo in zip(ids[5:40:5], lat[60:95:5], lon[60:95:5]):
            g.add(int(d), float(la), float(lo))  # updates move points
    return j, t


QUERIES = [(52.52, 13.405, 1_000), (52.52, 13.405, 50_000),
           (48.1351, 11.582, 500_000), (-33.9, 151.2, 120_000),
           (0.0, 0.0, 1.0)]


def test_haversine_matches_jax():
    _, lat, lon = _points(1)
    np.testing.assert_array_equal(tgeo.haversine_m(48.8566, 2.3522, lat, lon),
                                  jgeo.haversine_m(48.8566, 2.3522, lat, lon))
    d = tgeo.haversine_m(48.8566, 2.3522, np.asarray([51.5074]),
                         np.asarray([-0.1278]))[0]
    assert 340_000 < d < 347_000


@pytest.mark.parametrize("lat0,lon0,radius", QUERIES)
def test_host_path_matches_jax(lat0, lon0, radius):
    j, t = _pair(2)
    np.testing.assert_array_equal(t.within_range(lat0, lon0, radius),
                                  j.within_range(lat0, lon0, radius))
    for k in (1, 10, 100):
        ti, td = t.knn(lat0, lon0, k)
        ji, jd = j.knn(lat0, lon0, k)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(td, jd)
    assert len(t) == len(j)


def test_reference_cities_delete_and_dedup():
    g = tgeo.GeoIndex(device="cpu")
    g.add(1, 52.5200, 13.4050)
    g.add(2, 52.3906, 13.0645)
    g.add(3, 53.5511, 9.9937)
    g.add(4, 48.1351, 11.5820)
    assert g.within_range(52.5200, 13.4050, 50_000).tolist() == [1, 2]
    ids, d = g.knn(52.5200, 13.4050, 3)
    assert ids.tolist() == [1, 2, 3]
    assert d[0] < 1.0 and 20_000 < d[1] < 35_000 and 200_000 < d[2] < 300_000
    g = tgeo.GeoIndex(device="cpu")
    g.add(1, 10.0, 10.0)
    g.add(2, 10.001, 10.001)
    g.delete(2)
    assert g.within_range(10.0, 10.0, 10_000).tolist() == [1]
    g.add(2, 10.0005, 10.0005)
    assert g.within_range(10.0, 10.0, 10_000).tolist() == [1, 2]
    assert len(g) == 2
    assert tgeo.GeoIndex(device="cpu").knn(0.0, 0.0, 3)[0].size == 0


@pytest.fixture
def device_path(monkeypatch):
    monkeypatch.setattr(jgeo, "_DEVICE_CUTOFF", 0)
    monkeypatch.setattr(tgeo, "_DEVICE_CUTOFF", 0)


def _near(d, radius):
    return np.abs(d - radius) <= ATOL + RTOL * radius


@pytest.mark.parametrize("lat0,lon0,radius", QUERIES)
def test_device_path_matches_jax(device_path, lat0, lon0, radius):
    j, t = _pair(3)
    ids_j, dj = j._dists(lat0, lon0)
    ids_t, dt = t._dists(lat0, lon0)
    assert dt.dtype == np.float32 and dj.dtype == np.float32
    np.testing.assert_array_equal(ids_t, ids_j)
    np.testing.assert_allclose(dt, dj, rtol=RTOL, atol=ATOL)
    # float32 on both sides: the host float64 answer differs from both
    host = tgeo.haversine_m(lat0, lon0, t._lat[: t._n], t._lon[: t._n])
    np.testing.assert_allclose(dt, host, rtol=1e-5, atol=1.0)
    rj = j.within_range(lat0, lon0, radius)
    rt = t.within_range(lat0, lon0, radius)
    live = j._valid[: j._n]
    near = set(ids_j[live & _near(dj, radius)].tolist())
    assert set(rt.tolist()) ^ set(rj.tolist()) <= near
    for k in (1, 10, 100):
        ti, td = t.knn(lat0, lon0, k)
        ji, jd = j.knn(lat0, lon0, k)
        np.testing.assert_allclose(td, jd, rtol=RTOL, atol=ATOL)
        diff = ti != ji
        if diff.any():
            # a swap of two points whose distances tie within float32
            live_d = dict(zip(ids_j[live].tolist(), dj[live].tolist()))
            np.testing.assert_allclose(
                [live_d[i] for i in ti[diff].tolist()], jd[diff],
                rtol=RTOL, atol=ATOL)


def test_device_columns_follow_appends(device_path):
    """The float32 columns upload once and again after an append; a delete
    needs none (the host valid bits mask it)."""
    t = tgeo.GeoIndex(device="cpu")
    t.add(1, 52.52, 13.405)
    assert t.within_range(52.52, 13.405, 10).tolist() == [1]
    cols = t._dev_cols
    t.delete(1)
    assert t.within_range(52.52, 13.405, 10).size == 0
    assert t._dev_cols is cols
    t.add(2, 52.52, 13.405)
    assert t.within_range(52.52, 13.405, 10).tolist() == [2]
    assert t._dev_cols[0] == 2



def test_add_batch_and_selection_match_jax():
    rng = np.random.default_rng(9)
    j, t = jgeo.GeoIndex(), tgeo.GeoIndex(device="cpu")
    for step in range(4):
        n = int(rng.integers(1, 40))
        ids = rng.integers(0, 30, n)          # repeats within and across
        lat = rng.uniform(-10, 10, n)
        lon = rng.uniform(-10, 10, n)
        for g in (j, t):
            g.add_batch(ids, lat, lon)
            g.delete(int(ids[0]))
        assert t._n == j._n and t._row_of == j._row_of
        for a in ("_ids", "_lat", "_lon", "_valid"):
            np.testing.assert_array_equal(getattr(t, a)[: t._n],
                                          getattr(j, a)[: j._n])
        for k in (1, 5, 29, 100):
            ti, td = t.knn(0.0, 0.0, k)
            ji, jd = j.knn(0.0, 0.0, k)
            np.testing.assert_array_equal(ti, ji)
            np.testing.assert_array_equal(td, jd)
    d = rng.integers(0, 5, 200).astype(np.float64)   # many exact ties
    d[::7] = np.inf
    for k in (0, 1, 3, 50, 199, 200, 500):
        np.testing.assert_array_equal(tgeo.smallest_stable(d, k),
                                      np.argsort(d, kind="stable")[:k])
