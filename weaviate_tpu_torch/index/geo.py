"""Geo index: vectorized haversine range queries over coordinate columns
(port of ``weaviate_tpu/index/geo.py``).

(id, lat, lon) columns and ONE vectorized haversine per query: exact (no
ef or recall knob) and branch-free. Below ``_DEVICE_CUTOFF`` points it is
host numpy (float64); from the cutoff up, ``_dists`` runs on the index's
device as torch ops in float32 (the JAX package's device path: its
``jnp.asarray`` of float64 columns is float32 without x64), then one
read-back of [N]. An elementwise pass: no hand-written kernel. The
columnar filter engine (``inverted/columnar.py``) embeds its own host
haversine; this class is the standalone per-property index.
"""

from __future__ import annotations

import numpy as np
import torch

from weaviate_tpu_torch.index.store import resolve_device

# from this many points, evaluation moves to the device (one [N] pass)
_DEVICE_CUTOFF = 2_000_000

EARTH_RADIUS_M = 6371088.0


def haversine_m(lat0: float, lon0: float, lat: np.ndarray,
                lon: np.ndarray) -> np.ndarray:
    """Great-circle distance in meters (reference ``geo_spatial.go``)."""
    p0 = np.radians(lat0)
    p1 = np.radians(lat)
    dp = np.radians(lat - lat0)
    dl = np.radians(lon - lon0)
    a = np.sin(dp / 2.0) ** 2 + np.cos(p0) * np.cos(p1) * np.sin(dl / 2.0) ** 2
    return 2.0 * EARTH_RADIUS_M * np.arcsin(np.sqrt(np.clip(a, 0.0, 1.0)))


def haversine_device(lat0: float, lon0: float, la: torch.Tensor,
                     lo: torch.Tensor) -> torch.Tensor:
    """The device path's haversine over float32 columns ``la``/``lo``, the
    JAX package's expression step for step (``np.cos(p0)`` a Python scalar,
    every other step float32) -> [N] float32 meters."""
    p0 = np.radians(lat0)
    dp = torch.deg2rad(la - lat0)
    dl = torch.deg2rad(lo - lon0)
    a = (torch.sin(dp / 2.0) ** 2
         + float(np.cos(p0)) * torch.cos(torch.deg2rad(la))
         * torch.sin(dl / 2.0) ** 2)
    return 2.0 * EARTH_RADIUS_M * torch.arcsin(
        torch.sqrt(torch.clamp(a, 0.0, 1.0)))


class GeoIndex:
    """Per-property geo point set with range + kNN queries, its device
    path on ``device`` (the card unless the caller names another)."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._ids = np.empty(16, np.int64)
        self._lat = np.empty(16, np.float64)
        self._lon = np.empty(16, np.float64)
        self._valid = np.zeros(16, bool)
        self._n = 0
        self._row_of: dict[int, int] = {}  # doc -> latest live row
        # the columns' float32 device copies and the row count they hold
        self._dev_cols: tuple = (0, None, None)

    def add(self, doc_id: int, lat: float, lon: float) -> None:
        doc_id = int(doc_id)
        prev = self._row_of.get(doc_id)
        if prev is not None:
            # re-add/update: the old coordinates must stop matching
            self._valid[prev] = False
        if self._n == len(self._ids):
            self._ids = np.concatenate([self._ids, np.empty_like(self._ids)])
            self._lat = np.concatenate([self._lat, np.empty_like(self._lat)])
            self._lon = np.concatenate([self._lon, np.empty_like(self._lon)])
            self._valid = np.concatenate(
                [self._valid, np.zeros_like(self._valid)])
        self._ids[self._n] = doc_id
        self._lat[self._n] = lat
        self._lon[self._n] = lon
        self._valid[self._n] = True
        self._row_of[doc_id] = self._n
        self._n += 1

    def add_batch(self, doc_ids: np.ndarray, lats: np.ndarray,
                  lons: np.ndarray) -> None:
        """``add`` of each point in order, as whole-column writes: a doc's
        last point in the batch is its live row, every earlier row of it
        (in the index or the batch) stops matching."""
        ids = np.asarray(doc_ids, np.int64).reshape(-1)
        m = len(ids)
        if m == 0:
            return
        need = self._n + m
        if need > len(self._ids):
            cap = len(self._ids)
            while cap < need:
                cap *= 2
            grow = cap - len(self._ids)
            self._ids = np.concatenate([self._ids, np.empty(grow, np.int64)])
            self._lat = np.concatenate([self._lat,
                                        np.empty(grow, np.float64)])
            self._lon = np.concatenate([self._lon,
                                        np.empty(grow, np.float64)])
            self._valid = np.concatenate([self._valid, np.zeros(grow, bool)])
        rows = np.arange(self._n, need)
        self._ids[rows] = ids
        self._lat[rows] = np.asarray(lats, np.float64).reshape(-1)
        self._lon[rows] = np.asarray(lons, np.float64).reshape(-1)
        # the last occurrence of each id in the batch is its live row
        last = np.zeros(m, bool)
        last[m - 1 - np.unique(ids[::-1], return_index=True)[1]] = True
        self._valid[rows] = last
        id_list = ids.tolist()
        row_of = self._row_of
        prev = [row_of.get(d) for d in id_list]
        old = [r for r in prev if r is not None]
        if old:
            self._valid[old] = False
        row_of.update(zip(id_list, rows.tolist()))
        self._n = need

    def delete(self, doc_id: int) -> None:
        row = self._row_of.pop(int(doc_id), None)
        if row is not None:
            self._valid[row] = False

    def __len__(self) -> int:
        return len(self._row_of)

    def _device_columns(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The first ``_n`` rows of the columns as float32 on the device,
        uploaded again only after rows were added (rows are append-only;
        a delete only clears a host valid bit)."""
        n, la, lo = self._dev_cols
        if n != self._n:
            la = torch.from_numpy(self._lat[: self._n].astype(np.float32))
            lo = torch.from_numpy(self._lon[: self._n].astype(np.float32))
            la, lo = la.to(self.device), lo.to(self.device)
            self._dev_cols = (self._n, la, lo)
        return la, lo

    def _dists(self, lat: float, lon: float) -> tuple[np.ndarray, np.ndarray]:
        ids = self._ids[: self._n]
        if self._n >= _DEVICE_CUTOFF:
            la, lo = self._device_columns()
            # one [N] read-back feeding the host radius filter
            d = haversine_device(lat, lon, la, lo).cpu().numpy()
        else:
            d = haversine_m(lat, lon, self._lat[: self._n],
                            self._lon[: self._n])
        return ids, d

    def within_range(self, lat: float, lon: float,
                     max_distance_m: float) -> np.ndarray:
        """Doc ids within the radius (sorted ascending, live rows only)."""
        if self._n == 0:
            return np.empty(0, np.int64)
        ids, d = self._dists(lat, lon)
        hit = ids[(d <= max_distance_m) & self._valid[: self._n]]
        return np.unique(hit)

    def knn(self, lat: float, lon: float, k: int
            ) -> tuple[np.ndarray, np.ndarray]:
        """(ids, meters) of the k nearest live points."""
        if self._n == 0:
            return np.empty(0, np.int64), np.empty(0, np.float64)
        ids, d = self._dists(lat, lon)
        d = np.where(self._valid[: self._n], d, np.inf)
        order = smallest_stable(d, k)
        order = order[np.isfinite(d[order])]
        return ids[order].astype(np.int64), d[order]


def smallest_stable(d: np.ndarray, k: int) -> np.ndarray:
    """``np.argsort(d, kind="stable")[:k]`` in O(N): the rows not above the
    k-th smallest value, in row order, then stably sorted (ties stay in row
    order, as the full stable sort keeps them)."""
    if k <= 0:
        return np.empty(0, np.int64)
    if k >= len(d):
        return np.argsort(d, kind="stable")
    kth = np.partition(d, k - 1)[k - 1]
    cand = np.flatnonzero(d <= kth)
    return cand[np.argsort(d[cand], kind="stable")][:k]
