"""The vector-index interface every backend implements (port of
``weaviate_tpu/index/base.py``).

Every method is batched: the unit of work is a batch of ids, vectors or
queries, so one device call serves many of them.
"""

from __future__ import annotations

import abc
from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass
class SearchResult:
    """Top-k result for a batch of queries: ids[b, k] (-1 = empty), dists[b, k]."""

    ids: np.ndarray
    dists: np.ndarray


class VectorIndex(abc.ABC):
    """Batched ANN index over internal doc ids."""

    multi_vector: bool = False
    # whether search() accepts a resident filter plane as ``allow_list``;
    # callers resolve the plane's host bitmap for indexes that don't
    supports_filter_planes: bool = False

    @abc.abstractmethod
    def add_batch(self, doc_ids: np.ndarray, vectors: np.ndarray) -> None:
        """Insert/overwrite vectors for the given internal doc ids."""

    @abc.abstractmethod
    def delete(self, doc_ids: np.ndarray) -> None:
        """Remove ids (tombstone semantics — slots masked, space reclaimed later)."""

    @abc.abstractmethod
    def search(
        self,
        queries: np.ndarray,
        k: int,
        allow_list: Optional[np.ndarray] = None,
        est_selectivity: Optional[float] = None,
    ) -> SearchResult:
        """Batched top-k by vector. ``allow_list``: bool mask over doc ids.
        ``est_selectivity``: the inverted index's estimate for the filter —
        used by planner-routed indexes, ignored by the rest."""

    @abc.abstractmethod
    def search_by_distance(
        self,
        queries: np.ndarray,
        max_distance: float,
        allow_list: Optional[np.ndarray] = None,
        limit: int = 1024,
    ) -> SearchResult:
        """All results within max_distance."""

    @abc.abstractmethod
    def count(self) -> int:
        """Live (non-deleted) vector count."""

    @property
    @abc.abstractmethod
    def capacity(self) -> int:
        """Current padded device capacity (doc-id space size)."""

    def contains(self, doc_id: int) -> bool:
        raise NotImplementedError

    def flush(self) -> None:  # durability hook; storage owns real persistence
        pass

    # -- device-state checkpoint (shard boot = load + delta replay)
    def save_vectors(self, path: str, meta: Optional[dict] = None) -> bool:
        """Persist the raw vector tier; False = unsupported by this index."""
        return False

    def load_vectors(self, path: str) -> Optional[dict]:
        """Restore the raw vector tier; returns saved meta, None = no/bad
        checkpoint (or unsupported) — caller falls back to full rebuild."""
        return None

    def drop(self) -> None:
        pass

    # -- tiered residency (warm tier) ---------------------------------------
    # Default: an index type with no device arrays reports zero device rent
    # and stays "resident".
    @property
    def device_resident(self) -> bool:
        """False while this index's device arrays are demoted to host."""
        return True

    def hbm_bytes(self) -> int:
        """Current device-memory rent (0 while demoted / for host-only indexes)."""
        return 0

    def host_tier_bytes(self) -> int:
        """Host-RAM rent of demoted device arrays (warm tier)."""
        return 0

    def demote_device(self) -> int:
        """Move device arrays to host RAM (warm tier); returns device bytes
        released."""
        return 0

    def promote_device(self) -> int:
        """Re-upload demoted arrays; returns device bytes charged."""
        return 0

    def stats(self) -> dict:
        return {"count": self.count(), "capacity": self.capacity}


def run_tier_stable(fn):
    """Run a search closure, retrying when a residency flip lands between
    its tier check and the array access (``ResidencyMoved``). Either tier
    can serve any query, so a concurrent demote/promote must re-route the
    request, never fail it. Two retries bound the case of a flip landing on
    every attempt."""
    from weaviate_tpu_torch.compression.store import ResidencyMoved

    for _ in range(2):
        try:
            return fn()
        except ResidencyMoved:
            continue
    return fn()
