"""Flat (brute-force) index (port of ``FlatIndex`` and ``make_flat`` from
``weaviate_tpu/index/flat.py``).

The whole corpus lives in device memory and a query batch is one masked
product + top-k. For l2-squared at bf16 with approximate selection allowed
and k <= 64, the scan runs in the fused kernel (``ops/fused_flat.py``);
every other request takes ``ops/distance.py flat_search``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from weaviate_tpu_torch.index.base import (
    SearchResult,
    VectorIndex,
    run_tier_stable,
)
from weaviate_tpu_torch.index.store import DeviceVectorStore
from weaviate_tpu_torch.ops import fused_flat
from weaviate_tpu_torch.ops.distance import MASK_DISTANCE, flat_search, normalize
from weaviate_tpu_torch.schema.config import FlatIndexConfig


def make_flat(dims: int, config: Optional[FlatIndexConfig] = None,
              device=None) -> VectorIndex:
    """Flat-index factory: raw corpus in device memory. A quantized flat
    index (code planes + rescore tier) comes with the quantizer slice."""
    config = config or FlatIndexConfig()
    if config.quantizer is not None and getattr(config.quantizer, "enabled", True):
        raise NotImplementedError(
            "quantized flat index: not ported yet (ROADMAP queue A, the "
            "quantizer slice)")
    return FlatIndex(dims, config, device=device)


class FlatIndex(VectorIndex):
    def __init__(self, dims: int, config: Optional[FlatIndexConfig] = None,
                 device=None):
        self.dims = dims
        self.config = config or FlatIndexConfig()
        self.metric = self.config.distance
        self.store = DeviceVectorStore(
            dims,
            capacity=self.config.initial_capacity,
            normalized=(self.metric == "cosine"),
            device=device,
        )

    # -- VectorIndex ------------------------------------------------------
    def add_batch(self, doc_ids: np.ndarray, vectors: np.ndarray) -> None:
        self.store.put(doc_ids, vectors)

    def delete(self, doc_ids: np.ndarray) -> None:
        self.store.delete(doc_ids)

    def search(
        self,
        queries: np.ndarray,
        k: int,
        allow_list: Optional[np.ndarray] = None,
        approx_recall: Optional[float] = None,
        est_selectivity: Optional[float] = None,
    ) -> SearchResult:
        """Top-k scan. ``approx_recall`` overrides the config knob (range
        queries force 0.0: approximate selection may drop in-range rows).
        ``est_selectivity`` is accepted for signature parity and ignored —
        a flat scan is the exact plan."""
        # a demote/promote between the residency check and the tensor
        # access re-routes the query, never fails it
        return run_tier_stable(
            lambda: self._search_impl(queries, k, allow_list, approx_recall))

    def _search_impl(
        self,
        queries: np.ndarray,
        k: int,
        allow_list: Optional[np.ndarray] = None,
        approx_recall: Optional[float] = None,
    ) -> SearchResult:
        queries = np.ascontiguousarray(
            np.atleast_2d(np.asarray(queries, np.float32)))
        if queries.shape[-1] != self.store.dims:
            raise ValueError(
                f"query dims {queries.shape[-1]} != index dims {self.store.dims}"
            )
        if approx_recall is None:
            approx_recall = self.config.flat_approx_recall
            if approx_recall < 0.0:
                # unset: follow the hot-reloadable fleet default; 0.0 means
                # pinned exact and never follows it
                from weaviate_tpu_torch.utils.runtime_config import (
                    FLAT_APPROX_RECALL_DEFAULT,
                )

                approx_recall = FLAT_APPROX_RECALL_DEFAULT.get()
        if not self.store.device_resident:
            # warm tier: the corpus is demoted to host RAM — serve exactly
            # from there, never re-renting device memory per query
            from weaviate_tpu_torch.index.hnsw.backend import host_store_topk

            d, ids = host_store_topk(
                self.store, self.metric, queries, k, allow_list)
            return SearchResult(ids=ids, dists=d)
        # one consistent device-state snapshot (concurrent writers swap it)
        corpus, valid, sqnorms = self.store.snapshot()
        qt = torch.from_numpy(queries).to(corpus.device)
        if self.metric == "cosine":
            qt = normalize(qt)
        cap = corpus.shape[0]
        allow = None
        if allow_list is not None:
            allow = _pad_mask(allow_list, cap, corpus.device)
        chunk = self.config.search_chunk_size
        # the fused kernel, where its semantics match the request: bf16 is
        # the configured precision, approximate selection is permitted
        # (approx_recall=0.0 pins exact — range queries ride that), and k is
        # within the kernel's extract-min rounds
        if (self.metric == "l2-squared" and sqnorms is not None
                and self.config.precision == "bf16"
                and approx_recall > 0.0 and k <= fused_flat.MAX_K):
            m = valid if allow is None else (valid & allow)
            csz = min(chunk or cap, cap)
            # the live candidate count sizes the kernel's fold so its
            # collision-loss bound holds against the real population. With
            # a filter the population |valid & allow| is unknown host-side:
            # use the inclusion-exclusion lower bound max(live+|allow|-cap,
            # 1), which only ever degrades toward exact (fold=1) selection
            live = self.store.live_count
            if allow_list is not None:
                allow_n = int(np.count_nonzero(
                    np.asarray(allow_list, bool)))
                live = max(1, live + allow_n - cap)
            if fused_flat.fits(cap, csz):
                d, ids = fused_flat.fused_flat_topk(
                    qt, corpus, sqnorms, m, k, chunk_size=csz,
                    live_rows=fused_flat.bucket_live(live))
                return SearchResult(ids=ids.cpu().numpy(),
                                    dists=d.cpu().numpy())
        d, ids = flat_search(
            qt,
            corpus,
            k=k,
            metric=self.metric,
            valid_mask=valid,
            allow_mask=allow,
            corpus_sqnorms=sqnorms if self.metric == "l2-squared" else None,
            chunk_size=chunk if cap > chunk else 0,
            precision=self.config.precision,
            approx_recall=approx_recall,
        )
        return SearchResult(ids=ids.cpu().numpy(), dists=d.cpu().numpy())

    def search_by_distance(
        self,
        queries: np.ndarray,
        max_distance: float,
        allow_list: Optional[np.ndarray] = None,
        limit: int = 1024,
    ) -> SearchResult:
        k = min(limit, max(1, self.store.live_count))
        res = self.search(queries, k, allow_list, approx_recall=0.0)
        keep = res.dists <= max_distance
        ids = np.where(keep, res.ids, -1)
        dists = np.where(keep, res.dists, np.float32(MASK_DISTANCE))
        return SearchResult(ids=ids, dists=dists)

    def count(self) -> int:
        return self.store.live_count

    @property
    def capacity(self) -> int:
        return self.store.capacity

    def contains(self, doc_id: int) -> bool:
        return self.store.contains(doc_id)

    def save_vectors(self, path: str, meta: Optional[dict] = None) -> bool:
        self.store.save(path, meta)
        return True

    def load_vectors(self, path: str) -> Optional[dict]:
        return self.store.load(path)

    # -- tiered residency ---------------------------------------------------
    @property
    def device_resident(self) -> bool:
        return self.store.device_resident

    def hbm_bytes(self) -> int:
        return self.store.nbytes

    def host_tier_bytes(self) -> int:
        return self.store.host_bytes

    def demote_device(self) -> int:
        return self.store.detach()

    def promote_device(self) -> int:
        return self.store.attach()

    def stats(self) -> dict:
        return {
            "type": "flat",
            "count": self.count(),
            "capacity": self.capacity,
            "metric": self.metric,
            "device_resident": self.store.device_resident,
        }


def _pad_mask(mask: np.ndarray, capacity: int, device) -> torch.Tensor:
    mask = np.asarray(mask, bool)
    if mask.shape[0] < capacity:
        mask = np.pad(mask, (0, capacity - mask.shape[0]))
    return torch.from_numpy(np.ascontiguousarray(mask[:capacity])).to(device)
