"""Flat (brute-force) index (port of ``FlatIndex``, ``QuantizedFlatIndex``,
``make_flat`` and ``exact_rescore`` from ``weaviate_tpu/index/flat.py``).

The whole corpus lives in device memory and a query batch is one masked
product + top-k. For l2-squared at bf16 with approximate selection allowed
and k <= 64, the scan runs in the fused kernel (``ops/fused_flat.py``);
every other request takes ``ops/distance.py flat_search``. With a quantizer
(BQ, SQ, PQ or RQ) the device holds the code planes instead, a search is
one scan of them (kernels Q1-Q4, ``ops/quantized.py``) that over-fetches,
and the host rescores the candidates exactly against the originals.
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
    """Flat-index factory: raw corpus in device memory, or code planes +
    the host rescore tier when a quantizer is configured (reference
    ``flat/index.go:49`` + ``quantizer.go``). The disk raw tiers raise
    (slice 9)."""
    config = config or FlatIndexConfig()
    if config.quantizer is not None and config.quantizer.enabled:
        return QuantizedFlatIndex(dims, config, device=device)
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


def exact_rescore(
    queries: np.ndarray,
    cand_ids: np.ndarray,
    vectors,
    metric: str,
    k: int,
) -> SearchResult:
    """Re-rank approximate candidates with exact float32 distances on the
    host (JAX ``exact_rescore``, unchanged: its ``np.argpartition`` decides
    which of tied candidates survive at the k-th place, and BQ's integer
    distances tie often).

    Reference ``hnsw/search.go:184`` (shouldRescore): compressed search
    over-fetches, then the top candidates are re-scored against the original
    vectors. cand_ids: [B, k'] (-1 = empty); ``vectors`` a HostVectorStore.
    """
    cand_ids = np.asarray(cand_ids)
    b, kp = cand_ids.shape
    safe = np.clip(cand_ids, 0, None)
    cand = vectors.get(safe.reshape(-1)).reshape(b, kp, -1)  # [B, k', D]
    q = np.asarray(queries, np.float32)
    if metric == "l2-squared":
        diff = q[:, None, :] - cand
        d = np.einsum("bkd,bkd->bk", diff, diff)
    elif metric in ("dot", "cosine"):
        ip = np.einsum("bd,bkd->bk", q, cand)
        d = -ip if metric == "dot" else 1.0 - ip
    elif metric == "manhattan":
        d = np.abs(q[:, None, :] - cand).sum(axis=-1)
    else:  # hamming over raw floats (reference hamming.go float variant)
        d = (q[:, None, :] != cand).sum(axis=-1).astype(np.float32)
    d = np.where(cand_ids < 0, np.float32(MASK_DISTANCE), d.astype(np.float32))
    k = min(k, kp)
    part = np.argpartition(d, k - 1, axis=1)[:, :k]
    pd = np.take_along_axis(d, part, axis=1)
    order = np.argsort(pd, axis=1, kind="stable")
    sel = np.take_along_axis(part, order, axis=1)
    out_d = np.take_along_axis(d, sel, axis=1)
    out_i = np.take_along_axis(cand_ids, sel, axis=1)
    out_i = np.where(out_d >= MASK_DISTANCE, -1, out_i)
    return SearchResult(ids=out_i, dists=out_d)


class QuantizedFlatIndex(VectorIndex):
    """Flat index over device-resident code planes with host-side rescore.

    Reference ``flat/index.go`` with a quantizer (``flat/quantizer.go``): codes
    are device tensors and a search is one scan kernel
    (``ops/quantized.py``). Storage, fit policy, code search and the rescore
    tier all live in ``hnsw.backend.QuantizedBackend`` — this class is the
    VectorIndex adapter over it (the same backend the HNSW walk uses)."""

    def __init__(self, dims: int, config: FlatIndexConfig, device=None):
        from weaviate_tpu_torch.index.hnsw.backend import QuantizedBackend

        self.config = config
        self.metric = config.distance
        self.dims = dims
        self.backend = QuantizedBackend(dims, config, device=device)

    @property
    def quantizer(self):
        return self.backend.quantizer

    # -- VectorIndex ------------------------------------------------------
    def add_batch(self, doc_ids: np.ndarray, vectors: np.ndarray) -> None:
        self.backend.put(np.asarray(doc_ids, np.int64), vectors)

    def delete(self, doc_ids: np.ndarray) -> None:
        self.backend.delete(doc_ids)

    def search(
        self,
        queries: np.ndarray,
        k: int,
        allow_list: Optional[np.ndarray] = None,
        est_selectivity: Optional[float] = None,
    ) -> SearchResult:
        queries = np.atleast_2d(np.asarray(queries, np.float32))
        if queries.shape[-1] != self.dims:
            raise ValueError(
                f"query dims {queries.shape[-1]} != index dims {self.dims}"
            )
        d, ids = run_tier_stable(
            lambda: self.backend.flat_topk(queries, k, allow_list))
        return SearchResult(ids=ids, dists=d)

    def search_by_distance(
        self,
        queries: np.ndarray,
        max_distance: float,
        allow_list: Optional[np.ndarray] = None,
        limit: int = 1024,
    ) -> SearchResult:
        k = min(limit, max(1, self.count()))
        res = self.search(queries, k, allow_list)
        keep = res.dists <= max_distance
        return SearchResult(
            ids=np.where(keep, res.ids, -1),
            dists=np.where(keep, res.dists, np.float32(MASK_DISTANCE)),
        )

    def count(self) -> int:
        return self.backend.originals.live_count

    @property
    def capacity(self) -> int:
        return self.backend.capacity

    def contains(self, doc_id: int) -> bool:
        return self.backend.contains(doc_id)

    # -- tiered residency ---------------------------------------------------
    @property
    def device_resident(self) -> bool:
        return self.backend.device_resident

    def hbm_bytes(self) -> int:
        return self.backend.hbm_bytes()

    def host_tier_bytes(self) -> int:
        return self.backend.host_tier_bytes()

    def demote_device(self) -> int:
        return self.backend.demote_device()

    def promote_device(self) -> int:
        return self.backend.promote_device()

    def stats(self) -> dict:
        return {
            "type": "flat",
            "quantizer": self.quantizer.kind,
            "fitted": self.quantizer.fitted,
            "count": self.count(),
            "capacity": self.capacity,
            "metric": self.metric,
            "device_resident": self.backend.device_resident,
        }
