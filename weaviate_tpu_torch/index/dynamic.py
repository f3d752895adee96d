"""Dynamic index: flat until a size threshold, then upgrade to HNSW (port
of ``weaviate_tpu/index/dynamic.py``; both indexes live on the device the
dynamic index was built for).

Reference: ``adapters/repos/db/vector/dynamic/index.go`` (bbolt-tracked
upgrade). On an accelerator the flat index stays competitive far longer than on
a CPU (the scan is one matrix product); the upgrade builds the graph from
the flat store's device-resident vectors without moving them.

Background cutover (docs/ingest.md): by default the flat→HNSW upgrade is
a BACKGROUND build — the write that crosses the threshold returns
immediately and searches keep serving from flat while ``index_existing``
builds the graph off-thread over a snapshot of the shared device store.
The cutover then catches up (a second ``index_existing`` pass picks up
exactly the ids added during the build — vectors at a doc id are
immutable, updates mint new ids) and swaps the inner index atomically
under a brief writer quiesce. No write ever pays the graph-build tax.

State machine: ``idle → building → done`` (or ``→ failed``, which keeps
serving from flat — correctness is never at stake, only the crossover
to sub-linear search — and retries at the first threshold crossing
after a backoff window). A crash mid-build costs only the partial graph:
the store is rebuilt from the durable object log on boot and the next
threshold crossing restarts the build (HNSW construction is idempotent —
``add_batch``/``index_existing`` skip ids already in the graph).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Optional

import numpy as np

from weaviate_tpu_torch.index.base import SearchResult, VectorIndex
from weaviate_tpu_torch.index.flat import FlatIndex
from weaviate_tpu_torch.index.hnsw import HNSWIndex
from weaviate_tpu_torch.schema.config import (
    DynamicIndexConfig,
    FlatIndexConfig,
    HNSWIndexConfig,
)

logger = logging.getLogger("weaviate_tpu_torch.dynamic")

# seconds a FAILED background cutover waits before the next threshold
# crossing may retry the build: long enough that a persistent cause
# (bad config, corrupted store) doesn't hot-loop seconds-long builds,
# short enough that a transient one (tier demotion mid-build, memory
# pressure) doesn't latch linear-scan serving until process restart
CUTOVER_RETRY_BACKOFF_S = 60.0


class DynamicIndex(VectorIndex):
    def __init__(
        self,
        dims: int,
        config: Optional[DynamicIndexConfig] = None,
        path: Optional[str] = None,
        device=None,
    ):
        self.config = config or DynamicIndexConfig()
        self.dims = dims
        self.path = path
        base = self.config.to_dict()
        for key in ("index_type", "threshold", "hnsw", "flat",
                    "cutover_background"):
            base.pop(key, None)
        base.pop("quantizer", None)
        flat_overrides = self.config.flat or {}
        self._flat_cfg = FlatIndexConfig(**{**base, **flat_overrides})
        hnsw_overrides = self.config.hnsw or {}
        self._hnsw_cfg = HNSWIndexConfig(**{**base, **hnsw_overrides})
        self._inner: VectorIndex = FlatIndex(dims, self._flat_cfg, device=device)
        self._upgraded = False
        # background cutover machinery. _swap_lock brackets every inner
        # MUTATION (one store put / delete — fast) so the build thread's
        # catch-up + swap phase can quiesce writers briefly; searches
        # read self._inner without it (attribute swap is atomic).
        self._swap_lock = threading.Lock()
        self._cutover_state = "idle"  # idle|building|done|failed
        self._cutover_failed_at = 0.0  # monotonic; gates the retry backoff
        self._cutover_thread: Optional[threading.Thread] = None
        # ids deleted while the build is in flight: the build thread may have
        # already graph-inserted them, so the swap re-applies the delete
        # to the new graph (the store itself saw it immediately)
        self._pending_deletes: list[int] = []

    @property
    def inner(self) -> VectorIndex:
        return self._inner

    @property
    def upgraded(self) -> bool:
        return self._upgraded

    @property
    def cutover_state(self) -> str:
        return self._cutover_state

    def _maybe_upgrade(self) -> None:
        if self._upgraded or self._inner.count() < self.config.threshold:
            return
        if not getattr(self.config, "cutover_background", True):
            self._upgrade_sync()
            return
        self._start_cutover()

    def _upgrade_sync(self) -> None:
        """Legacy synchronous upgrade (cutover_background=False): the
        write that crosses the threshold blocks until the graph exists."""
        from weaviate_tpu_torch.index.dispatch import dispatch_group

        with dispatch_group(("ingest",)), self._swap_lock:
            if self._upgraded:
                return
            flat: FlatIndex = self._inner  # type: ignore[assignment]
            # hand over the device store wholesale; rebuild only the
            # graph — vectors never leave device memory
            hnsw = HNSWIndex(self.dims, self._hnsw_cfg, path=self.path,
                             store=flat.store)
            hnsw.index_existing()
            self._inner = hnsw
            self._upgraded = True
            self._cutover_state = "done"

    def _start_cutover(self) -> None:
        with self._swap_lock:
            if self._upgraded:
                return
            if self._cutover_state == "failed":
                # a failed build must not latch linear-scan serving
                # forever: transient causes (tier demotion mid-build,
                # OOM pressure) clear. Back off, then let the next
                # threshold crossing retry; a persistent cause fails
                # again at most once per backoff window.
                if (time.monotonic() - self._cutover_failed_at
                        < CUTOVER_RETRY_BACKOFF_S):
                    return
            elif self._cutover_state != "idle":
                return
            self._cutover_state = "building"
            self._pending_deletes = []
        t = threading.Thread(target=self._build_cutover, daemon=True,
                             name="dynamic-cutover")
        self._cutover_thread = t
        t.start()

    def _build_cutover(self) -> None:
        from weaviate_tpu_torch.monitoring import tracing
        from weaviate_tpu_torch.monitoring.metrics import INDEX_CUTOVER_SECONDS

        from weaviate_tpu_torch.index.dispatch import dispatch_group

        t0 = time.perf_counter()
        outcome = "failed"
        try:
            # the construction beam is ingest work: under the ingest
            # batch-group token its dispatcher-mediated searches coalesce
            # with other builds, never with a live serving batch
            with dispatch_group(("ingest",)), tracing.TRACER.span(
                    "index.cutover", threshold=self.config.threshold,
                    count=self._inner.count()) as span:
                flat: FlatIndex = self._inner  # type: ignore[assignment]
                hnsw = HNSWIndex(self.dims, self._hnsw_cfg, path=self.path,
                                 store=flat.store)
                # phase 1: bulk build, NO lock — writers keep feeding
                # flat (shared store), searches keep serving from flat.
                # Rows frozen at snapshot time are immutable (doc ids
                # are never rewritten in place), so the lock-free walk
                # reads stable vectors.
                hnsw.index_existing()
                # phase 2: brief writer quiesce — replay the delta (ids
                # that landed during phase 1; index_existing inserts
                # exactly the live store ids the graph lacks), re-apply
                # in-flight deletes, then swap atomically.
                with self._swap_lock:
                    hnsw.index_existing()
                    if self._pending_deletes:
                        hnsw.delete(np.asarray(
                            sorted(set(self._pending_deletes)), np.int64))
                        self._pending_deletes = []
                    self._inner = hnsw
                    self._upgraded = True
                    self._cutover_state = "done"
                outcome = "completed"
                span.set(nodes=hnsw.count(), outcome=outcome)
        except Exception:
            # flat keeps serving (correctness is never at stake — only
            # the crossover to sub-linear search); the operator sees the
            # outcome label + this log line, and the next threshold
            # crossing after the backoff retries the build
            with self._swap_lock:
                self._cutover_state = "failed"
                self._cutover_failed_at = time.monotonic()
            logger.exception("background flat->HNSW cutover failed; "
                             "flat index keeps serving until the next "
                             "post-backoff threshold crossing retries")
        finally:
            INDEX_CUTOVER_SECONDS.observe(
                time.perf_counter() - t0, outcome=outcome)

    def wait_cutover(self, timeout: Optional[float] = None) -> bool:
        """Block until an in-flight background cutover finishes (tests +
        explicit maintenance); returns whether the index is upgraded."""
        t = self._cutover_thread
        if t is not None:
            t.join(timeout)
        return self._upgraded

    # -- VectorIndex ------------------------------------------------------
    def add_batch(self, doc_ids: np.ndarray, vectors: np.ndarray) -> None:
        with self._swap_lock:
            self._inner.add_batch(doc_ids, vectors)
        self._maybe_upgrade()

    def delete(self, doc_ids: np.ndarray) -> None:
        with self._swap_lock:
            self._inner.delete(doc_ids)
            if self._cutover_state == "building":
                self._pending_deletes.extend(
                    int(d) for d in np.asarray(doc_ids).ravel())

    @property
    def supports_filter_planes(self) -> bool:
        return getattr(self._inner, "supports_filter_planes", False)

    def search(self, queries, k, allow_list=None,
               est_selectivity=None) -> SearchResult:
        return self._inner.search(queries, k, allow_list,
                                  est_selectivity=est_selectivity)

    def search_by_distance(self, queries, max_distance, allow_list=None, limit=1024):
        return self._inner.search_by_distance(queries, max_distance, allow_list, limit)

    def count(self) -> int:
        return self._inner.count()

    @property
    def capacity(self) -> int:
        return self._inner.capacity

    def contains(self, doc_id: int) -> bool:
        return self._inner.contains(doc_id)

    def flush(self) -> None:
        self._inner.flush()

    def close(self) -> None:
        # a close racing an in-flight build: let the build thread finish its
        # swap (bounded by the catch-up pass) rather than tear the store
        # out from under it; the thread is daemonic, so a wedged build
        # never blocks interpreter exit past the timeout
        t = self._cutover_thread
        if t is not None and t.is_alive():
            t.join(timeout=30.0)
        if hasattr(self._inner, "close"):
            self._inner.close()

    def save_vectors(self, path: str, meta=None) -> bool:
        return self._inner.save_vectors(path, meta)

    def load_vectors(self, path: str):
        meta = self._inner.load_vectors(path)
        if meta is not None:
            # a restored corpus may already be over the upgrade threshold
            self._maybe_upgrade()
        return meta

    # -- tiered residency (docs/tiering.md): pure delegation — without it
    # the base-class no-ops would hide the inner index's real device rent
    # from the budget ledger and turn demotion into a silent no-op
    @property
    def device_resident(self) -> bool:
        return self._inner.device_resident

    def hbm_bytes(self) -> int:
        return self._inner.hbm_bytes()

    def host_tier_bytes(self) -> int:
        return self._inner.host_tier_bytes()

    def demote_device(self) -> int:
        return self._inner.demote_device()

    def promote_device(self) -> int:
        return self._inner.promote_device()

    def stats(self) -> dict:
        s = self._inner.stats()
        s["type"] = f"dynamic[{s['type']}]"
        s["upgraded"] = self._upgraded
        s["cutover_state"] = self._cutover_state
        return s
