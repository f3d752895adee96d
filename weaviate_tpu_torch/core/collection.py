"""Collection: per-class index owning shards, with scatter-gather search.

Reference: ``adapters/repos/db/index.go:219`` (Index) — owns a shard map,
routes writes by UUID hash (``usecases/sharding/state.go``) or tenant name,
fans searches out per shard and merges (``index.go:1928 objectVectorSearch``,
``search_deduplication.go``).

Port of ``weaviate_tpu/core/collection.py``: the write path, the
near-vector, keyword and hybrid read paths and aggregation, with the same
routing, scatter-gather and stable merge. The collection's shards live on
the device it was opened with (``device=``, ``cuda`` unless the caller
names another). Multi-target search, vectorizer modules and the frozen
tenant tier are not ported yet: each raises ``NotImplementedError``
naming its ROADMAP queue-A slice.
"""

from __future__ import annotations

import json
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as FuturesTimeout
from contextlib import contextmanager
from typing import Any, Optional

import numpy as np

from weaviate_tpu_torch.core.shard import DEFAULT_VECTOR, Shard
from weaviate_tpu_torch.index.base import SearchResult
from weaviate_tpu_torch.index.store import resolve_device
from weaviate_tpu_torch.inverted.filters import Filter
from weaviate_tpu_torch.schema.config import CollectionConfig
from weaviate_tpu_torch.storage.objects import StorageObject
from weaviate_tpu_torch.utils.hashing import shard_for_uuid

TENANT_HOT = "HOT"
TENANT_COLD = "COLD"
TENANT_FROZEN = "FROZEN"


class TenantNotActive(RuntimeError):
    """Request addressed a COLD/FROZEN (or mid-transition) tenant — a
    client error (HTTP 422 / gRPC FAILED_PRECONDITION), not a server
    fault (reference tenant-activity validation)."""


class Collection:
    def __init__(self, dirpath: str, config: CollectionConfig, sync_writes: bool = False,
                 modules=None, db=None, device=None):
        self.dir = dirpath
        self.device = resolve_device(device)
        self.config = config
        self.sync_writes = sync_writes
        self.modules = modules
        self.db = db  # back-ref for cross-collection ops (ref-filters)
        os.makedirs(dirpath, exist_ok=True)
        self._lock = threading.RLock()
        self._ref_lock = threading.Lock()  # reference read-modify-writes
        self._get_seq = 0  # strictly-increasing shard access stamp
        self._shards: dict[str, Shard] = {}
        self._building: dict[str, threading.Event] = {}  # in-flight opens
        # shard names mid-drop (replica movement): a concurrent
        # _get_shard must not rebuild the shard while rmtree runs — the
        # rebuilt object would register with a deleted directory and
        # explode on its first flush
        self._dropping: set[str] = set()
        self._tenant_status: dict[str, str] = {}
        # per-shard serving status (reference /schema/{class}/shards:
        # READY | READONLY); only non-READY entries are persisted
        self._shard_status: dict[str, str] = {}
        self._shard_status_path = os.path.join(dirpath, "shard_status.json")
        try:
            with open(self._shard_status_path) as f:
                self._shard_status = json.load(f)
        except (OSError, ValueError):
            pass
        self._maintenance_pause = 0  # backup copy windows (counter)
        self._pool = ThreadPoolExecutor(max_workers=8)
        if not config.multi_tenancy.enabled:
            for i in range(max(1, config.sharding.desired_count)):
                self._get_shard(f"shard{i}")
        else:
            # persisted statuses first (a FROZEN tenant's files live in the
            # offload tier, not here — a dir scan alone would orphan them)
            self._load_tenant_status()
            for d in sorted(os.listdir(dirpath)):
                if os.path.isdir(os.path.join(dirpath, d)) and d.startswith("tenant-"):
                    name = d[len("tenant-"):]
                    self._tenant_status.setdefault(name, TENANT_HOT)
            # tenant shards load LAZILY on first use (reference
            # shard_lazyloader.go): a collection with 10k tenants must not
            # open 10k shards at boot; _get_shard's load limiter bounds
            # concurrent opens when traffic fans in

    def _tenant_status_path(self) -> str:
        return os.path.join(self.dir, "tenants.json")

    # transfers are transient: crash/persist mid-flight must resolve to the
    # state whose DATA is intact (FREEZING keeps local files until the
    # FROZEN persist; UNFREEZING keeps the bucket copy until HOT persists)
    _TRANSIENT_STATUS = {"FREEZING": TENANT_HOT, "UNFREEZING": TENANT_FROZEN}

    def _load_tenant_status(self) -> None:
        import json

        path = self._tenant_status_path()
        if os.path.exists(path):
            try:
                with open(path) as f:
                    self._tenant_status = {
                        n: self._TRANSIENT_STATUS.get(s, s)
                        for n, s in dict(json.load(f)).items()}
            except (OSError, ValueError):
                self._tenant_status = {}

    def _persist_tenant_status(self) -> None:
        import json

        tmp = self._tenant_status_path() + ".tmp"
        with open(tmp, "w") as f:
            # never write a transient transfer state: a crash would wedge
            # the tenant (set_tenant_status rejects transitions out of it)
            json.dump({n: self._TRANSIENT_STATUS.get(s, s)
                       for n, s in self._tenant_status.items()}, f)
        os.replace(tmp, self._tenant_status_path())

    # -- shard management -------------------------------------------------
    # bound concurrent shard OPENS process-wide (reference
    # shard_load_limiter.go — deliberately a CLASS attribute: recovery
    # re-tokenizes/replays and a fan-in of cold tenants across all
    # collections must not open unbounded shards at once)
    _LOAD_LIMITER = threading.Semaphore(8)

    def _get_shard(self, name: str) -> Shard:
        # the collection lock guards only dict state — the (slow) Shard
        # construction runs OUTSIDE it, behind the load limiter, so one
        # collection's recovery storm cannot stall others' reads/writes
        while True:
            with self._lock:
                s = self._shards.get(name)
                if s is not None:
                    # access stamp (under the lock) — the maintenance
                    # eviction uses it to prove nobody else acquired the
                    # shard since the sweep opened it
                    self._get_seq += 1
                    s._last_get = self._get_seq
                    return s
                ev = self._building.get(name)
                if ev is None:
                    ev = threading.Event()
                    self._building[name] = ev
                    builder = True
                else:
                    builder = False
            if not builder:
                # graftlint: allow[blocking-call-without-deadline] reason=local builder event, set in the builder's finally on every exit path; bounding it would duplicate an in-flight build
                ev.wait()
                continue  # re-check: the builder published (or failed)
            try:
                # re-validate AFTER claiming the build slot: the caller's
                # status check was unlocked, and a freeze/remove that
                # completed in between moved or deleted the directory —
                # building now would resurrect an empty zombie shard
                if name.startswith("tenant-"):
                    tname = name[len("tenant-"):]
                    with self._lock:
                        status = self._tenant_status.get(tname)
                    if status != TENANT_HOT:
                        raise TenantNotActive(
                            f"tenant {tname!r} is not active")
                with self._lock:
                    dropping = name in self._dropping
                if dropping:
                    # a drop (replica moved away) is deleting this
                    # shard's directory right now: rebuilding would
                    # resurrect a zombie whose files vanish under it
                    from weaviate_tpu_torch.storage.store import ShardClosed

                    raise ShardClosed(
                        f"shard {name!r} is being dropped")
                with self._LOAD_LIMITER:
                    s = Shard(
                        os.path.join(self.dir, name),
                        self.config,
                        name=name,
                        sync_writes=self.sync_writes,
                        device=self.device,
                    )
                # cross-collection ref-filter hook (reference
                # inverted/searcher.go ref-filter recursion)
                s.inverted.ref_resolver = self._resolve_ref_filter
                with self._lock:
                    # re-check: a drop may have started while this
                    # builder was constructing (it waits only for
                    # builders it could SEE when it began)
                    publish = name not in self._dropping
                    if publish:
                        # a shard born inside a backup copy window
                        # inherits the pause, otherwise its compaction
                        # could delete files the backup walk already
                        # listed
                        for _ in range(self._maintenance_pause):
                            s.store.pause_maintenance()
                        self._get_seq += 1
                        s._last_get = self._get_seq
                        self._shards[name] = s
                if not publish:
                    import logging
                    import shutil

                    try:
                        s.close()
                    except OSError as e:
                        # the racing rmtree may already have taken the
                        # directory out from under the close's flush
                        logging.getLogger("weaviate_tpu_torch.core").info(
                            "discarding shard %s built during drop: %s",
                            name, e)
                    shutil.rmtree(s.dir, ignore_errors=True)
                    from weaviate_tpu_torch.storage.store import ShardClosed

                    raise ShardClosed(
                        f"shard {name!r} is being dropped")
                if name.startswith("tenant-"):
                    # tiering ledger: a freshly opened tenant shard starts
                    # renting HBM — charge it (outside the collection
                    # lock; the hook takes the controller + shard locks)
                    t = self._tiering()
                    if t is not None:
                        t.note_shard_open(self, name[len("tenant-"):], s)
                return s
            finally:
                with self._lock:
                    self._building.pop(name, None)
                ev.set()

    def _all_shard_names(self) -> list[str]:
        """Every shard this collection OWNS (not just the lazily opened
        ones) — maintenance (reindex/compact/backup walks) must cover
        unopened tenants too."""
        if self.config.multi_tenancy.enabled:
            with self._lock:
                return [f"tenant-{n}"
                        for n, s in self._tenant_status.items()
                        if s == TENANT_HOT]
        return [f"shard{i}"
                for i in range(max(1, self.config.sharding.desired_count))]

    def _resolve_ref_filter(self, inv, flt, space: int):
        """Leaf with path [refProp, TargetClass, ...rest]: evaluate the
        tail on the target collection, then mask source docs whose beacons
        point at an allowed target (reference ref-filter join)."""
        import numpy as np

        from weaviate_tpu_torch.inverted.filters import Filter

        ref_prop, target_cls = flt.path[0], flt.path[1]
        if self.db is None:
            raise ValueError("ref filters need a DB-attached collection")
        target = self.db.get_collection(target_cls)
        inner = Filter(operator=flt.operator, path=list(flt.path[2:]),
                       value=flt.value, operands=flt.operands)
        allowed_uuids: set[str] = set()
        for shard in target._search_shards():
            mask = shard.allow_list(inner)
            for docid in np.nonzero(mask)[0]:
                o = shard.get_by_docid(int(docid))
                if o is not None:
                    allowed_uuids.add(o.uuid)
        out = np.zeros(space, bool)
        vals = inv.values.get(ref_prop, {})
        for docid, v in vals.items():
            if docid >= space:
                continue
            beacons = v if isinstance(v, list) else [v]
            for b in beacons:
                u = (b.get("beacon", "").rsplit("/", 1)[-1]
                     if isinstance(b, dict) else str(b))
                if u in allowed_uuids:
                    out[docid] = True
                    break
        return out

    def _tiering(self):
        """The DB's tiering controller, when one governs this collection
        (multi-tenant only — single-tenant corpora are the node's working
        set, not candidates for eviction)."""
        t = getattr(self.db, "tiering", None) if self.db is not None else None
        if t is None or not self.config.multi_tenancy.enabled:
            return None
        return t

    def _shard_for_uuid(self, uuid: str) -> Shard:
        n = max(1, self.config.sharding.desired_count)
        return self._get_shard(f"shard{shard_for_uuid(uuid, n)}")

    def _route(self, uuid: str, tenant: str = "",
               write: bool = False) -> Shard:
        if self.config.multi_tenancy.enabled:
            if not tenant:
                raise ValueError(
                    f"collection {self.config.name!r} is multi-tenant: tenant required"
                )
            if tenant not in self._tenant_status:
                if self.config.multi_tenancy.auto_tenant_creation:
                    self.add_tenant(tenant)
                else:
                    raise KeyError(f"tenant {tenant!r} not found")
            if self._tenant_status[tenant] != TENANT_HOT:
                if self.config.multi_tenancy.auto_tenant_activation:
                    # full activation path: a FROZEN tenant's files must
                    # onload from the offload tier before the shard opens
                    self.set_tenant_status(tenant, TENANT_HOT)
                else:
                    raise TenantNotActive(
                        f"tenant {tenant!r} is not active")
            t = self._tiering()
            if t is not None:
                # ONE activity event per operation (batched callers
                # resolve the shard once; the ensure_hot gate carries
                # the event weight itself) — per-object or double bumps
                # would let a single ingest batch outweigh thousands of
                # queries in the EWMA
                t.ensure_hot(self, tenant,
                             weight=2.0 if write else 1.0)
                tenant_shard = self._get_shard(f"tenant-{tenant}")
                if write and not tenant_shard.device_resident():
                    # demoted stores reject mutations: writers promote
                    # first (reads stay on the warm host tier), through
                    # the controller so the attach respects the budget
                    # ledger and make-room, never a bare re-rent
                    t.promote_for_write(
                        (self.config.name, tenant), tenant_shard)
                return tenant_shard
            return self._get_shard(f"tenant-{tenant}")
        return self._shard_for_uuid(uuid)

    def _search_shards(self, tenant: str = "") -> list[Shard]:
        if self.config.multi_tenancy.enabled:
            if not tenant:
                raise ValueError("tenant required for multi-tenant search")
            if tenant not in self._tenant_status:
                raise KeyError(f"tenant {tenant!r} not found")
            if self._tenant_status[tenant] != TENANT_HOT:
                raise TenantNotActive(f"tenant {tenant!r} is not active")
            t = self._tiering()
            if t is not None:
                # activity signal + cold-start gate: a COLD tenant's first
                # query blocks on the async promotion under the request's
                # serving Deadline (503 + Retry-After past it); warm
                # tenants serve immediately from the host tier
                t.ensure_hot(self, tenant)
            return [self._get_shard(f"tenant-{tenant}")]
        return [self._get_shard(f"shard{i}")
                for i in range(max(1, self.config.sharding.desired_count))]

    # -- tenants ----------------------------------------------------------
    def add_tenant(self, name: str, status: str = TENANT_HOT) -> None:
        with self._lock:
            self._tenant_status.setdefault(name, status)
            self._persist_tenant_status()

    def _wait_building(self, shard_name: str) -> None:
        """Block until no _get_shard build is in flight for the name —
        deleting concurrently would let the builder republish a zombie
        shard over the removed directory."""
        while True:
            with self._lock:
                ev = self._building.get(shard_name)
            if ev is None:
                return
            # graftlint: allow[blocking-call-without-deadline] reason=local builder event, set in the builder's finally on every exit path; returning early would let the builder republish a zombie shard
            ev.wait()

    def release_tenant(self, name: str) -> bool:
        """COLD demotion (tiering/): close the tenant's shard — state
        flushes + checkpoints to disk through the normal storage paths —
        WITHOUT changing its logical HOT status, so the next access
        lazily reopens it (the promotion path). Returns False when the
        tenant is not open or was re-acquired since the controller's
        decision (the ``_last_get`` stamp proves no racing getter)."""
        shard_name = f"tenant-{name}"
        with self._lock:
            s = self._shards.get(shard_name)
            if s is None:
                return False
            stamp = s._last_get
        # durability FIRST, outside the lock: flush + checkpoint while the
        # shard is still published, so a getter that lands mid-release and
        # rebuilds from disk sees every write. Only then re-verify the
        # stamp under the lock (same proof _maintenance_shards uses) — a
        # tenant that got traffic during the flush stays open — and pop;
        # the trailing close() re-runs flush/checkpoint as cheap no-ops.
        s.flush()
        s.checkpoint()
        with self._lock:
            s2 = self._shards.get(shard_name)
            if s2 is None or s2._last_get != stamp:
                return False
            self._shards.pop(shard_name)
        # under the shard lock: waits out any writer already inside a
        # mutation, then flags the instance so a writer that routed to
        # it BEFORE the pop re-routes (ResidencyMoved -> re-resolve)
        # instead of mutating a closed store
        with s._lock:
            s._tier_released = True
        s.close()
        return True

    def remove_tenant(self, name: str) -> None:
        import shutil

        self._wait_building(f"tenant-{name}")
        t = self._tiering()
        if t is not None:
            t.forget(self.config.name, name)
        with self._lock:
            if self._tenant_status.get(name) in ("FREEZING", "UNFREEZING"):
                # a racing transfer would resurrect the tenant on its
                # commit/rollback; the caller retries after it settles
                raise ValueError(
                    f"tenant {name!r} has a transfer in flight")
            self._tenant_status.pop(name, None)
            self._persist_tenant_status()
            s = self._shards.pop(f"tenant-{name}", None)
        if s is not None:
            # close OUTSIDE the lock: flush+checkpoint can take seconds
            # and must not stall every other tenant's _get_shard
            s.close()
        # data retention: BOTH tiers go — a lingering frozen copy could
        # resurrect deleted data under a recreated tenant name (and an
        # unopened tenant's directories must be removed too)
        shutil.rmtree(os.path.join(self.dir, f"tenant-{name}"),
                      ignore_errors=True)
        shutil.rmtree(os.path.join(self._offload_root(), name),
                      ignore_errors=True)

    def apply_config_update(self, new_cfg: CollectionConfig) -> None:
        """Swap in a live-mutable config (reference
        ``hnsw/config_update.go`` + migrator UpdateInvertedIndexConfig).
        Traversal knobs (ef, dynamic ef, cutoff) take effect on the next
        query; BM25 k1/b on the next scoring call."""
        with self._lock:
            self.config = new_cfg
            shards = list(self._shards.values())
        for s in shards:
            s.config = new_cfg
            s.inverted.config = new_cfg
            s.inverted.k1 = new_cfg.inverted_config.bm25_k1
            s.inverted.b = new_cfg.inverted_config.bm25_b
            # the native WAND engine carries its own k1/b, and the
            # stopword set was frozen at init — both must follow
            if s.inverted.native is not None:
                s.inverted.native.set_params(
                    new_cfg.inverted_config.bm25_k1,
                    new_cfg.inverted_config.bm25_b)
            from weaviate_tpu_torch.inverted.analyzer import stopword_set

            s.inverted.stopwords = stopword_set(
                new_cfg.inverted_config.stopwords_preset)
            for tgt, idx in s._vector_indexes.items():
                vic = (new_cfg.named_vectors.get(tgt)
                       if tgt else new_cfg.vector_config)
                if vic is None:
                    continue
                if hasattr(idx, "config"):
                    idx.config = vic
                inner = getattr(idx, "_inner", None)
                if inner is not None and hasattr(inner, "config"):
                    inner.config = vic

    @contextmanager
    def _maintenance_shards(self):
        """Yield every OWNED shard, then evict the ones this pass had to
        open — a maintenance sweep over 10k lazy tenants must not leave
        them all resident (that would undo lazy loading and trip the
        memwatch gate). Eviction is proven safe via the _last_get stamp:
        a shard is closed only if NO other caller acquired it after the
        sweep's own open (the stamp is written under the collection lock,
        so the check-and-pop under the same lock cannot race a getter)."""
        with self._lock:
            before = set(self._shards)
        names = self._all_shard_names()
        opened_at: dict[str, int] = {}
        shards = []
        for n in names:
            s = self._get_shard(n)
            if n not in before:
                opened_at[n] = s._last_get
            shards.append(s)
        try:
            yield shards
        finally:
            for n, stamp in opened_at.items():
                with self._lock:
                    s = self._shards.get(n)
                    if s is None or s._last_get != stamp:
                        continue  # someone else is using it: stays open
                    self._shards.pop(n)
                s.close()

    def reindex_inverted(self) -> int:
        """Rebuild every owned shard's inverted index (reference
        ``inverted_reindexer.go`` per-index run). Enumerates from tenant
        status, not the open-shard dict — with lazy loading an unopened
        tenant would otherwise be silently skipped."""
        with self._maintenance_shards() as shards:
            return sum(s.reindex_inverted() for s in shards)

    def drop_shard(self, name: str) -> None:
        """Close and delete one shard's data (replica movement: the source
        copy after a routing flip, reference ``copier/`` drop phase).
        ``_dropping`` gates the whole close+rmtree window: a late write
        (e.g. a 2PC commit racing the routing flip) must get ShardClosed
        from ``_get_shard``, not silently rebuild the shard it is
        deleting."""
        import shutil

        # gate FIRST, then wait: a builder that registered before the
        # gate either publishes before the pop below (we drop it) or
        # fails its publish re-check (it sees _dropping). Waiting first
        # would leave a window where a fresh builder passes both checks
        # while this drop runs, republishing the shard being deleted.
        with self._lock:
            self._dropping.add(name)
        try:
            self._wait_building(name)
            with self._lock:
                s = self._shards.pop(name, None)
            if s is not None:
                s.close()
            # the directory goes regardless of whether the shard was
            # open: a lazily-closed (tiering-cold) shard's files must
            # not survive the drop and resurrect on the next open
            shutil.rmtree(os.path.join(self.dir, name),
                          ignore_errors=True)
        finally:
            with self._lock:
                self._dropping.discard(name)

    def tenants(self) -> dict[str, str]:
        # external views (API, backup manifests, FSM snapshots) see the
        # durable equivalent of in-flight transfers, never the transient
        return {n: self._TRANSIENT_STATUS.get(s, s)
                for n, s in self._tenant_status.items()}

    def _offload_root(self) -> str:
        """Frozen-tier storage root (reference offload-s3 module; a cold
        filesystem tier here — the bucket abstraction is a directory)."""
        root = os.environ.get(
            "OFFLOAD_FS_PATH", os.path.join(os.path.dirname(self.dir),
                                            "_offload"))
        return os.path.join(root, self.config.name)

    def set_tenant_status(self, name: str, status: str) -> None:
        """HOT <-> COLD: flip the status first (under the lock) so new
        ``_get_shard`` builders fail their re-check, then drain any
        in-flight build and close the shard. Moves to and from FROZEN
        need the offload tier, which is not ported yet."""
        if status not in (TENANT_HOT, TENANT_COLD, TENANT_FROZEN):
            raise ValueError(f"invalid tenant status {status!r}")
        shard_name = f"tenant-{name}"
        with self._lock:
            if name not in self._tenant_status:
                raise KeyError(f"tenant {name!r} not found")
            prev = self._tenant_status[name]
            if prev in ("FREEZING", "UNFREEZING"):
                raise ValueError(
                    f"tenant {name!r} has a transfer in flight")
            freezing = (status == TENANT_FROZEN and prev != TENANT_FROZEN)
            unfreezing = (prev == TENANT_FROZEN and status != TENANT_FROZEN)
            if freezing or unfreezing:
                raise NotImplementedError(
                    "FROZEN tenants (the offload tier, backup/offload.py): "
                    "not ported yet (ROADMAP queue A, slice 9)")
            # HOT<->COLD: no file movement, just open/close semantics.
            # Flip FIRST so in-flight lazy builders fail their re-check,
            # then drain + close outside the lock
            self._tenant_status[name] = status
            self._persist_tenant_status()
            cold = status != TENANT_HOT
        if cold:
            self._wait_building(shard_name)
            with self._lock:
                s = self._shards.pop(shard_name, None)
            if s is not None:
                s.close()

    # -- vectorization (module write-path hook) ---------------------------
    def _vectorize_missing(self, objs: list[StorageObject]) -> None:
        """Fill missing default vectors via the configured vectorizer
        module (reference ``usecases/modules/vectorizer.go``). The port
        holds no module registry yet, so a collection with a vectorizer
        refuses objects that need one."""
        name = self.config.vectorizer
        if name == "none" or all(o.vector is not None for o in objs):
            return
        raise NotImplementedError(
            f"vectorizer module {name!r}: not ported yet (ROADMAP queue A, "
            "slice 9)")

    # -- writes -----------------------------------------------------------
    def put_batch(self, objs: list[StorageObject], tenant: str = "") -> list[str]:
        from weaviate_tpu_torch.monitoring.metrics import BATCH_DURATION

        t0 = time.perf_counter()
        for o in objs:
            o.collection = self.config.name
            o.tenant = tenant
        self._vectorize_missing(objs)
        by_shard: dict[str, list[StorageObject]] = {}
        owners: dict[str, Shard] = {}
        if self.config.multi_tenancy.enabled:
            # every object of a tenant batch lands on the ONE tenant
            # shard: resolve it (and run the tiering write gate) once,
            # not per object
            shard = self._route("", tenant, write=True)
            owners[shard.name] = shard
            by_shard[shard.name] = list(objs)
        else:
            for o in objs:
                shard = self._route(o.uuid, tenant, write=True)
                owners[shard.name] = shard
                by_shard.setdefault(shard.name, []).append(o)
        self._reject_readonly(by_shard)
        # write through the resolved shard OBJECTS: a concurrent tiering
        # cold-release pops _shards entries, and a dict re-lookup here
        # would KeyError on a shard we already routed to
        for name, group in by_shard.items():
            self._write_tier_stable(
                name, owners[name],
                lambda s, g=group: s.put_batch(g))
        if tenant:
            # tiering ledger: the writes above may have grown the device
            # arrays — refresh the charge NOW so budget enforcement sees
            # the real footprint, not the pre-batch one (the 5s tick is
            # only a backstop)
            t = self._tiering()
            if t is not None:
                shard = self._shards.get(f"tenant-{tenant}")
                if shard is not None:
                    t.note_shard_open(self, tenant, shard)
        BATCH_DURATION.observe(time.perf_counter() - t0,
                               collection=self.config.name)
        return [o.uuid for o in objs]

    def put(self, obj: StorageObject, tenant: str = "") -> str:
        return self.put_batch([obj], tenant)[0]

    # -- shard status (reference /schema/{class}/shards) -------------------
    def shard_statuses(self) -> list[dict]:
        with self._lock:
            return [{"name": n,
                     "status": self._shard_status.get(n, "READY"),
                     "vectorQueueSize": (
                         s.async_queue.size()
                         if getattr(s, "async_queue", None) else 0)}
                    for n, s in sorted(self._shards.items())]

    def set_shard_status(self, name: str, status: str) -> str:
        status = status.upper()
        if status not in ("READY", "READONLY"):
            raise ValueError(f"invalid shard status {status!r} "
                             "(READY | READONLY)")
        with self._lock:
            if name not in self._shards:
                raise KeyError(f"shard {name!r} not found")
            if status == "READY":
                self._shard_status.pop(name, None)
            else:
                self._shard_status[name] = status
            tmp = self._shard_status_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(self._shard_status, f)
            os.replace(tmp, self._shard_status_path)
        return status

    def delete(self, uuids: list[str], tenant: str = "") -> int:
        by_shard: dict[str, list[str]] = {}
        owners: dict[str, Shard] = {}
        if self.config.multi_tenancy.enabled:
            shard = self._route("", tenant, write=True)
            owners[shard.name] = shard
            by_shard[shard.name] = list(uuids)
        else:
            for u in uuids:
                shard = self._route(u, tenant, write=True)
                owners[shard.name] = shard
                by_shard.setdefault(shard.name, []).append(u)
        self._reject_readonly(by_shard)
        return sum(
            self._write_tier_stable(
                name, owners[name],
                lambda s, g=group: s.delete(g))
            for name, group in by_shard.items()
        )

    def _write_tier_stable(self, shard_name: str, shard, fn):
        """Run a shard mutation ``fn(shard)``, retrying once when a
        tiering move lands between the route gate's residency check and
        the write (``ResidencyMoved``): re-resolve the shard (a cold
        release closes the routed instance — ``_get_shard`` re-opens it
        from the checkpoint the release flushed), promote back
        (budget-aware) and re-apply — a residency flip must re-route a
        write, never fail it."""
        from weaviate_tpu_torch.compression.store import ResidencyMoved

        try:
            return fn(shard)
        except ResidencyMoved:
            t = self._tiering()
            if t is None or not shard_name.startswith("tenant-"):
                raise
            shard = self._get_shard(shard_name)
            if not shard.device_resident():
                t.promote_for_write(
                    (self.config.name, shard_name[len("tenant-"):]), shard)
            return fn(shard)

    def _reject_readonly(self, shard_names) -> None:
        """Deletes are writes too: a READONLY shard rejects every
        mutation, checked before ANY shard is touched (atomic)."""
        ro = [n for n in shard_names
              if self._shard_status.get(n) == "READONLY"]
        if ro:
            raise ValueError(f"shards {ro} are READONLY")

    def _check_ref_prop(self, prop: str) -> None:
        p = self.config.property(prop)
        if p is None or p.data_type.value != "cref":
            # a typo'd prop name must not clobber scalar data with beacons
            raise ValueError(f"property {prop!r} is not a reference")

    def add_reference(self, uuid: str, prop: str, beacon: str,
                      tenant: str = "") -> None:
        """Append one cross-ref beacon to an object's reference property
        (reference ``batch_references_add.go`` / objects references API).
        Idempotent: an already-present beacon is not duplicated. The
        read-modify-write serializes per collection so concurrent adds
        cannot lose each other's beacons."""
        self._check_ref_prop(prop)
        with self._ref_lock:
            # graftlint: allow[blocking-under-lock] reason=ref RMW atomicity requires holding _ref_lock across get->put; a cold-tenant wait inside is bounded by the serving deadline
            obj = self.get(uuid, tenant=tenant)
            if obj is None:
                raise KeyError(f"object {uuid!r} not found")
            cur = obj.properties.get(prop)
            beacons = cur if isinstance(cur, list) else (
                [cur] if cur else [])
            if any((b.get("beacon") if isinstance(b, dict) else b) == beacon
                   for b in beacons):
                return
            beacons.append({"beacon": beacon})
            obj.properties[prop] = beacons
            # graftlint: allow[blocking-under-lock] reason=ref RMW atomicity requires holding _ref_lock across get->put; a cold-tenant wait inside is bounded by the serving deadline
            self.put(obj, tenant=tenant)

    def replace_references(self, uuid: str, prop: str, beacons: list[str],
                           tenant: str = "") -> None:
        self._check_ref_prop(prop)
        with self._ref_lock:
            # graftlint: allow[blocking-under-lock] reason=ref RMW atomicity requires holding _ref_lock across get->put; a cold-tenant wait inside is bounded by the serving deadline
            obj = self.get(uuid, tenant=tenant)
            if obj is None:
                raise KeyError(f"object {uuid!r} not found")
            obj.properties[prop] = [{"beacon": b} for b in beacons]
            # graftlint: allow[blocking-under-lock] reason=ref RMW atomicity requires holding _ref_lock across get->put; a cold-tenant wait inside is bounded by the serving deadline
            self.put(obj, tenant=tenant)

    def delete_reference(self, uuid: str, prop: str, beacon: str,
                         tenant: str = "") -> None:
        self._check_ref_prop(prop)
        with self._ref_lock:
            # graftlint: allow[blocking-under-lock] reason=ref RMW atomicity requires holding _ref_lock across get->put; a cold-tenant wait inside is bounded by the serving deadline
            obj = self.get(uuid, tenant=tenant)
            if obj is None:
                raise KeyError(f"object {uuid!r} not found")
            cur = obj.properties.get(prop)
            beacons = cur if isinstance(cur, list) else (
                [cur] if cur else [])
            obj.properties[prop] = [
                b for b in beacons
                if (b.get("beacon") if isinstance(b, dict) else b)
                != beacon]
            # graftlint: allow[blocking-under-lock] reason=ref RMW atomicity requires holding _ref_lock across get->put; a cold-tenant wait inside is bounded by the serving deadline
            self.put(obj, tenant=tenant)

    def delete_where(self, flt: Filter, tenant: str = "") -> int:
        """Batch delete by filter (reference ``batch_delete.go``)."""
        if self.config.multi_tenancy.enabled:
            # a delete is a write: run the tiering write gate like
            # delete/put_batch, so a warm (demoted) tenant promotes
            # before the mutation instead of failing with ResidencyMoved.
            # But with SEARCH-path tenant semantics first — a delete must
            # never auto-create or auto-activate a tenant as a side
            # effect (deleting from a typo'd name should 404, not mint
            # an empty shard or onload a frozen one)
            if not tenant:
                raise ValueError(
                    f"collection {self.config.name!r} is multi-tenant: "
                    "tenant required")
            if tenant not in self._tenant_status:
                raise KeyError(f"tenant {tenant!r} not found")
            if self._tenant_status[tenant] != TENANT_HOT:
                raise TenantNotActive(f"tenant {tenant!r} is not active")
            shards = [self._route("", tenant, write=True)]
        else:
            shards = self._search_shards(tenant)
        self._reject_readonly([s.name for s in shards])
        n = 0
        for shard in shards:
            def _one(shard):
                space = shard._next_doc_id
                mask = shard.allow_list(flt, space)
                doc_ids = np.nonzero(mask)[0]
                uuids = []
                for d in doc_ids:
                    obj = shard.get_by_docid(int(d))
                    if obj is not None:
                        uuids.append(obj.uuid)
                return shard.delete(uuids)

            n += self._write_tier_stable(shard.name, shard, _one)
        return n

    # -- reads ------------------------------------------------------------
    def get(self, uuid: str, tenant: str = "") -> Optional[StorageObject]:
        return self._route(uuid, tenant).get_by_uuid(uuid)

    def exists(self, uuid: str, tenant: str = "") -> bool:
        return self._route(uuid, tenant).exists(uuid)

    def validate_object(self, obj: StorageObject, tenant: str = "") -> None:
        """Write-path validation WITHOUT writing (reference
        /objects/validate): uuid shape, vector dims vs the live index,
        and property names/types against the schema."""
        import uuid as _uuid

        if obj.uuid:
            try:
                _uuid.UUID(obj.uuid)
            except ValueError:
                raise ValueError(f"invalid uuid {obj.uuid!r}")
        # dims come from any OPEN shard (index configs are uniform
        # across shards) — never via _route, whose auto-tenant paths
        # create/activate tenants, a mutation a validate must not do
        dims: dict[str, int] = {}
        with self._lock:
            for s in self._shards.values():
                if s._dims:
                    dims = s._dims
                    break
        vec_items = []
        if obj.vector is not None:
            vec_items.append((DEFAULT_VECTOR, obj.vector))
        vec_items.extend(obj.named_vectors.items())
        for nm, vec in vec_items:
            d = int(np.asarray(vec).shape[-1])
            want = dims.get(nm)
            if want is not None and d != want:
                raise ValueError(
                    f"vector {nm or 'default'!r} dims {d} != index "
                    f"dims {want}")
        from weaviate_tpu_torch.schema.auto_schema import infer_data_type
        from weaviate_tpu_torch.schema.config import DataType

        # widenings the write path accepts (int into a number column,
        # date/uuid strings into text)
        compatible = {
            (DataType.INT, DataType.NUMBER),
            (DataType.INT_ARRAY, DataType.NUMBER_ARRAY),
            (DataType.DATE, DataType.TEXT),
            (DataType.UUID, DataType.TEXT),
            (DataType.DATE_ARRAY, DataType.TEXT_ARRAY),
            (DataType.UUID_ARRAY, DataType.TEXT_ARRAY),
        }
        for pname, val in obj.properties.items():
            prop = self.config.property(pname)
            if prop is None:
                continue  # auto-schema would add it on write
            if val is None:
                continue
            inferred = infer_data_type(val)
            if inferred is None:
                continue
            declared = prop.data_type
            if inferred != declared \
                    and (inferred, declared) not in compatible:
                raise ValueError(
                    f"property {pname!r}: inferred type "
                    f"{inferred.value} does not match declared "
                    f"{declared.value}")

    def count(self, tenant: str = "") -> int:
        return sum(s.count() for s in self._search_shards(tenant))

    def count_where(self, flt: Filter, tenant: str = "") -> int:
        """Number of live objects matching a filter (dry-run counting uses
        the same masking as ``delete_where`` so the two can't drift)."""
        return sum(
            int(s.allow_list(flt).sum()) for s in self._search_shards(tenant)
        )

    def objects_page(self, limit: int = 25, offset: int = 0,
                     tenant: str = "",
                     after: Optional[str] = None) -> list[StorageObject]:
        """Page through objects. ``after`` is exhaustive-cursor
        pagination (reference ``filters.Cursor`` / REST ``?after=``):
        ``None`` = no cursor (plain doc-id-order stream); a string —
        including ``""`` for "from the start" — walks GLOBAL uuid order
        and resumes strictly past that uuid via a seek on the
        uuid->docid bucket, O(limit) not O(position). Iterating by uuid
        (not doc id) keeps the cursor position-stable under concurrent
        updates (an update keeps the uuid but bumps the doc id) and
        resumable past a deleted cursor object, and makes page 1
        (``after=""``) consistent with every later page."""
        from weaviate_tpu_torch.core.shard import _DOCID

        shards = self._search_shards(tenant)
        out: list[StorageObject] = []
        if after is None:
            # no cursor: stream the object store directly — the uuid
            # route below costs a point lookup per object, which a full
            # fetch (e.g. an unranked sort's limit=inf read) never needs
            for s in shards:
                for _, raw in s.objects.items():
                    out.append(StorageObject.from_bytes(raw))
                    if len(out) >= offset + limit:
                        return out[offset: offset + limit]
            return out[offset: offset + limit]

        import heapq

        # uuids are strings; the next key after `after` in byte order
        # ("" seeks to the very first uuid)
        start_key = after.encode() + b"\x00" if after else None

        def stream(s):
            for k, packed in s.ids.items(start=start_key):
                yield k, s, packed

        # global uuid order: shards hold hash-random uuid subsets, so a
        # per-shard cursor would skip the other shards' earlier uuids —
        # merge the (already uuid-sorted) shard streams instead
        merged = (stream(shards[0]) if len(shards) == 1 else
                  heapq.merge(*(stream(s) for s in shards),
                              key=lambda t: t[0]))
        for _, s, packed in merged:
            raw = s.objects.get(packed[: _DOCID.size])
            if raw is None:
                continue  # racing delete between the two buckets
            out.append(StorageObject.from_bytes(raw))
            if len(out) >= offset + limit:
                break
        return out[offset: offset + limit]

    # -- search -----------------------------------------------------------
    def vector_search(
        self,
        query: np.ndarray,
        k: int = 10,
        target: str = DEFAULT_VECTOR,
        flt: Optional[Filter] = None,
        tenant: str = "",
        max_distance: Optional[float] = None,
        deadline=None,
        rerank=None,
    ) -> list[tuple[StorageObject, float]]:
        """Single-query convenience wrapper over batched scatter-gather."""
        res = self.vector_search_batch(
            np.atleast_2d(np.asarray(query, np.float32)),
            k,
            target=target,
            flt=flt,
            tenant=tenant,
            max_distance=max_distance,
            deadline=deadline,
            rerank=rerank,
        )
        return res[0]

    def vector_search_batch(
        self,
        queries: np.ndarray,
        k: int = 10,
        target: str = DEFAULT_VECTOR,
        flt: Optional[Filter] = None,
        tenant: str = "",
        max_distance: Optional[float] = None,
        deadline=None,
        rerank=None,
    ) -> list[list[tuple[StorageObject, float]]]:
        from weaviate_tpu_torch.monitoring.metrics import (
            QUERIES_TOTAL,
            QUERY_DURATION,
        )
        from weaviate_tpu_torch.monitoring.slow_query import REPORTER
        from weaviate_tpu_torch.serving import context as serving_ctx

        # end-to-end deadline (serving/context.py): an expired request is
        # shed HERE, before any shard filter/search work and before the
        # dispatcher could hand it a device batch slot
        req_ctx = serving_ctx.current()
        if deadline is None:
            deadline = req_ctx.deadline if req_ctx is not None else None
        elif req_ctx is None:
            # explicit deadline without an ingress scope (direct API use):
            # still propagate it into the shard pool / dispatcher
            req_ctx = serving_ctx.RequestContext(deadline=deadline)
        if deadline is not None:
            deadline.require()
        t0 = time.perf_counter()
        shards = self._search_shards(tenant)
        per_shard: list[tuple[Shard, SearchResult]] = []

        # pool workers inherit neither the request scope nor the
        # dispatcher's thread-local batch-group token (the hybrid dense
        # leg's identity) — capture both here, re-enter in run()
        from weaviate_tpu_torch.index.dispatch import (
            current_dispatch_group,
            dispatch_group,
        )

        group_token = current_dispatch_group()

        def run(shard: Shard):
            # pool threads don't inherit the caller's thread-local request
            # scope; re-enter it so the dispatcher sees the deadline
            with serving_ctx.request_scope(req_ctx), \
                    dispatch_group(group_token), \
                    REPORTER.track("vector", collection=self.config.name,
                                   shard=shard.name) as tr:
                allow = None
                est_sel = None
                if flt is not None:
                    # resident plane first: a hot predicate serves from
                    # its bitmap (and coalesces in the dispatcher by
                    # (plane_id, version)) instead of materializing a
                    # fresh full-corpus mask per query; the sketch
                    # estimate rides along for the planner's trace span
                    plane = shard.filter_planes.lookup(flt)
                    allow = (plane if plane is not None
                             else shard.allow_list(flt))
                    try:
                        est_sel = shard.inverted.estimate_selectivity(flt)
                    except Exception:
                        # estimator gaps never fail a query
                        import logging

                        logging.getLogger(
                            "weaviate_tpu_torch.core.collection").debug(
                            "selectivity estimate failed", exc_info=True)
                        est_sel = None
                tr.stage("filter")
                if deadline is not None:
                    deadline.require()  # filter work may have spent it
                res = shard.vector_search(
                    queries, k, target=target, allow_list=allow,
                    max_distance=max_distance, rerank=rerank,
                    est_selectivity=est_sel)
                tr.stage("search")
            return shard, res

        # request-level tracker: folds the admission queue wait in ONCE
        # (the per-shard trackers above deliberately don't, so a queued
        # request can't log N-shards duplicate slow-query lines)
        with REPORTER.track("vector_request",
                            collection=self.config.name,
                            include_queue_wait=True,
                            shards=len(shards)) as req_tr:
            if len(shards) == 1:
                per_shard = [run(shards[0])]
            else:
                per_shard = list(self._pool.map(run, shards))
            req_tr.stage("scatter")
        QUERIES_TOTAL.inc(type="vector", collection=self.config.name)
        QUERY_DURATION.observe(time.perf_counter() - t0, type="vector")

        # a multivector target consumes the whole [Tq, D] matrix as ONE
        # late-interaction query — the merged result has a single row
        target_cfg = (self.config.vector_config if target == DEFAULT_VECTOR
                      else self.config.named_vectors.get(target))
        if target_cfg is not None and target_cfg.index_type == "multivector":
            b = 1
        else:
            b = np.atleast_2d(queries).shape[0]
        out: list[list[tuple[StorageObject, float]]] = []
        for qi in range(b):
            cands: list[tuple[float, Shard, int]] = []
            for shard, res in per_shard:
                for d, i in zip(res.dists[qi], res.ids[qi]):
                    if i >= 0:
                        cands.append((float(d), shard, int(i)))
            cands.sort(key=lambda t: t[0])
            row = []
            for d, shard, docid in cands[:k]:
                obj = shard.get_by_docid(docid)
                if obj is not None:
                    row.append((obj, d))
            out.append(row)
        return out

    def bm25_search(
        self,
        query: str,
        k: int = 10,
        properties: Optional[list[str]] = None,
        flt: Optional[Filter] = None,
        tenant: str = "",
        operator: str = "Or",
        minimum_match: int = 0,
        deadline=None,
        device_scoring: bool = False,
    ) -> list[tuple[StorageObject, float]]:
        """BM25 keyword search across shards. ``device_scoring``: score
        with kernel B6a on the shard's device (``ops/sparse.py``) instead
        of BlockMax-WAND on the host — the hybrid path sets it for filtered
        legs, where WAND's skipping advantage collapses. A device error
        raises; a shard whose tier cannot serve the device route (none in
        the port yet) answers from WAND."""
        from weaviate_tpu_torch.monitoring.metrics import (
            HYBRID_FALLBACK,
            QUERIES_TOTAL,
            QUERY_DURATION,
        )
        from weaviate_tpu_torch.monitoring.slow_query import REPORTER
        from weaviate_tpu_torch.serving.context import current_deadline

        if deadline is None:
            deadline = current_deadline()
        t0 = time.perf_counter()
        results: list[tuple[float, Shard, int]] = []
        # request-level slow-query tracker (folds admission queue wait in)
        with REPORTER.track("bm25", collection=self.config.name,
                            include_queue_wait=True):
            for shard in self._search_shards(tenant):
                if deadline is not None:
                    deadline.require()  # shed between shards
                allow = None
                space = max(shard._next_doc_id, 1)
                if flt is not None:
                    allow = shard.allow_list(flt, space)
                hit = None
                if device_scoring:
                    hit = shard.inverted.bm25_device_search(
                        query, k, properties=properties,
                        allow_list=allow, doc_space=space,
                        operator=operator, minimum_match=minimum_match,
                        device=shard.device,
                    )
                    if hit is None:
                        from weaviate_tpu_torch.monitoring import tracing

                        HYBRID_FALLBACK.inc(stage="sparse",
                                            reason="unsupported")
                        span = tracing.current_span()
                        if span is not None:
                            span.add_event("hybrid.sparse.fallback",
                                           reason="unsupported",
                                           shard=shard.name)
                if hit is None:
                    hit = shard.inverted.bm25_search(
                        query, k, properties=properties, allow_list=allow,
                        doc_space=space, operator=operator,
                        minimum_match=minimum_match,
                    )
                ids, scores = hit
                for i, s in zip(ids, scores):
                    results.append((float(s), shard, int(i)))
            results.sort(key=lambda t: -t[0])
            out = []
            for s, shard, docid in results[:k]:
                obj = shard.get_by_docid(docid)
                if obj is not None:
                    out.append((obj, s))
        QUERIES_TOTAL.inc(type="bm25", collection=self.config.name)
        QUERY_DURATION.observe(time.perf_counter() - t0, type="bm25")
        return out

    def hybrid_search(
        self,
        query: Optional[str] = None,
        vector: Optional[np.ndarray] = None,
        alpha: float = 0.75,
        k: int = 10,
        fusion: str = "relativeScoreFusion",
        properties: Optional[list[str]] = None,
        flt: Optional[Filter] = None,
        tenant: str = "",
        target: str = DEFAULT_VECTOR,
        max_vector_distance: Optional[float] = None,
        operator: str = "Or",
        minimum_match: int = 0,
    ) -> list[tuple[StorageObject, float]]:
        """BM25 + vector branches fused (reference ``hybrid/searcher.go:75``).

        ``alpha`` weighs the vector branch (1.0 = pure vector, 0.0 = pure
        keyword). Vector-branch scores enter fusion as negated distances so
        "higher is better" holds for both branches.

        The sparse leg runs on the collection's pool concurrently with the
        dense leg on this thread, both under the request's serving deadline
        and inside the ingress trace (``hybrid.sparse`` / ``hybrid.dense`` /
        ``hybrid.fuse`` child spans). The keyword leg takes WAND on the host
        or kernel B6a on the device (``hybrid_sparse_device``: "auto" sends
        filtered legs to the device); the fusion is one launch of kernel
        B6b on the collection's device. Each leg over-fetches
        ``hybrid_overfetch_factor``·k. A leg that outlives the deadline
        sheds while the other leg's results still fuse.
        """
        from weaviate_tpu_torch.index.dispatch import dispatch_group
        from weaviate_tpu_torch.monitoring import tracing
        from weaviate_tpu_torch.monitoring.metrics import (
            HYBRID_LEG_SECONDS,
            HYBRID_LEG_SHED,
            HYBRID_REQUESTS,
        )
        from weaviate_tpu_torch.monitoring.tracing import TRACER
        from weaviate_tpu_torch.query.fusion import (
            fuse_result_sets,
            hybrid_fetch,
            validate_fusion,
        )
        from weaviate_tpu_torch.serving import context as serving_ctx
        from weaviate_tpu_torch.utils.runtime_config import (
            HYBRID_SPARSE_DEVICE,
        )

        validate_fusion(fusion)
        req_ctx = serving_ctx.current()
        deadline = req_ctx.deadline if req_ctx is not None else None
        if deadline is not None:
            deadline.require()
        fetch = hybrid_fetch(k)
        parent = tracing.current_span()
        want_sparse = bool(query) and alpha < 1.0
        want_dense = vector is not None and alpha > 0.0
        sparse_mode = str(HYBRID_SPARSE_DEVICE.get()).lower()
        if sparse_mode in ("off", "0", "false"):
            device_sparse = False
        elif sparse_mode in ("on", "1", "true"):
            device_sparse = True
        else:  # auto: filtered legs, where WAND's advantage collapses
            device_sparse = flt is not None

        def sparse_leg():
            # pool thread: re-enter the request scope (deadline) and the
            # ingress trace so the leg's span overlaps the dense leg's
            with serving_ctx.request_scope(req_ctx), \
                    TRACER.span("hybrid.sparse", parent=parent, k=fetch,
                                device_scoring=device_sparse):
                t0 = time.perf_counter()
                out = self.bm25_search(
                    query, fetch, properties=properties, flt=flt,
                    tenant=tenant, operator=operator,
                    minimum_match=minimum_match,
                    device_scoring=device_sparse,
                )
                HYBRID_LEG_SECONDS.observe(time.perf_counter() - t0,
                                           leg="sparse")
                return out

        sparse_future = self._pool.submit(sparse_leg) if want_sparse \
            else None

        sets: list[list[tuple[str, float]]] = []
        weights: list[float] = []
        by_uuid: dict[str, StorageObject] = {}
        dense = None
        if want_dense:
            try:
                with TRACER.span("hybrid.dense", parent=parent,
                                 k=fetch), \
                        dispatch_group(("hybrid", fusion)):
                    t0 = time.perf_counter()
                    dense = self.vector_search(
                        vector, fetch, target=target, flt=flt,
                        tenant=tenant,
                        max_distance=max_vector_distance,
                    )
                    HYBRID_LEG_SECONDS.observe(time.perf_counter() - t0,
                                               leg="dense")
            except TimeoutError:  # DeadlineExceeded
                # shed symmetrically: a dense leg that outlives the
                # budget must not discard a sparse leg that finished in
                # time — only with no completed sparse page does the
                # request itself shed
                if sparse_future is None or not sparse_future.done():
                    raise
                HYBRID_LEG_SHED.inc(leg="dense")
                if parent is not None:
                    parent.add_event("hybrid.leg_shed", leg="dense")

        sparse = None
        if sparse_future is not None:
            try:
                timeout = None
                if deadline is not None:
                    timeout = max(0.0, deadline.remaining())
                sparse = sparse_future.result(timeout=timeout)
            except (TimeoutError, FuturesTimeout):
                # the slow leg sheds; the other leg's results still fuse
                # (with no surviving leg the request itself is over
                # deadline and sheds below)
                HYBRID_LEG_SHED.inc(leg="sparse")
                if parent is not None:
                    parent.add_event("hybrid.leg_shed", leg="sparse")
                if dense is None:
                    if deadline is not None:
                        deadline.require()  # -> DeadlineExceeded
                    raise
        if sparse is not None:
            sets.append([(o.uuid, s) for o, s in sparse])
            weights.append(1.0 - alpha)
            for o, _ in sparse:
                by_uuid.setdefault(o.uuid, o)
        if dense is not None:
            sets.append([(o.uuid, -d) for o, d in dense])
            weights.append(alpha)
            for o, _ in dense:
                by_uuid.setdefault(o.uuid, o)

        with TRACER.span("hybrid.fuse", parent=parent, fusion=fusion,
                         legs=len(sets)):
            fused = fuse_result_sets(sets, weights, k, fusion,
                                     device=self.device)
        HYBRID_REQUESTS.inc(fusion=fusion)
        return [(by_uuid[u], s) for u, s in fused if u in by_uuid]

    def multi_target_search(self, vectors: dict[str, np.ndarray],
                            k: int = 10, **kwargs):
        """Search several named target vectors and join scores: not
        ported yet."""
        raise NotImplementedError(
            "Collection.multi_target_search: not ported yet (ROADMAP "
            "queue A, slice 7)")

    def aggregate(
        self,
        properties: Optional[dict[str, Optional[str]]] = None,
        flt: Optional[Filter] = None,
        group_by: Optional[str] = None,
        tenant: str = "",
        top_occurrences_limit: int = 5,
    ) -> dict:
        """Aggregate API (reference ``aggregator/``): meta count + per-property
        aggregations, optionally filtered and grouped by a property.

        ``properties``: {prop: kind} where kind in numeric|text|boolean|date|
        reference|auto (None = auto-infer).
        """
        from weaviate_tpu_torch.query.aggregator import (
            aggregate_property,
        )
        from weaviate_tpu_torch.query.aggregator import (
            per_doc_distinct as _dedup,
        )

        properties = properties or {}
        shards = self._search_shards(tenant)

        # collect (docid-scoped) values per shard under the filter mask
        total = 0
        prop_values: dict[str, list] = {p: [] for p in properties}
        group_rows: dict[object, dict[str, list]] = {}
        group_counts: dict[object, int] = {}

        for shard in shards:
            space = max(shard._next_doc_id, 1)
            if flt is not None:
                mask = shard.allow_list(flt, space)
                # the inverted value maps only hold live docs, so the mask is
                # already liveness-correct
                total += int(mask.sum())
            else:
                mask = None  # all live docs
                total += shard.count()

            inv = shard.inverted
            if getattr(inv, "segmented", False):
                raise NotImplementedError(
                    "aggregation over the segment-resident inverted tier: "
                    "not ported yet (ROADMAP queue A, slice 6b)")

            doc_ids = (None if mask is None
                       else set(int(i) for i in np.nonzero(mask)[0]))

            def docs_with(prop: str):
                vals = inv.values.get(prop, {})
                for d, v in vals.items():
                    if doc_ids is None or d in doc_ids:
                        yield d, _dedup(v)

            if group_by is None:
                for p in properties:
                    prop_values[p].extend(v for _, v in docs_with(p))
            else:
                gvals = inv.values.get(group_by, {})
                for d, gv in gvals.items():
                    if doc_ids is not None and d not in doc_ids:
                        continue
                    for g in _dedup(gv) if isinstance(gv, list) else [gv]:
                        group_counts[g] = group_counts.get(g, 0) + 1
                        row = group_rows.setdefault(
                            g, {p: [] for p in properties}
                        )
                        for p in properties:
                            v = inv.values.get(p, {}).get(d)
                            if v is not None:
                                row[p].append(_dedup(v))

        if group_by is None:
            return {
                "meta": {"count": total},
                "properties": {
                    p: aggregate_property(vals, properties[p], top_occurrences_limit)
                    for p, vals in prop_values.items()
                },
            }
        groups = []
        # count desc, value asc on ties — engine-order independent
        for g, count in sorted(group_counts.items(),
                               key=lambda t: (-t[1], str(t[0]))):
            groups.append({
                "groupedBy": {"path": [group_by], "value": g},
                "meta": {"count": count},
                "properties": {
                    p: aggregate_property(vals, properties[p], top_occurrences_limit)
                    for p, vals in group_rows[g].items()
                },
            })
        return {"meta": {"count": total}, "groups": groups}

    def filter_search(
        self, flt: Filter, limit: int = 100, tenant: str = ""
    ) -> list[StorageObject]:
        out: list[StorageObject] = []
        for shard in self._search_shards(tenant):
            space = max(shard._next_doc_id, 1)
            mask = shard.allow_list(flt, space)
            for d in np.nonzero(mask)[0]:
                obj = shard.get_by_docid(int(d))
                if obj is not None:
                    out.append(obj)
                    if len(out) >= limit:
                        return out
        return out

    def expire_ttl_once(self) -> int:
        """Delete expired objects (reference ``usecases/object_ttl``
        background expiry). Returns number removed."""
        ttl = self.config.object_ttl_seconds
        if ttl <= 0:
            return 0
        cutoff = int((time.time() - ttl) * 1000)
        with self._lock:
            shards = list(self._shards.values())
        return sum(s.expire_ttl(cutoff) for s in shards)

    # -- lifecycle --------------------------------------------------------
    def flush(self) -> None:
        for s in self._shards.values():
            s.flush()

    @contextmanager
    def maintenance_paused(self):
        """Freeze segment-set mutations across every shard for the duration
        (backup copy window; reference ``shard_backup.go`` BeginBackup →
        pause compaction+flush → copy → ResumeMaintenance). Writes continue
        into WAL+memtable. Shards created while paused inherit the pause
        (see ``_get_shard``)."""
        with self._lock:
            self._maintenance_pause += 1
            shards = list(self._shards.values())
        for s in shards:
            s.store.pause_maintenance()
        try:
            yield
        finally:
            with self._lock:
                self._maintenance_pause -= 1
                now = list(self._shards.values())
            # resume every shard that is currently paused — including ones
            # born (and pre-paused) during the window
            for s in now:
                s.store.resume_maintenance()

    def compact_once(self, min_segments: int = 4,
                     include_unopened: bool = False) -> None:
        """One background-compaction pass. The periodic cycle touches only
        OPEN shards (waking every lazy tenant each minute would defeat
        lazy loading); the explicit distributed-task path passes
        ``include_unopened`` to cover everything."""
        with self._lock:
            if self._maintenance_pause:
                return
            shards = list(self._shards.values())
        if include_unopened:
            with self._maintenance_shards() as all_shards:
                for s in all_shards:
                    s.store.compact_all(min_segments)
            return
        for s in shards:
            s.store.compact_all(min_segments)

    def close(self) -> None:
        # snapshot under the lock: a straggler replication push (late
        # anti-entropy object_push, a racing shard build) can still be
        # inserting into _shards while the node tears down
        with self._lock:
            shards = list(self._shards.values())
        for s in shards:
            s.close()
        self._pool.shutdown(wait=False)

    def stats(self) -> dict:
        return {
            "name": self.config.name,
            "objects": self.count() if not self.config.multi_tenancy.enabled else None,
            "shards": {n: s.stats() for n, s in self._shards.items()},
            "tenants": dict(self._tenant_status),
        }
