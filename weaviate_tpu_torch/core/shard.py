"""Shard: the unit of data ownership.

Reference: ``adapters/repos/db/shard.go:204`` — each shard owns an LSMKV
store, inverted indexes, one-or-more vector indexes (named target vectors),
and a doc-id counter. Write path mirrors ``shard_write_batch_objects.go:33``
(object store -> inverted -> vector index -> WAL flush); read path mirrors
``shard_read.go:374`` (ObjectVectorSearch).

Port of ``weaviate_tpu/core/shard.py``. A shard's vector indexes and filter
planes live on the device it was opened with (``device=``, ``cuda`` unless
the caller names another); every on-disk artifact (LSM store, delta log,
inverted snapshot, vector checkpoints, HNSW graph snapshot and commit log,
counters) has the JAX package's format, so either package opens a shard
directory the other wrote. A multi-target search runs one walk a target
and the join on the card (``multi_target_search``). Inverted storage
``"segment"`` keeps the inverted index in LSM buckets
(``inverted/segmented.py``); ``"auto"`` migrates a RAM index to it in the
background past ``segment_cutoff`` live docs (``_maybe_upgrade_inverted``).
"""

from __future__ import annotations

import os
import struct
import threading
from typing import Optional

import msgpack
import numpy as np

from weaviate_tpu_torch.index.base import SearchResult, VectorIndex
from weaviate_tpu_torch.inverted.index import InvertedIndex
from weaviate_tpu_torch.inverted.segmented import make_inverted_index
from weaviate_tpu_torch.index.store import resolve_device
from weaviate_tpu_torch.schema.config import (
    CollectionConfig,
    DynamicIndexConfig,
    FlatIndexConfig,
    HNSWIndexConfig,
    VectorIndexConfig,
)
from weaviate_tpu_torch.storage.objects import StorageObject
from weaviate_tpu_torch.storage.store import Store

_DOCID = struct.Struct(">q")

DEFAULT_VECTOR = ""  # unnamed/default target vector


def build_vector_index(
    dims: int, cfg: VectorIndexConfig, path: Optional[str] = None,
    device=None,
) -> VectorIndex:
    """Factory mirroring ``shard_init_vector.go`` index selection, on
    ``device``. ``path`` is the index's own directory (the HNSW graph
    snapshot and commit log live there). Index types not ported yet raise
    ``NotImplementedError`` naming the slice that brings them (a schema
    written by the JAX package may name them: ``validate`` is not run on
    load)."""
    if isinstance(cfg, HNSWIndexConfig) or cfg.index_type == "hnsw":
        from weaviate_tpu_torch.index.hnsw import HNSWIndex

        if not isinstance(cfg, HNSWIndexConfig):
            cfg = cfg.as_type(HNSWIndexConfig, "hnsw")
        return HNSWIndex(dims, cfg, path=path, device=device)
    if isinstance(cfg, DynamicIndexConfig) or cfg.index_type == "dynamic":
        from weaviate_tpu_torch.index.dynamic import DynamicIndex

        if not isinstance(cfg, DynamicIndexConfig):
            cfg = cfg.as_type(DynamicIndexConfig, "dynamic")
        return DynamicIndex(dims, cfg, path=path, device=device)
    if cfg.index_type == "multivector":
        from weaviate_tpu_torch.index.multivector import MultiVectorIndex
        from weaviate_tpu_torch.schema.config import MultiVectorIndexConfig

        if not isinstance(cfg, MultiVectorIndexConfig):
            cfg = cfg.as_type(MultiVectorIndexConfig, "multivector")
        return MultiVectorIndex(dims, cfg, device=device)
    if cfg.index_type == "hfresh":
        from weaviate_tpu_torch.index.hfresh import HFreshIndex
        from weaviate_tpu_torch.schema.config import HFreshIndexConfig

        if not isinstance(cfg, HFreshIndexConfig):
            cfg = cfg.as_type(HFreshIndexConfig, "hfresh")
        return HFreshIndex(dims, cfg, device=device)
    from weaviate_tpu_torch.index.flat import make_flat

    if not isinstance(cfg, FlatIndexConfig):
        cfg = cfg.as_type(FlatIndexConfig, "flat")
    tier = getattr(cfg, "raw_tier", "ram")
    if tier.startswith("disk"):
        raise NotImplementedError(
            f"raw_tier {tier!r} (disk-paged originals): not ported yet "
            "(ROADMAP queue A, slice 9)")
    # a quantized target keeps its codes on the device and its
    # originals on the host; it checkpoints no raw vectors, so a reopen
    # rebuilds it from the objects (``_rebuild_vector_targets``)
    return make_flat(dims, cfg, device=device)


class MultiTargetIneligible(RuntimeError):
    """A target of a multi-target search cannot walk on the card now (no
    device walk, demoted, or an unfitted quantizer): the collection serves
    the request from the host oracle."""


def _feed_index(idx: VectorIndex, id_arr: np.ndarray, vecs: list) -> None:
    """Route a collected batch to the index: ragged token sets go to the
    multivector path, fixed-dim rows stack into one device batch."""
    if idx.multi_vector:
        idx.add_batch_multi(id_arr, [np.asarray(v, np.float32) for v in vecs])
    else:
        idx.add_batch(id_arr, np.stack(vecs))


class Shard:
    def __init__(self, dirpath: str, config: CollectionConfig, name: str = "shard0",
                 sync_writes: bool = False, device=None):
        self.dir = dirpath
        # every vector index and filter plane of this shard lives here
        self.device = resolve_device(device)
        self.name = name
        self.config = config
        os.makedirs(dirpath, exist_ok=True)
        # group=sync_writes: bucket WALs defer their fsync to the ONE
        # store.sync_all() barrier put_batch/delete run per batch (group
        # commit, docs/ingest.md) instead of fsyncing per record
        self.store = Store(os.path.join(dirpath, "lsm"), sync=sync_writes,
                           group=sync_writes)
        self.objects = self.store.bucket("objects")  # docid(8B BE) -> storobj
        self.ids = self.store.bucket("ids")  # uuid bytes -> docid(8B)
        self._inv_snap_path = os.path.join(dirpath, "inverted.snap")
        self.inverted = make_inverted_index(
            config, self.store, snapshot_path=self._inv_snap_path)
        # resident filter planes (query/planner/planes.py): declared hot
        # predicates compile to bitmap planes maintained on the durable
        # write path; undeclared predicates auto-promote by hit rate.
        # recompute = the exact evaluator (inverted ∧ live), used at
        # promotion and stale recovery — NOT per query.
        from weaviate_tpu_torch.inverted.filters import Filter as _Filter
        from weaviate_tpu_torch.query.planner import FilterPlaneStore

        self.filter_planes = FilterPlaneStore(recompute=self.allow_list,
                                              device=self.device)
        for f in (config.resident_filters or []):
            self.filter_planes.declare(
                _Filter.from_dict(f) if isinstance(f, dict) else f)
        # set by Collection.release_tenant just before it closes this
        # instance (tiering cold demotion): a writer that routed to the
        # old object must re-route to the re-opened shard, not mutate a
        # closed store
        self._tier_released = False
        self._lock = threading.RLock()
        self._migrating = False  # auto tier upgrade in flight
        self._migrate_cancel = False
        self._migrate_thread = None
        # first-touch index builds serialize here, NOT on the shard lock:
        # the ingest drain (no shard lock held) is the usual builder, and
        # a build under the shard lock was the old convoy (docs/ingest.md).
        # _vector_indexes/_dims publish copy-on-write under this lock so
        # every reader iterates a stable snapshot lock-free.
        self._build_lock = threading.Lock()
        # one coalescing dispatcher a (target set, join) of multi-target
        # searches
        self._mt_dispatchers: dict[tuple, object] = {}
        # checkpoint gate: deferred post-lock index work (ragged feeds,
        # index deletes) in flight — a checkpoint taken mid-window would
        # record a seq whose index effects haven't landed yet
        self._defer_ops = 0
        self._vector_indexes: dict[str, VectorIndex] = {}
        self._counter_path = os.path.join(dirpath, "counter.bin")
        self._meta_path = os.path.join(dirpath, "meta.bin")
        self._delta_path = os.path.join(dirpath, "delta.log")
        self._sweep_tmp(dirpath)
        self._next_doc_id = 0
        self._seq = 0  # per-shard op sequence, checkpoints record it
        self._dims: dict[str, int] = {}
        self._recover()
        from weaviate_tpu_torch.storage.wal import WAL

        self._delta = WAL(self._delta_path, sync=sync_writes,
                          group=sync_writes)
        # ingest pipeline stage (docs/ingest.md): EVERY fixed-shape vector
        # write enqueues a durable chunk inside the durability section and
        # the device feed happens in drain windows outside the shard lock.
        # Default = inline drain (put_batch drains its own chunks before
        # returning: read-your-writes preserved, but readers and other
        # writers never queue behind one writer's device build).
        # ASYNC_INDEXING env / per-class config = the legacy fully-async
        # mode: a background drainer, writes return before indexing.
        from weaviate_tpu_torch.core.async_queue import AsyncVectorQueue

        self._fully_async = bool(
            config.async_indexing
            or os.environ.get("ASYNC_INDEXING") == "true")
        self.async_queue = AsyncVectorQueue(
            os.path.join(dirpath, "index_queue"),
            index_for=self._index_for,
            is_live=lambda d: bool(
                d < self._live.shape[0] and self._live[d]),
            shard_label=name,
        )
        if self._fully_async:
            self.async_queue.start()

    # -- recovery ---------------------------------------------------------
    def _recover(self) -> None:
        """Checkpointed boot: load the inverted snapshot + per-target vector
        checkpoints (all written at one seq), then replay only the delta-log
        records past that seq — O(checkpoint bytes + delta), not O(corpus)
        re-tokenize/re-upload (VERDICT r1 weak #4; reference
        ``hnsw/startup.go`` replays its commit log the same way). Fallbacks:
        no/corrupt inverted snapshot -> full object-store rebuild; a missing
        or seq-mismatched vector checkpoint -> one streaming object scan for
        just those targets."""
        if os.path.exists(self._counter_path):
            with open(self._counter_path, "rb") as f:
                self._next_doc_id = msgpack.unpackb(f.read())
        if os.path.exists(self._meta_path):
            with open(self._meta_path, "rb") as f:
                meta = msgpack.unpackb(f.read(), raw=False)
            self._dims = meta.get("dims", {})

        from weaviate_tpu_torch.inverted.snapshot import load_snapshot
        from weaviate_tpu_torch.storage.wal import WAL

        inv_seq = load_snapshot(self.inverted, self._inv_snap_path)
        if inv_seq is None:
            self.recovered_from = "full"
            self._recover_full()
            # track seq high-water even on full rebuild
            for payload in WAL.replay(self._delta_path):
                rec = msgpack.unpackb(payload, raw=False)
                self._seq = max(self._seq, rec["s"])
            return
        self._seq = inv_seq
        self.recovered_from = "checkpoint"

        # liveness mirrors the columnar live bitmap (set on every add, False
        # on delete) — no object scan needed
        la = self.inverted.columnar._live._arr
        self._live = np.zeros(max(self._next_doc_id, len(la), 64), bool)
        self._live[: len(la)] = la
        self._live_count = int(self._live.sum())

        # vector checkpoints: valid only at exactly the snapshot's seq
        rebuild_targets: list[str] = []
        for nm, dims in self._dims.items():
            idx = self._index_for(nm, dims)
            meta = idx.load_vectors(self._vec_ckpt_path(nm))
            if meta is None or meta.get("seq") != inv_seq:
                # a mismatched checkpoint already mutated the store —
                # discard the index object and rebuild it from objects
                # (fresh HNSW still reuses graph.npz; add_batch re-puts
                # every live vector and skips existing nodes)
                self._vector_indexes.pop(nm, None)
                self._index_for(nm, dims)
                rebuild_targets.append(nm)
        if rebuild_targets:
            self._rebuild_vector_targets(rebuild_targets)

        # delta replay: records past the checkpoint re-index from the
        # durable object store; adds of later-deleted docs no-op (object
        # gone), deletes of unknown docs no-op (liveness check)
        batches: dict[str, tuple[list[int], list[np.ndarray]]] = {}
        for payload in WAL.replay(self._delta_path):
            rec = msgpack.unpackb(payload, raw=False)
            seq = rec["s"]
            self._seq = max(self._seq, seq)
            if seq <= inv_seq:
                continue
            if rec["o"] == "a":
                for d in rec["d"]:
                    raw = self.objects.get(_DOCID.pack(d))
                    if raw is None:
                        continue
                    obj = StorageObject.from_bytes(raw)
                    if not (d < len(self._live) and self._live[d]):
                        self._live_count += 1
                    self._mark_live(d)
                    self.inverted.add_object(obj)
                    if obj.vector is not None:
                        b = batches.setdefault(DEFAULT_VECTOR, ([], []))
                        b[0].append(d)
                        b[1].append(np.asarray(obj.vector, np.float32))
                    for nm, v in obj.named_vectors.items():
                        b = batches.setdefault(nm, ([], []))
                        b[0].append(d)
                        b[1].append(np.asarray(v, np.float32))
            else:
                # vector adds queued so far must land BEFORE this delete —
                # batching past it would replay add/delete of the same doc
                # as delete-then-add and resurrect it
                self._flush_replay_batches(batches)
                for d in rec["d"]:
                    if not (d < len(self._live) and self._live[d]):
                        continue
                    self.inverted.delete_docid(d)
                    self._mark_live(d, False)
                    self._live_count -= 1
                    arr = np.asarray([d], np.int64)
                    for idx in self._vector_indexes.values():
                        idx.delete(arr)
                    # converge the object store too: the crash may have lost
                    # the objects.delete/ids.delete that followed the delta
                    # append (else the "deleted" object survives lookups and
                    # any later full rebuild resurrects it)
                    raw = self.objects.get(_DOCID.pack(d))
                    if raw is not None:
                        obj = StorageObject.from_bytes(raw)
                        self.objects.delete(_DOCID.pack(d))
                        prev = self.ids.get(obj.uuid.encode())
                        if prev is not None and _DOCID.unpack(prev)[0] == d:
                            self.ids.delete(obj.uuid.encode())
        self._flush_replay_batches(batches)

    def _flush_replay_batches(
        self, batches: dict[str, tuple[list[int], list[np.ndarray]]]
    ) -> None:
        for nm, (ids, vecs) in batches.items():
            if not ids:
                continue
            idx = self._index_for(nm, int(np.asarray(vecs[0]).shape[-1]))
            _feed_index(idx, np.asarray(ids, np.int64), vecs)
        batches.clear()

    def _recover_full(self) -> None:
        """Full rebuild from the object store (no usable checkpoint)."""
        batches: dict[str, tuple[list[int], list[np.ndarray]]] = {}
        live = 0
        self._live = np.zeros(max(self._next_doc_id, 64), bool)
        for key, raw in self.objects.items():
            obj = StorageObject.from_bytes(raw)
            live += 1
            self._mark_live(obj.doc_id)
            self.inverted.add_object(obj)
            if obj.vector is not None:
                batches.setdefault(DEFAULT_VECTOR, ([], []))[0].append(obj.doc_id)
                batches[DEFAULT_VECTOR][1].append(obj.vector)
            for nm, v in obj.named_vectors.items():
                batches.setdefault(nm, ([], []))[0].append(obj.doc_id)
                batches[nm][1].append(v)
        for nm, (ids, vecs) in batches.items():
            idx = self._index_for(nm, int(np.asarray(vecs[0]).shape[-1]))
            _feed_index(idx, np.asarray(ids, np.int64), vecs)
        self._live_count = live

    def _rebuild_vector_targets(self, targets: list[str]) -> None:
        """One streaming object scan feeding only the named targets (e.g.
        quantized indexes, which don't checkpoint raw vectors)."""
        batches: dict[str, tuple[list[int], list[np.ndarray]]] = {
            nm: ([], []) for nm in targets
        }
        want_default = DEFAULT_VECTOR in batches
        for key, raw in self.objects.items():
            obj = StorageObject.from_bytes(raw)
            if want_default and obj.vector is not None:
                batches[DEFAULT_VECTOR][0].append(obj.doc_id)
                batches[DEFAULT_VECTOR][1].append(obj.vector)
            for nm, v in obj.named_vectors.items():
                if nm in batches:
                    batches[nm][0].append(obj.doc_id)
                    batches[nm][1].append(v)
        for nm, (ids, vecs) in batches.items():
            if not ids:
                continue
            idx = self._index_for(nm, int(np.asarray(vecs[0]).shape[-1]))
            _feed_index(idx, np.asarray(ids, np.int64), vecs)

    def _vec_ckpt_path(self, target: str) -> str:
        return os.path.join(self.dir, f"vector__{target}.ckpt")

    def checkpoint(self) -> None:
        """Write inverted snapshot + vector checkpoints at the current seq
        and truncate the delta log. Called on close and by maintenance
        cycles; crash mid-checkpoint costs a rebuild, never correctness
        (every artifact carries its seq and is swapped in atomically)."""
        from weaviate_tpu_torch.inverted.snapshot import save_snapshot
        from weaviate_tpu_torch.storage.wal import WAL

        # drain the ingest window OUTSIDE the lock first: the vector
        # checkpoints below must contain every add <= seq, and draining
        # in-lock would put device work back under the shard lock — the
        # exact convoy the pipeline removed
        self.async_queue.flush()
        with self._lock:
            if self._migrating:
                # the tier migration's catch-up replay depends on the delta
                # log this would truncate; the next cycle checkpoints
                # normally. Checked under the lock: the migration also
                # takes it to read start_seq, so either this checkpoint
                # completed before the migration snapshotted its seq (all
                # later records survive) or it sees the flag and skips.
                return
            if self._defer_ops:
                # a racing writer's post-lock index work (ragged feed /
                # deferred delete) is in flight: the index lags the delta
                # seq. Skip — a skipped checkpoint never loses data (the
                # delta log still covers everything), and this window is
                # the brief post-lock tail of one batch, so the next
                # cycle lands.
                return
            # residual chunks pushed between the flush above and this
            # lock: drain them HERE so the vector snapshots provably
            # cover every add <= seq. Bounded device work (the out-of-
            # lock flush consumed the backlog, and pushes need the shard
            # lock we hold, so nothing new can arrive) — a skip instead
            # would starve under sustained ingest, where some writer's
            # chunk is pending at almost every cycle, and the delta log
            # would never truncate during exactly the ingest-while-
            # serving workload that grows it fastest.
            self.async_queue.drain_until_empty()
            seq = self._seq
            # objects the snapshot indexes must be durable BEFORE the delta
            # log is truncated — else a crash leaves doc ids the store can't
            # resolve (memtable flush fsyncs segments)
            self.store.flush_all()
            save_snapshot(self.inverted, self._inv_snap_path, seq)
            for nm, idx in self._vector_indexes.items():
                idx.flush()  # HNSW graph snapshot rides along
                idx.save_vectors(self._vec_ckpt_path(nm), {"seq": seq})
            # all records are <= seq under the lock: drop the whole log
            sync, group = self._delta.sync, self._delta.group
            self._delta.close()
            WAL.delete(self._delta_path)
            self._delta = WAL(self._delta_path, sync=sync, group=group)

    @staticmethod
    def _atomic_write(path: str, blob: bytes) -> None:
        """Unique tmp name per call: concurrent checkpoint/flush callers
        with a SHARED tmp name race each other's os.replace (the loser
        hits FileNotFoundError after the winner renamed the tmp away).
        Crash-orphaned tmps are swept at shard open (_sweep_tmp)."""
        import threading as _threading

        tmp = f"{path}.tmp.{os.getpid()}.{_threading.get_ident()}"
        with open(tmp, "wb") as f:
            f.write(blob)
        os.replace(tmp, path)

    @staticmethod
    def _sweep_tmp(dirpath: str) -> None:
        """Remove crash-orphaned ``*.tmp.<pid>.<tid>`` litter so backups
        and offload walks never carry it."""
        import glob

        for p in glob.glob(os.path.join(dirpath, "*.tmp.*")):
            try:
                os.remove(p)
            except OSError:
                pass

    def maybe_checkpoint(self, delta_threshold: int = 16 << 20) -> bool:
        """Checkpoint when the delta log outgrows the threshold — keeps
        crash recovery O(recent delta) on long-running servers (the
        docstring contract of checkpoint(); without a periodic caller the
        log would grow until close)."""
        try:
            size = os.path.getsize(self._delta_path)
        except OSError:
            size = 0
        if size < delta_threshold:
            return False
        self.checkpoint()
        return True

    def _persist_counter(self) -> None:
        self._atomic_write(self._counter_path,
                           msgpack.packb(self._next_doc_id))

    def _persist_meta(self) -> None:
        self._atomic_write(
            self._meta_path,
            msgpack.packb({"dims": self._dims}, use_bin_type=True))

    # -- vector index plumbing -------------------------------------------
    def _config_for(self, target: str) -> VectorIndexConfig:
        if target == DEFAULT_VECTOR:
            return self.config.vector_config
        cfg = self.config.named_vectors.get(target)
        if cfg is None:
            raise KeyError(f"unknown target vector {target!r}")
        return cfg

    def _index_for(self, target: str, dims: int) -> VectorIndex:
        idx = self._vector_indexes.get(target)
        if idx is not None:
            return idx
        # first touch: build under the BUILD lock, never the shard lock —
        # the ingest drain is the usual builder and a build in the shard
        # lock was the old write-path convoy. Publish copy-on-write so
        # concurrent readers iterate a stable dict snapshot lock-free.
        with self._build_lock:
            idx = self._vector_indexes.get(target)
            if idx is not None:
                return idx
            # 'vector__' + target: the double underscore keeps the unnamed
            # default ('vector__') from colliding with a vector named 'default'
            path = os.path.join(self.dir, f"vector__{target}")
            # graftlint: allow[blocking-under-lock] reason=first-touch construction happens once per target on the build lock, which only other first-touch builders contend on; the shard lock (the write/read serving path) is never held here
            idx = build_vector_index(dims, self._config_for(target), path=path,
                                     device=self.device)
            self._dims = {**self._dims, target: dims}
            self._vector_indexes = {**self._vector_indexes, target: idx}
            self._persist_meta()
            return idx

    def vector_index(self, target: str = DEFAULT_VECTOR) -> Optional[VectorIndex]:
        return self._vector_indexes.get(target)

    # -- write path -------------------------------------------------------
    def put_batch(self, objs: list[StorageObject]) -> list[int]:
        """Batch insert/update. Returns assigned doc ids.

        Mirrors objectsBatcher (``shard_write_batch_objects.go:84-140``),
        restructured as the ingest pipeline's front stage (docs/ingest.md):
        the lock-held critical section is DURABILITY ONLY — delta-log
        append, object + inverted + id-map writes, and the vector chunk
        push. The device feed (index build included) happens in queue
        drain windows after the lock is released, so one writer's device
        build never convoys every other writer and reader on the shard.
        """
        # memwatch gate (reference memwatch.CheckAlloc on the write path):
        # refuse the batch under memory pressure instead of OOMing mid-write
        from weaviate_tpu_torch.monitoring.memwatch import MONITOR

        est = sum(
            (len(o.properties) * 64)
            + (0 if o.vector is None
               else np.asarray(o.vector).nbytes * 2)
            + sum(np.asarray(v).nbytes * 2
                  for v in o.named_vectors.values())
            for o in objs)
        MONITOR.check_alloc(est, "batch import")
        deferred_deletes: Optional[np.ndarray] = None
        ragged: list[tuple[str, np.ndarray, list]] = []
        pushed: list[str] = []
        with self._lock:
            self._require_open()
            # validate up-front so a bad object can't leave a partial batch:
            # every vector for a target must match the index dims (or, for a
            # brand-new target, the dims of the first vector in this batch)
            batch_dims = dict(self._dims)
            for obj in objs:
                vec_items = []
                if obj.vector is not None:
                    vec_items.append((DEFAULT_VECTOR, obj.vector))
                vec_items.extend(obj.named_vectors.items())
                for nm, vec in vec_items:
                    d = int(np.asarray(vec).shape[-1])
                    want = batch_dims.setdefault(nm, d)
                    if d != want:
                        raise ValueError(
                            f"object {obj.uuid}: vector {nm or 'default'!r} dims "
                            f"{d} != index dims {want}"
                        )
            new_dims = {nm: d for nm, d in batch_dims.items()
                        if nm not in self._dims}
            if new_dims:
                # pin brand-new targets' dims NOW (the index itself builds
                # lazily at drain time): a later batch with different dims
                # must fail validation, not poison the drain
                with self._build_lock:
                    self._dims = {**self._dims, **new_dims}
                    self._persist_meta()
            # same uuid twice in one batch: the later occurrence wins; the
            # earlier one is never written (it was never visible)
            final: dict[str, StorageObject] = {o.uuid: o for o in objs}
            old_docids: list[int] = []
            # doc ids are assigned over the DEDUPED set only: burning one
            # per raw element desynced _next_doc_id from the live set when
            # a batch repeated a uuid (dropped earlier duplicates report
            # the winner's id — same uuid, same visible object)
            for obj in final.values():
                obj.doc_id = self._next_doc_id
                self._next_doc_id += 1
            doc_ids: list[int] = []
            for obj in objs:
                winner = final[obj.uuid]
                if obj is not winner:
                    obj.doc_id = winner.doc_id
                doc_ids.append(winner.doc_id)
            for uuid, obj in final.items():
                prev = self.ids.get(uuid.encode())
                if prev is not None:
                    # update == new docid, old one tombstoned (reference
                    # updates reuse uuid but bump docid)
                    old_docids.append(_DOCID.unpack(prev)[0])
            self._persist_counter()
            # delta-log the adds BEFORE the object writes: a logged docid
            # whose object bytes never landed replays as a no-op, while an
            # unlogged object would silently skip indexing after a crash
            self._seq += 1
            self._delta.append(msgpack.packb(
                {"s": self._seq, "o": "a",
                 "d": [o.doc_id for o in final.values()]},
                use_bin_type=True))
            self._delta.flush_soft()  # never let objects get durable first

            batches: dict[str, tuple[list[int], list[np.ndarray]]] = {}
            # bucket writes accumulate across the batch: one put_many /
            # roaring_add / postings_put per (prop, key) instead of per
            # object (segmented mode batches everything; RAM mode ranges)
            with self.inverted.batched_writes():
                for obj in final.values():
                    self._mark_live(obj.doc_id)
                    self.ids.put(obj.uuid.encode(),
                                 _DOCID.pack(obj.doc_id))
                    self.objects.put(_DOCID.pack(obj.doc_id),
                                     obj.to_bytes())
                    self.inverted.add_object(obj)
                    self.filter_planes.on_put(obj.doc_id, obj.properties)
                    if obj.vector is not None:
                        b = batches.setdefault(DEFAULT_VECTOR, ([], []))
                        b[0].append(obj.doc_id)
                        b[1].append(np.asarray(obj.vector, np.float32))
                    for nm, v in obj.named_vectors.items():
                        b = batches.setdefault(nm, ([], []))
                        b[0].append(obj.doc_id)
                        b[1].append(np.asarray(v, np.float32))

            if old_docids:
                deferred_deletes = self._delete_docids_durable(old_docids)

            for nm, (ids, vecs) in batches.items():
                id_arr = np.asarray(ids, np.int64)
                if self._config_for(nm).index_type == "multivector":
                    # ragged token sets can't ride the disk queue (it
                    # stores [n, D]); they feed synchronously AFTER the
                    # lock instead
                    ragged.append((nm, id_arr, vecs))
                else:
                    # durable chunk push — a disk write, part of the
                    # durability section; the device feed happens in the
                    # drain below, outside the lock
                    pushed.append(self.async_queue.push(
                        nm, id_arr, np.stack(vecs)))
            self._live_count += len(final)
            self._defer_ops += 1
        try:
            # durability ack barrier (group commit): ONE fsync per WAL
            # covering the whole batch, not one per record — a no-op in
            # non-sync mode
            if self._delta.group:
                self._delta.sync_window()
                self.store.sync_all()
            if ragged:
                # ragged sets bypass the queue but are still ingest work:
                # same batch-group token as the drain (never coalesces
                # with a live search batch) and same apply barrier, so
                # demote/promote_device's "no feed interleaves with the
                # array move" guarantee covers this path too
                from weaviate_tpu_torch.index.dispatch import dispatch_group

                with dispatch_group(("ingest",)), \
                        self.async_queue.apply_barrier():
                    for nm, id_arr, vecs in ragged:
                        idx = self._index_for(
                            nm, int(np.asarray(vecs[0]).shape[-1]))
                        _feed_index(idx, id_arr, vecs)
            if deferred_deletes is not None:
                self._apply_index_deletes(deferred_deletes)
        finally:
            with self._lock:
                self._defer_ops -= 1
        if pushed and not self._fully_async:
            # inline mode: drain our own chunks (read-your-writes) — other
            # writers' chunks coalesce into the same drain windows
            self.async_queue.ensure_drained(pushed)
        self._maybe_upgrade_inverted()
        return doc_ids

    def _delete_docids_durable(self, doc_ids: list[int]) -> np.ndarray:
        """Durable half of a delete (caller holds the shard lock):
        delta-log, inverted + object-store removal, liveness flip. The
        device-index removal is deferred to :meth:`_apply_index_deletes`
        OUTSIDE the lock."""
        self._seq += 1
        self._delta.append(msgpack.packb(
            {"s": self._seq, "o": "d", "d": [int(d) for d in doc_ids]},
            use_bin_type=True))
        self._delta.flush_soft()
        for d in doc_ids:
            raw = self.objects.get(_DOCID.pack(d))
            if raw is not None:
                old = StorageObject.from_bytes(raw)
                self.inverted.delete_object(old)
                self.filter_planes.on_delete(d)
                self.objects.delete(_DOCID.pack(d))
                self._mark_live(d, False)
                self._live_count -= 1
        return np.asarray(doc_ids, np.int64)

    def _apply_index_deletes(self, arr: np.ndarray) -> None:
        """Device-index half of a delete, outside the shard lock, ordered
        against the ingest drain via the queue's apply barrier: liveness
        flipped false (under the shard lock) BEFORE this runs, so any
        drain that liveness-checked the doc alive finishes first and the
        delete lands after its add; later drains see it dead and skip —
        either interleaving converges, resurrection is impossible."""
        with self.async_queue.apply_barrier():
            for idx in self._vector_indexes.values():
                idx.delete(arr)

    def _require_open(self) -> None:
        """Caller holds ``self._lock``. A shard the tiering controller
        released (closed to the cold tier) must bounce late writers to
        the retry path — they re-resolve the re-opened shard instead of
        mutating a closed store."""
        if self._tier_released:
            from weaviate_tpu_torch.compression.store import ResidencyMoved

            raise ResidencyMoved(
                f"shard {self.name!r} was released to the cold tier; "
                "re-route to the re-opened shard")

    def delete(self, uuids: list[str]) -> int:
        """Delete by uuid; returns number actually removed. Same staging
        as put_batch: durability under the lock, index removal after."""
        arr: Optional[np.ndarray] = None
        with self._lock:
            self._require_open()
            doc_ids = []
            for u in uuids:
                key = u.encode()
                prev = self.ids.get(key)
                if prev is None:
                    continue
                doc_ids.append(_DOCID.unpack(prev)[0])
                self.ids.delete(key)
            if doc_ids:
                arr = self._delete_docids_durable(doc_ids)
                self._defer_ops += 1
        if arr is not None:
            try:
                if self._delta.group:
                    self._delta.sync_window()
                    self.store.sync_all()
                self._apply_index_deletes(arr)
            finally:
                with self._lock:
                    self._defer_ops -= 1
        return len(doc_ids)

    # -- read path --------------------------------------------------------
    def get_by_uuid(self, uuid: str) -> Optional[StorageObject]:
        prev = self.ids.get(uuid.encode())
        if prev is None:
            return None
        return self.get_by_docid(_DOCID.unpack(prev)[0])

    def get_by_docid(self, doc_id: int) -> Optional[StorageObject]:
        raw = self.objects.get(_DOCID.pack(doc_id))
        return None if raw is None else StorageObject.from_bytes(raw)

    def exists(self, uuid: str) -> bool:
        return self.ids.get(uuid.encode()) is not None

    def count(self) -> int:
        return self._live_count

    def _mark_live(self, doc_id: int, value: bool = True) -> None:
        if doc_id >= self._live.shape[0]:
            grown = np.zeros(max(doc_id + 1, 2 * self._live.shape[0]), bool)
            grown[: self._live.shape[0]] = self._live
            self._live = grown
        self._live[doc_id] = value

    def live_mask(self, space: int) -> np.ndarray:
        """Bool mask over the docid space marking live (non-deleted) docs.

        A persistent array maintained on insert/delete — a snapshot read is
        safe against concurrent writers (same torn-read semantics the
        reference accepts for searches racing inserts).
        """
        live = self._live  # snapshot: resize swaps the reference atomically
        m = np.zeros(space, bool)
        n = min(space, live.shape[0])
        m[:n] = live[:n]
        return m

    def allow_list(self, flt, space: Optional[int] = None) -> np.ndarray:
        """Filter → liveness-correct allow mask (handles Not/IsNull right)."""
        space = space if space is not None else max(self._next_doc_id, 1)
        return self.inverted.allow_list(flt, space) & self.live_mask(space)

    def vector_search(
        self,
        queries: np.ndarray,
        k: int,
        target: str = DEFAULT_VECTOR,
        allow_list: Optional[np.ndarray] = None,
        max_distance: Optional[float] = None,
        rerank=None,
        est_selectivity: Optional[float] = None,
    ) -> SearchResult:
        """``allow_list`` is an ndarray mask or a resident FilterPlane;
        routes that can't consume a plane resolve its host bitmap here."""
        idx = self._vector_indexes.get(target)
        if idx is None:
            b = np.atleast_2d(queries).shape[0]
            return SearchResult(
                ids=np.full((b, k), -1, np.int64),
                dists=np.full((b, k), np.inf, np.float32),
            )
        from weaviate_tpu_torch.monitoring.metrics import TIER_SEARCHES

        # residency-tier attribution (tiering/): device = HBM-resident
        # arrays, host = the warm tier's exact fallback executor
        TIER_SEARCHES.inc(
            tier="device" if idx.device_resident else "host")
        if allow_list is not None \
                and getattr(allow_list, "plane_id", None) is not None \
                and (idx.multi_vector or max_distance is not None
                     or not getattr(idx, "supports_filter_planes", False)):
            # only the plain graph search consumes planes natively; every
            # other route gets the plane's host bitmap
            allow_list = allow_list.mask(max(self._next_doc_id, 1))
        if idx.multi_vector:
            # a [Tq, D] matrix is ONE late-interaction query (token set),
            # not a Tq-query batch; max_distance bounds the negated
            # MaxSim. The fused rerank stage is built in (search_multi
            # runs FDE scan + module score as one dispatch).
            res = idx.search_multi(queries, k, allow_list)
            if max_distance is not None:
                keep = res.dists <= max_distance
                res = SearchResult(ids=np.where(keep, res.ids, -1),
                                   dists=np.where(keep, res.dists, np.inf))
            return res
        if rerank is not None:
            # fused device rerank (modules/device/): only indexes with a
            # configured module accept the kwarg — the explorer routes
            # here only after checking the target's config
            if max_distance is not None:
                raise ValueError(
                    "rerank and max_distance cannot combine: reranked "
                    "distances are negated module scores, not metric "
                    "distances a bound could apply to")
            return idx.search(queries, k, allow_list, rerank=rerank,
                              est_selectivity=est_selectivity)
        if max_distance is not None:
            return idx.search_by_distance(queries, max_distance, allow_list, limit=k)
        return idx.search(queries, k, allow_list,
                          est_selectivity=est_selectivity)

    def objects_by_docids(self, doc_ids: np.ndarray) -> list[Optional[StorageObject]]:
        return [self.get_by_docid(int(d)) if d >= 0 else None for d in doc_ids]

    # -- multi-target serving (docs/multitarget.md) ------------------------
    def multi_target_device_eligible(self, targets: tuple[str, ...]) -> bool:
        """Every target has an index that walks on the card now (a fused
        walk, device-resident). The batch runner checks again at the
        drain and raises ``MultiTargetIneligible`` when that changed."""
        if len(targets) < 2:
            return False
        for t in targets:
            idx = self._vector_indexes.get(t)
            if idx is None or getattr(idx, "multi_walk_inputs", None) is None:
                return False
            if getattr(idx, "_device_beam", None) is None \
                    or not idx.device_resident:
                return False
        return True

    def _mt_dispatcher(self, targets: tuple[str, ...], join: str):
        key = (targets, join)
        disp = self._mt_dispatchers.get(key)
        if disp is None:
            with self._build_lock:
                disp = self._mt_dispatchers.get(key)
                if disp is None:
                    from weaviate_tpu_torch.index.dispatch import (
                        CoalescingDispatcher,
                    )

                    def run(q, k, allow, _t=targets, _j=join):
                        return self._run_multi_batch(_t, _j, q, k, allow)

                    disp = CoalescingDispatcher(run)
                    self._mt_dispatchers = {**self._mt_dispatchers,
                                            key: disp}
        return disp

    def multi_target_search(
        self,
        vectors: dict[str, np.ndarray],
        k: int,
        combination: str,
        weights: Optional[dict[str, float]] = None,
        allow_list=None,
    ) -> SearchResult:
        """Multi-target search on the card: the per-target query tuple
        (weight rows first; they share the batch dimension) goes into the
        target set's coalescing dispatcher, whose drain leader runs every
        coalesced request as one search (one B2 launch a target, then one
        B7b launch). A failed launch raises; a target that cannot walk on
        the card raises ``MultiTargetIneligible``."""
        from weaviate_tpu_torch.index.dispatch import dispatch_group
        from weaviate_tpu_torch.query.multi_target import (
            join_mode,
            weight_row,
        )

        targets = tuple(vectors.keys())
        join = join_mode(combination)
        w = weight_row(list(targets), combination, weights)[None, :]
        qs = tuple(np.atleast_2d(np.asarray(vectors[t], np.float32))
                   for t in targets)
        tier_key = tuple(
            (getattr(self._vector_indexes.get(t), "_residency_epoch", 0), 0)
            for t in targets)
        disp = self._mt_dispatcher(targets, join)
        with dispatch_group(("multitarget", targets, join)):
            ids, dists = disp.search(
                (w.astype(np.float32),) + qs, k, allow=allow_list,
                tier_key=tier_key)
        return SearchResult(ids=ids, dists=dists)

    def _run_multi_batch(self, targets: tuple[str, ...], join: str,
                         q_tuple: tuple, k: int, allow_list):
        """Drain leader body: one walk leg per target, run as one search
        (``_dispatch_multi_legs``), then the host sweep of deleted docids
        and the cut to k."""
        from weaviate_tpu_torch.monitoring.metrics import MULTITARGET_FALLBACK

        weights = q_tuple[0]
        qs = q_tuple[1:]
        b = weights.shape[0]
        # the leader derives one joint expansion budget from the group's
        # shared mask (the single-target leader's rule)
        expand = 0
        idx0 = self._vector_indexes.get(targets[0])
        if allow_list is not None and idx0 is not None:
            from weaviate_tpu_torch.query.planner import expansion_budget

            n_allowed = idx0._allow_popcount(allow_list)
            expand = expansion_budget(n_allowed / max(1, idx0.count()))
        legs = []
        for t, q in zip(targets, qs):
            idx = self._vector_indexes.get(t)
            leg = None
            if idx is not None and getattr(idx, "multi_walk_inputs", None):
                # the walks are independent: no padding of the batch
                leg = idx.multi_walk_inputs(
                    q, k, b, allow_list=allow_list, expand=expand)
            if leg is None:
                MULTITARGET_FALLBACK.inc(mode="ineligible")
                raise MultiTargetIneligible(
                    f"target {t!r} cannot walk on the card")
            legs.append(leg)
        ids, d = self._dispatch_multi_legs(legs, weights, k, join)
        # host sweep: deleted/tombstoned docids stay traversable on the
        # card; a doc must be live in EVERY target's graph (and allowed)
        # to surface, the oracle's drop semantics
        ok = ids >= 0
        for t in targets:
            km = self._vector_indexes.get(t)._keep_mask(allow_list)
            ok &= np.where(
                ids < len(km), km[np.clip(ids, 0, len(km) - 1)], False)
        d = np.where(ok, d, np.float32(np.inf))
        ids = np.where(ok, ids, -1)
        order = np.argsort(d, axis=1, kind="stable")[:, :k]
        d = np.take_along_axis(d, order, axis=1)
        ids = np.take_along_axis(ids, order, axis=1)
        if d.shape[1] < k:
            pad = k - d.shape[1]
            d = np.pad(d, ((0, 0), (0, pad)), constant_values=np.inf)
            ids = np.pad(ids, ((0, 0), (0, pad)), constant_values=-1)
        return ids.astype(np.int64), d.astype(np.float32)

    def _dispatch_multi_legs(self, legs, weights, k: int, join: str):
        """One multi-target search over an assembled leg set."""
        import time

        from weaviate_tpu_torch.monitoring import tracing
        from weaviate_tpu_torch.ops import device_beam as db

        fetch = min((leg["keep_k"] if leg["keep_k"] > 0 else leg["ef_pad"])
                    for leg in legs)
        max_steps = max(int(4 * leg["ef_pad"] + 64) for leg in legs)
        t_dev = time.perf_counter()
        ids, d = db.device_multi_search(
            scorers=tuple(leg["scorer"] for leg in legs),
            weights=np.asarray(weights, np.float32),
            queries=tuple(leg["q"] for leg in legs),
            operands=tuple(leg["operands"] for leg in legs),
            adjacency=tuple(leg["adj"] for leg in legs),
            present=tuple(leg["present"] for leg in legs),
            eps=tuple(leg["eps"] for leg in legs),
            upper_adjs=tuple(leg["upper_adj"] for leg in legs),
            upper_slots=tuple(leg["upper_slots"] for leg in legs),
            efs=tuple(leg["ef_pad"] for leg in legs),
            max_steps=max_steps, fetch=fetch, join=join,
            allows=tuple(leg["allow"] for leg in legs),
            keep_ks=tuple(leg["keep_k"] for leg in legs),
            expands=tuple(leg["expand"] for leg in legs))
        ids = ids.cpu().numpy().astype(np.int64)
        d = d.cpu().numpy()
        # the copy above is the completion sync
        tracing.annotate(
            device_execute_ms=round((time.perf_counter() - t_dev) * 1000, 3),
            scorer=f"multi:{join}", mesh_mode="single")
        return ids, d

    # -- tiered residency (docs/tiering.md) --------------------------------
    def hbm_bytes(self) -> int:
        """Current HBM rent of every vector index this shard owns, plus
        the resident filter planes' device mirrors — planes are charged
        to the same tiering ledger as the arrays they filter."""
        from weaviate_tpu_torch.monitoring.metrics import FILTER_PLANE_HBM_BYTES

        plane_bytes = self.filter_planes.hbm_bytes()
        FILTER_PLANE_HBM_BYTES.set(plane_bytes, shard=self.name)
        from weaviate_tpu_torch.monitoring.metrics import TARGET_PLANE_HBM_BYTES

        with self._lock:
            total = plane_bytes
            for tgt, idx in self._vector_indexes.items():
                n = idx.hbm_bytes()
                # per-target plane rent: each named vector's arrays +
                # topology mirror charge the ledger independently
                TARGET_PLANE_HBM_BYTES.set(
                    n, shard=self.name, target=tgt or "default")
                total += n
            return total

    def host_tier_bytes(self) -> int:
        with self._lock:
            return sum(idx.host_tier_bytes()
                       for idx in self._vector_indexes.values())

    def device_resident(self) -> bool:
        """Whether every demotable index is on device (an all-host-tier
        shard — e.g. no vector indexes yet — counts as resident: there is
        nothing to promote)."""
        with self._lock:
            return all(idx.device_resident
                       for idx in self._vector_indexes.values())

    def demote_device(self) -> int:
        """Warm demotion of every vector index; returns total HBM bytes
        released (the caller feeds this to the tiering accountant). Held
        under the shard lock AND the drain apply barrier so neither a
        concurrent put's durability section nor an in-flight ingest drain
        can interleave with the array move."""
        with self._lock:
            with self.async_queue.apply_barrier():
                # plane mirrors detach with the arrays they filter (the
                # host bitmap stays — re-promotion re-uploads lazily at
                # the next filtered query, symmetric by construction)
                freed = self.filter_planes.drop_device()
                from weaviate_tpu_torch.monitoring.metrics import (
                    FILTER_PLANE_HBM_BYTES,
                )

                FILTER_PLANE_HBM_BYTES.set(0, shard=self.name)
                return freed + sum(idx.demote_device()
                                   for idx in self._vector_indexes.values())

    def promote_device(self) -> int:
        with self._lock:
            with self.async_queue.apply_barrier():
                return sum(idx.promote_device()
                           for idx in self._vector_indexes.values())

    # -- lifecycle --------------------------------------------------------
    def flush(self) -> None:
        if self.async_queue is not None:
            self.async_queue.flush()
        # delta log first: the recovery invariant is log-durable-before-
        # objects-durable (a logged docid without object bytes replays as a
        # no-op; the reverse silently skips indexing)
        self._delta.flush()
        self.store.flush_all()
        self._persist_counter()
        self._persist_meta()
        for idx in self._vector_indexes.values():
            idx.flush()

    def close(self) -> None:
        if self.async_queue is not None:
            self.async_queue.stop()
        # an in-flight tier migration must not outlive the store it reads:
        # cancel cooperatively and join (the next boot simply retries; its
        # bucket re-adds are idempotent)
        self._stop_migration()
        self.flush()
        self.checkpoint()
        self._delta.close()
        for idx in self._vector_indexes.values():
            if hasattr(idx, "close"):
                idx.close()
        self.store.close()

    # -- auto inverted-tier upgrade ---------------------------------------
    def _maybe_upgrade_inverted(self) -> None:
        """storage="auto": past segment_cutoff live docs, migrate the RAM
        inverted index to the segment tier in the background (the same
        grow-up move the dynamic vector index makes flat->HNSW). Writes
        keep flowing during the bulk stream; the delta log replays the
        stream window under the lock before the atomic swap."""
        cfg = self.config.inverted_config
        with self._lock:
            if getattr(cfg, "storage", "ram") != "auto" or self._migrating \
                    or getattr(self.inverted, "segmented", False) \
                    or self._live_count < getattr(cfg, "segment_cutoff",
                                                  1 << 62):
                return
            self._migrating = True
            self._migrate_cancel = False
        self._migrate_thread = threading.Thread(
            target=self._upgrade_inverted, daemon=True)
        self._migrate_thread.start()

    def _stop_migration(self, timeout: float = 30.0) -> None:
        """Cooperatively cancel an in-flight tier migration and wait for
        the worker to exit (close()/reindex need exclusive ownership of
        the inverted index and the store)."""
        t = getattr(self, "_migrate_thread", None)
        if t is None or not t.is_alive():
            return
        self._migrate_cancel = True
        t.join(timeout=timeout)
        if t.is_alive():
            import logging

            logging.getLogger("weaviate_tpu_torch.shard").warning(
                "tier migration did not stop within %.0fs", timeout)

    def _upgrade_inverted(self) -> None:
        from weaviate_tpu_torch.inverted.segmented import SegmentedInvertedIndex
        from weaviate_tpu_torch.storage.wal import WAL

        try:
            with self._lock:  # serialize with any in-flight checkpoint
                start_seq = self._seq
            fresh = SegmentedInvertedIndex(self.config, self.store)
            fresh.ref_resolver = self.inverted.ref_resolver
            # phase 1: lock-free bulk stream of the object store (docid
            # bytes are immutable once written; concurrent writes land in
            # the delta log and are replayed in phase 2). Bucket re-adds
            # are idempotent, so a crash-interrupted earlier attempt only
            # costs wasted work, never wrong rows. CHUNKED batched_writes:
            # one shard-wide pending buffer would rebuild the whole index
            # in RAM — the exact thing the migration exists to end.
            chunk, pending = 20_000, 0
            ctx = fresh.batched_writes()
            ctx.__enter__()
            try:
                for _key, raw in self.objects.items():
                    if self._migrate_cancel:
                        return  # abandoned (close/reindex); no swap
                    obj = StorageObject.from_bytes(raw)
                    if obj.doc_id < len(self._live) \
                            and self._live[obj.doc_id]:
                        fresh.add_object(obj)
                        pending += 1
                        if pending >= chunk:
                            ctx.__exit__(None, None, None)
                            ctx = fresh.batched_writes()
                            ctx.__enter__()
                            pending = 0
            finally:
                ctx.__exit__(None, None, None)
            # phase 2: catch up + swap under the write lock. checkpoint()
            # is suppressed while migrating (it truncates the delta log
            # this replay depends on). The propvals row marks docs phase 1
            # already indexed, so re-applying their add is skipped and the
            # RAM counters (doc_count/avgdl) can't double-count.
            with self._lock:
                if self._migrate_cancel:
                    return
                for payload in WAL.replay(self._delta_path):
                    rec = msgpack.unpackb(payload, raw=False)
                    if rec["s"] <= start_seq:
                        continue
                    if rec["o"] == "a":
                        for d in rec["d"]:
                            raw = self.objects.get(_DOCID.pack(d))
                            if raw is None or not (d < len(self._live)
                                                   and self._live[d]):
                                continue
                            if fresh._propvals_get(d) is not None:
                                continue  # streamed by phase 1 already
                            fresh.add_object(StorageObject.from_bytes(raw))
                    else:
                        for d in rec["d"]:
                            fresh.delete_docid(d)
                self.inverted = fresh
        finally:
            self._migrating = False

    def reindex_inverted(self) -> int:
        """Rebuild the inverted index (+filter columns) from stored objects.

        Reference ``adapters/repos/db/inverted_reindexer.go``: run after a
        tokenization/schema change that invalidates existing postings. RAM
        mode swaps the rebuilt index in atomically (searches during the
        rebuild keep using the old postings); segmented mode must truncate
        the shared buckets first, so racing queries get a retriable
        ShardClosed for the rebuild window instead. The next checkpoint
        persists the new state. Returns objects reindexed."""
        # a racing tier migration would swap stale-tokenization postings
        # over the rebuilt index — stop it first (it reruns on next write)
        self._stop_migration()
        with self._lock:
            was_segmented = getattr(self.inverted, "segmented", False)
            if was_segmented:
                # segmented state lives in shared buckets: mark the live
                # index superseded (queries racing the rebuild raise a
                # retriable ShardClosed rather than reading recreated-empty
                # buckets), then truncate so stale-tokenization rows can't
                # survive (map merges would resurrect them). The RAM path's
                # atomic swap does not apply to segmented mode.
                self.inverted._closed = True
                for name in os.listdir(self.store.dir):
                    if name.startswith(("inv_", "post_", "range_")) \
                            or name == "propvals":
                        self.store.drop_bucket(name)
                # rebuild into the tier the shard had reached — an "auto"
                # shard that upgraded must not silently downgrade here
                from weaviate_tpu_torch.inverted.segmented import (
                    SegmentedInvertedIndex,
                )

                fresh = SegmentedInvertedIndex(self.config, self.store)
            else:
                fresh = make_inverted_index(self.config, self.store)
            # collection-attached hooks must carry over: a fresh index
            # without the ref_resolver would fail every reference filter
            # until the shard reopens
            fresh.ref_resolver = self.inverted.ref_resolver
            n = 0
            for _key, raw in self.objects.items():
                obj = StorageObject.from_bytes(raw)
                if obj.doc_id < len(self._live) and self._live[obj.doc_id]:
                    fresh.add_object(obj)
                    n += 1
            self.inverted = fresh
            return n

    def expire_ttl(self, cutoff_ms: int) -> int:
        """Delete objects created before the cutoff (reference object TTL)."""
        victims = []
        for _key, raw in self.objects.items():
            obj = StorageObject.from_bytes(raw)
            if obj.creation_time_ms < cutoff_ms:
                victims.append(obj.uuid)
        return self.delete(victims) if victims else 0

    def stats(self) -> dict:
        return {
            "name": self.name,
            "objects": self.count(),
            "next_doc_id": self._next_doc_id,
            "hbm_bytes": self.hbm_bytes(),
            "host_tier_bytes": self.host_tier_bytes(),
            "vector_indexes": {
                nm: idx.stats() for nm, idx in self._vector_indexes.items()
            },
            "filter_planes": self.filter_planes.stats(),
        }
