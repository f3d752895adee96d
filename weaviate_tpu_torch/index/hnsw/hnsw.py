"""HNSW with batched device distance evaluation (port of
``weaviate_tpu/index/hnsw/hnsw.py``, raw-corpus backend, one device).

Reference: ``adapters/repos/db/vector/hnsw`` (``index.go:43``,
``insert.go:107`` AddBatch, ``search.go:78`` SearchByVector, ``:726`` hot
loop, ``heuristic.go:23`` neighbor selection, ``delete.go`` tombstones).

The graph and the construction control flow stay on the host; every
distance evaluation is a batched device call. A batch of queries advances
through the graph in lockstep. Construction is batched the same way: a
sub-batch of inserts runs its ef_construction searches in lockstep (the
upper levels on the host walk, layer 0 in the fused kernel when
``device_beam`` is on), and the selection heuristic runs for all nodes of a
level at once from one padded ``[G, C, C]`` distance block.

Serving: with ``device_beam`` on, a search batch is one launch of the fused
walk (``ops/device_beam.py``), filtered or not, for as many rows as their
visited bitsets fit ``_VISITED_BUDGET``; otherwise the host walk
(``_search_level``) pays one device call per hop. ``device_beam`` is read
from the config only. A failed launch raises: there is no latch and no
fallback to the host walk.

A configured quantizer (BQ, SQ, PQ or RQ) swaps the whole distance tier to
code space (``QuantizedBackend``): the walks score the device code planes,
the host rescores exactly against the originals, and the trained quantizer
state (PQ's codebooks and RQ's rotation included) persists beside the graph
(``quantizer.msgpack``). A configured rerank module
(``HNSWIndexConfig.rerank``) adds the rerank tier: token planes beside the
corpus (``modules/device/store.py``; each vector its own 1-token set until
``set_tokens`` registers real ones), and ``search(rerank=RerankRequest)``
rescoring the walk's candidates with the module, on the card one B7a launch
after the walk's B2 launch on the same stream. ``multi_walk_inputs`` hands
one target's walk to a shard's multi-target search. The mesh graph and walk
(slice 11) are not ported. The fused walk's rows per launch follow
its bitset, not the JAX index's [B, capacity] scratch; the walks are
independent, so the results are the same. Device-time attribution waits for
the serving slice; the ``device_execute_ms`` trace attribute stays.
"""

from __future__ import annotations

import math
import os
import threading
import time
from typing import Optional

import numpy as np
import torch

from weaviate_tpu_torch.index.base import SearchResult, VectorIndex
from weaviate_tpu_torch.index.hnsw.backend import QuantizedBackend, RawBackend
from weaviate_tpu_torch.index.hnsw.graph import NO_NODE, HostGraph
from weaviate_tpu_torch.index.store import DeviceVectorStore
from weaviate_tpu_torch.schema.config import HNSWIndexConfig

_INF = np.float32(np.inf)

# cap on a walk's visited scratch: the host walk's [B, capacity] bool (the
# JAX index's split), the fused walk's [B, capacity / 32] uint32 bitset
_VISITED_BUDGET = 256 << 20


def _pow2_pad(n: int) -> int:
    return 1 << max(3, (n - 1).bit_length())


def _walk_rows(capacity: int) -> int:
    """Rows of one fused-walk launch: as many visited bitsets of
    ``capacity`` bits as fit ``_VISITED_BUDGET``."""
    return max(1, _VISITED_BUDGET // (4 * ((max(1, capacity) + 31) // 32)))


def _ef_pad(ef: int) -> int:
    """The pow2 beam width the fused walk runs at (at least 16)."""
    return 1 << max(4, (int(ef) - 1).bit_length())


def _max_steps(ef_pad: int) -> int:
    return int(4 * ef_pad + 64)


def _accept_loop(pair: torch.Tensor, d_p: torch.Tensor, m: int) -> torch.Tensor:
    """The selection heuristic's greedy accept loop, on the device that holds
    the [G, C, C] candidate distances, so only the [G, C] choice crosses to
    the host. Each of m rounds picks, per row, the nearest eligible
    candidate (first index on ties): one closer to the node than to every
    candidate already chosen. The JAX index runs the same rounds in numpy
    and stops once no row picks; a round with no pick changes nothing, so
    running all m gives the same choice."""
    g, c = d_p.shape
    dev = d_p.device
    rows = torch.arange(g, device=dev)
    chosen = torch.zeros((g, c), dtype=torch.bool, device=dev)
    min_to_sel = torch.full((g, c), float("inf"), device=dev)
    finite = torch.isfinite(d_p)
    for _ in range(m):
        elig = (d_p < min_to_sel) & ~chosen & finite
        pick = torch.argmin(torch.where(elig, d_p, float("inf")), dim=1)
        ok = elig[rows, pick]
        chosen[rows, pick] |= ok
        upd = pair[rows, :, pick]  # dist of every candidate to the new pick
        min_to_sel = torch.where(ok[:, None], torch.minimum(min_to_sel, upd),
                                 min_to_sel)
    return chosen


class HNSWIndex(VectorIndex):
    supports_filter_planes = True

    def __init__(
        self,
        dims: int,
        config: Optional[HNSWIndexConfig] = None,
        path: Optional[str] = None,
        store: Optional[DeviceVectorStore] = None,
        device=None,
    ):
        self.config = config or HNSWIndexConfig()
        self.metric = self.config.distance
        self.path = path
        # an existing store may be handed over (dynamic-index upgrade keeps
        # the corpus in device memory and only builds the graph); a
        # configured quantizer swaps the whole distance tier to code space
        quant = self.config.quantizer
        if store is None and quant is not None and quant.enabled:
            self.backend = QuantizedBackend(dims, self.config, device=device)
            self.store = None
        else:
            self.backend = RawBackend(dims, self.config, store=store,
                                      device=device)
            self.store = self.backend.store
        self.device = self.backend.device
        self.dims = dims
        self.graph = HostGraph(m=self.config.max_connections)
        self._ml = 1.0 / math.log(max(2, self.config.max_connections))
        self._level_rng = np.random.default_rng(0x5EED)
        self._insert_batch = self.config.insert_batch
        self._visited: Optional[np.ndarray] = None  # [B, cap] scratch
        # Batching is this index's throughput mechanism: concurrent
        # searches coalesce into one lockstep walk (dispatch.py); the
        # scratch lock is the search/construction exclusion point.
        from weaviate_tpu_torch.index.dispatch import CoalescingDispatcher

        self._scratch_lock = threading.Lock()
        # residency epoch: bumped on every demote/promote; the dispatcher
        # keys batch grouping on it so a request enqueued against one
        # residency generation never coalesces into a batch of another
        self._residency_epoch = 0
        self._dispatch = CoalescingDispatcher(self._run_search_batch)
        if path and os.path.exists(self._snapshot_path()):
            self._load_snapshot()
        if path:
            # incremental op log: graph edits since the last condensed
            # snapshot replay on open; condensing == flush() + truncate
            from weaviate_tpu_torch.index.hnsw.commitlog import HNSWCommitLog

            self._commitlog = HNSWCommitLog(os.path.join(path, "commitlog"))
            self._commitlog.replay_into(self.graph)
            self.graph.log = self._commitlog
        else:
            self._commitlog = None
        # the fused device walk, from the config alone; created after the
        # snapshot load and replay, which swap self.graph
        self._device_beam = None
        if self.config.device_beam:
            from weaviate_tpu_torch.ops.device_beam import DeviceAdjacency

            self._device_beam = DeviceAdjacency(self.graph, self.device)
            self.graph.dirty_hook = self._device_beam.mark_dirty
        # the rerank tier: a frozen module scores the walk's candidates
        # against token planes on the card; each vector defaults to its own
        # 1-token set (set_tokens registers late-interaction sets)
        self._rerank_module = None
        self._token_store = None
        rr_cfg = getattr(self.config, "rerank", None)
        if rr_cfg is not None and rr_cfg.enabled:
            from weaviate_tpu_torch.modules.device import (
                CandidateTokenStore,
                build_device_reranker,
            )

            self._rerank_module = build_device_reranker(
                rr_cfg.module, rr_cfg.params)
            self._token_store = CandidateTokenStore(
                dims, max_tokens=rr_cfg.max_tokens,
                cap_fn=self.backend.device_plane_capacity,
                device=self.device)

    # ------------------------------------------------------------------
    # persistence: the condensed graph (graph.npz) plus the commit log of
    # the edits since; vectors are durable in the object store
    # ------------------------------------------------------------------
    def _snapshot_path(self) -> str:
        return os.path.join(self.path, "graph.npz")

    def _quantizer_path(self) -> str:
        return os.path.join(self.path, "quantizer.msgpack")

    def flush(self) -> None:
        if not self.path:
            return
        os.makedirs(self.path, exist_ok=True)
        tmp = self._snapshot_path() + ".tmp.npz"
        np.savez_compressed(tmp, **self.graph.to_arrays())
        os.replace(tmp, self._snapshot_path())
        if self._commitlog is not None:
            # the snapshot condenses everything logged so far
            self._commitlog.truncate_after_snapshot()
        if self.backend.quantized and self.backend.quantizer.fitted:
            # the trained quantizer state, so a reopen re-encodes with the
            # same codes (the JAX package's format)
            import msgpack

            tmp = self._quantizer_path() + ".tmp"
            with open(tmp, "wb") as f:
                f.write(msgpack.packb(self.backend.quantizer.state_dict(),
                                      use_bin_type=True))
            os.replace(tmp, self._quantizer_path())

    def close(self) -> None:
        """Condense and release the commit log (a crash after this point
        replays nothing)."""
        self.flush()
        if self._commitlog is not None:
            self._commitlog.close()
            self._commitlog = None
            self.graph.log = None

    def _load_snapshot(self) -> None:
        with np.load(self._snapshot_path()) as z:
            self.graph = HostGraph.from_arrays({k: z[k] for k in z.files})
        if self.backend.quantized and os.path.exists(self._quantizer_path()):
            import msgpack

            with open(self._quantizer_path(), "rb") as f:
                self.backend.quantizer.load_state_dict(
                    msgpack.unpackb(f.read(), raw=False))

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------
    def _qdev(self, queries: np.ndarray) -> torch.Tensor:
        return self.backend.prep_queries(queries)

    def _frontier_dists(self, qdev, cand: np.ndarray) -> np.ndarray:
        """[B, C] candidate ids (-1 pad) -> [B, C] distances (inf for pads)."""
        return self.backend.frontier_dists(qdev, cand)

    def _node_dists(self, node_ids: np.ndarray, cand: np.ndarray) -> np.ndarray:
        """Distances from each node's own vector to its candidates [G, C]."""
        return self.backend.frontier_dists(
            self.backend.prep_query_ids(node_ids), cand
        )

    def _level_for_new(self, n: int) -> np.ndarray:
        u = self._level_rng.random(n)
        return np.minimum(
            (-np.log(np.maximum(u, 1e-12)) * self._ml).astype(np.int16), 30
        )

    # ------------------------------------------------------------------
    # batched greedy descent (upper layers, ef=1) — reference search.go:760
    # ------------------------------------------------------------------
    def _greedy_step_until_stable(self, qdev, eps: np.ndarray, level: int,
                                  active: np.ndarray) -> np.ndarray:
        cur = eps.copy()
        cur_d = self._frontier_dists(qdev, cur[:, None])[:, 0]
        live = active.copy()
        while live.any():
            # rows of live queries only; the others stay -1
            nbrs = np.full((len(cur), self.graph.width(level)), NO_NODE,
                           np.int32)
            nbrs[live] = self.graph.neighbors_batch(level, cur[live])
            d = self._frontier_dists(qdev, nbrs)
            j = np.argmin(d, axis=1)
            bd = d[np.arange(len(cur)), j]
            better = bd < cur_d
            upd = live & better
            cur[upd] = nbrs[np.arange(len(cur)), j][upd]
            cur_d[upd] = bd[upd]
            live = upd
        return cur

    # ------------------------------------------------------------------
    # batched beam search at one level — reference searchLayerByVector
    # (search.go:215); one device call per beam iteration for all queries
    # ------------------------------------------------------------------
    def _get_visited(self, b: int) -> np.ndarray:
        cap = self.graph.capacity
        if (
            self._visited is None
            or self._visited.shape[0] < b
            or self._visited.shape[1] < cap
        ):
            self._visited = np.zeros((b, cap), bool)
        return self._visited

    def _search_level(
        self,
        qdev,
        eps: np.ndarray,
        ef: int,
        level: int,
        keep_mask: Optional[np.ndarray] = None,
        keep_k: int = 0,
        expand: int = 0,
    ):
        """Returns (res_ids [B, ef], res_d [B, ef]) ascending, and, when
        ``keep_mask`` is given (sweeping filter strategy, search.go:36-41),
        (kept_ids [B, keep_k], kept_d [B, keep_k]): the best allowed nodes
        seen.

        The visited scratch is shared between searches (single-flight via
        the coalescing dispatcher) and construction beams; this lock
        serializes scratch use only. The graph itself is read without a
        lock (torn-read semantics, as in the reference's lock-free reads):
        nodes linked mid-search are skipped via the scratch-width clamp.
        """
        with self._scratch_lock:
            return self._search_level_impl(qdev, eps, ef, level, keep_mask,
                                           keep_k, expand)

    def _search_level_impl(self, qdev, eps, ef, level, keep_mask=None,
                           keep_k=0, expand=0):
        b = qdev.shape[0]
        rows = np.arange(b)
        # reusable visited scratch, cleared lazily via the touched log so a
        # search costs O(touched), not O(capacity)
        visited = self._get_visited(b)
        touched: list[tuple[np.ndarray, np.ndarray]] = []

        res_ids = np.full((b, ef), NO_NODE, np.int64)
        res_d = np.full((b, ef), _INF, np.float32)
        expanded = np.zeros((b, ef), bool)

        d0 = self._frontier_dists(qdev, eps[:, None])[:, 0]
        res_ids[:, 0] = eps
        res_d[:, 0] = d0
        visited[rows, eps] = True
        touched.append((rows.copy(), eps.astype(np.int64)))

        track_kept = keep_mask is not None and keep_k > 0
        if track_kept:
            kept_ids = np.full((b, keep_k), NO_NODE, np.int64)
            kept_d = np.full((b, keep_k), _INF, np.float32)
            seed_ok = keep_mask[eps]
            kept_ids[seed_ok, 0] = eps[seed_ok]
            kept_d[seed_ok, 0] = d0[seed_ok]

        max_iters = 4 * ef + 64  # safety bound; beam converges well before
        for _ in range(max_iters):
            cand_d = np.where(expanded | (res_ids < 0), _INF, res_d)
            j = np.argmin(cand_d, axis=1)
            cd = cand_d[rows, j]
            # stop per query when closest unexpanded is worse than the
            # current ef-th best (res_d sorted ascending, inf-padded)
            active = np.isfinite(cd) & (cd <= res_d[:, -1])
            if not active.any():
                break
            expanded[rows[active], j[active]] = True
            cur = res_ids[rows, j].astype(np.int64)
            nbrs = np.full((b, self.graph.width(level)), NO_NODE, np.int64)
            nbrs[active] = self.graph.neighbors_batch(level, cur[active])
            # a concurrent insert may have linked nodes past this scratch's
            # width; skip them — they were not visible when this search
            # started
            nbrs[nbrs >= visited.shape[1]] = NO_NODE
            rr = np.repeat(rows, nbrs.shape[1]).reshape(nbrs.shape)
            fresh = nbrs >= 0
            fresh[fresh] = ~visited[rr[fresh], nbrs[fresh]]
            nbrs = np.where(fresh, nbrs, NO_NODE)
            sel = nbrs >= 0
            if sel.any():
                visited[rr[sel], nbrs[sel]] = True
                touched.append((rr[sel], nbrs[sel]))
            nd = self._frontier_dists(qdev, nbrs)

            if track_kept and expand > 0:
                # ACORN two-hop widening: the `expand` closest blocked
                # neighbors expand through to their own adjacency rows in
                # the same step, with in-row first-occurrence dedup
                blocked_d = np.where(
                    (nbrs >= 0) & ~keep_mask[np.maximum(nbrs, 0)],
                    nd, _INF)
                psel = np.argsort(blocked_d, axis=1,
                                  kind="stable")[:, :expand]
                parents = np.take_along_axis(nbrs, psel, 1)
                pvalid = np.take_along_axis(blocked_d, psel, 1) < _INF
                hop2 = self.graph.neighbors_batch(
                    level, np.maximum(parents, 0).reshape(-1)
                ).astype(np.int64).reshape(b, parents.shape[1], -1)
                hop2[~pvalid] = NO_NODE
                hop2 = hop2.reshape(b, -1)
                eq = hop2[:, :, None] == hop2[:, None, :]
                first = (np.argmax(eq, axis=2)
                         == np.arange(hop2.shape[1])[None, :])
                hop2[~first] = NO_NODE
                hop2[hop2 >= visited.shape[1]] = NO_NODE
                rr2 = np.repeat(rows, hop2.shape[1]).reshape(hop2.shape)
                fresh2 = hop2 >= 0
                fresh2[fresh2] = ~visited[rr2[fresh2], hop2[fresh2]]
                hop2 = np.where(fresh2, hop2, NO_NODE)
                sel2 = hop2 >= 0
                if sel2.any():
                    visited[rr2[sel2], hop2[sel2]] = True
                    touched.append((rr2[sel2], hop2[sel2]))
                nd2 = self._frontier_dists(qdev, hop2)
                nbrs = np.concatenate([nbrs, hop2], axis=1)
                nd = np.concatenate([nd, nd2], axis=1)

            all_ids = np.concatenate([res_ids, nbrs], axis=1)
            all_d = np.concatenate([res_d, nd], axis=1)
            all_exp = np.concatenate(
                [expanded, np.zeros_like(nbrs, bool)], axis=1
            )
            order = np.argsort(all_d, axis=1, kind="stable")[:, :ef]
            res_ids = np.take_along_axis(all_ids, order, 1)
            res_d = np.take_along_axis(all_d, order, 1)
            expanded = np.take_along_axis(all_exp, order, 1)

            if track_kept:
                ok = (nbrs >= 0) & keep_mask[np.maximum(nbrs, 0)]
                nd_k = np.where(ok, nd, _INF)
                ka = np.concatenate([kept_ids, nbrs], axis=1)
                kd = np.concatenate([kept_d, nd_k], axis=1)
                korder = np.argsort(kd, axis=1, kind="stable")[:, :keep_k]
                kept_ids = np.take_along_axis(ka, korder, 1)
                kept_d = np.take_along_axis(kd, korder, 1)

        for r, n in touched:
            visited[r, n] = False

        if track_kept:
            kept_ids[~np.isfinite(kept_d)] = NO_NODE
            return res_ids, res_d, kept_ids, kept_d
        return res_ids, res_d

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------
    def add_batch(self, doc_ids: np.ndarray, vectors: np.ndarray) -> None:
        doc_ids = np.asarray(doc_ids, np.int64)
        vectors = np.asarray(vectors, np.float32)
        if len(doc_ids) == 0:
            return
        self.backend.put(doc_ids, vectors)
        if self._token_store is not None:
            # default token sets: the vector itself, one [m, 1, D] block
            self._token_store.put(doc_ids, vectors[:, None, :])
        self.graph.ensure_capacity(int(doc_ids.max()) + 1)
        # a re-added tombstoned id is a fresh vector at an old id: drop the
        # stale node so it re-inserts with edges for the new vector
        revived = [int(d) for d in doc_ids if int(d) in self.graph.tombstones]
        for d in revived:
            self.graph.remove_node_hard(d)
        # skip ids already present (idempotent rebuild/recovery path)
        doc_ids = doc_ids[self.graph.levels[doc_ids] < 0]
        for start in range(0, len(doc_ids), self._insert_batch):
            self._insert_subbatch(doc_ids[start : start + self._insert_batch])
        if self._commitlog is not None:
            self._commitlog.flush_soft()
            # condense once the op window outgrows the snapshot cost
            if self._commitlog.pending_bytes > (64 << 20):
                self.flush()

    def index_existing(self) -> None:
        """Build the graph over the store's live vectors without touching the
        corpus (dynamic upgrade path: vectors never leave the device)."""
        live = np.nonzero(self.backend.host_valid_mask)[0].astype(np.int64)
        if len(live) == 0:
            return
        self.graph.ensure_capacity(int(live.max()) + 1)
        live = live[self.graph.levels[live] < 0]
        for start in range(0, len(live), self._insert_batch):
            self._insert_subbatch(live[start : start + self._insert_batch])

    def _construction_beam_level0(self, node_ids: np.ndarray,
                                  eps: np.ndarray, efc: int):
        """Layer-0 ef_construction walks in the fused kernel: one launch
        for as many rows as ``_walk_rows`` allows (the whole sub-batch below
        about 500,000 nodes) instead of one device call a hop. Query vectors
        are gathered from the device corpus by id. Returns (res_ids, res_d)
        ascending, or None when no device beam is configured or the store
        is demoted (the host walk serves then)."""
        if self._device_beam is None:
            return None
        scorer_pack = self.backend.device_scorer()
        if scorer_pack is None:
            return None  # demoted to the warm tier
        scorer, operands = scorer_pack
        from weaviate_tpu_torch.ops.device_beam import device_search

        adj, present = self._device_beam.sync()
        ef_pad = _ef_pad(efc)
        outs_i, outs_d = [], []
        # the walks are independent: the JAX index's fixed 256-row chunks
        # (row 0 repeated into the tail) give the same rows
        chunk = _walk_rows(adj.shape[0])
        for s in range(0, len(node_ids), chunk):
            sub = node_ids[s:s + chunk].astype(np.int64)
            q = self.backend.beam_queries_for_ids(sub)
            sub_eps = eps[s:s + chunk].astype(np.int32)
            ids_t, d_t = device_search(
                scorer, q.contiguous(), operands, adj, present, sub_eps,
                ef=ef_pad, max_steps=_max_steps(ef_pad))
            outs_i.append(ids_t[:len(sub)].cpu().numpy().astype(np.int64))
            outs_d.append(d_t[:len(sub)].cpu().numpy())
        res_ids = np.concatenate(outs_i)[:, :efc]
        res_d = np.concatenate(outs_d)[:, :efc]
        return res_ids, res_d

    def _insert_subbatch(self, ids: np.ndarray) -> None:
        if len(ids) == 0:
            return
        levels = self._level_for_new(len(ids))
        if self.graph.entrypoint == NO_NODE:
            self.graph.add_node(int(ids[0]), int(levels[0]))
            ids, levels = ids[1:], levels[1:]
            if len(ids) == 0:
                return
        b = len(ids)
        qdev = self.backend.prep_query_ids(ids)
        eps = np.full(b, self.graph.entrypoint, np.int64)
        efc = self.config.ef_construction
        old_max = self.graph.max_level
        batch_max = max(old_max, int(levels.max()))

        # lockstep layer walk: greedy descent while level > node level,
        # ef_construction search at levels <= node level. Levels above the
        # pre-batch max have no existing nodes — link_plan still gets an
        # entry so same-batch peers connect there.
        link_plan: list[tuple[int, np.ndarray, np.ndarray, np.ndarray]] = []
        for level in range(batch_max, -1, -1):
            search = levels >= level
            if level <= old_max:
                descend = ~search
                if descend.any():
                    eps[descend] = self._greedy_step_until_stable(
                        qdev, eps, level, descend
                    )[descend]
                if search.any():
                    sub = np.nonzero(search)[0]
                    res = (self._construction_beam_level0(
                        ids[sub], eps[sub], efc) if level == 0 else None)
                    if res is None:
                        res = self._search_level(
                            self.backend.take_queries(qdev, sub), eps[sub],
                            efc, level)
                    res_ids, res_d = res
                    eps[sub] = res_ids[:, 0]
                    link_plan.append((level, sub, res_ids, res_d))
            elif search.any():
                sub = np.nonzero(search)[0]
                empty = np.empty((len(sub), 0))
                link_plan.append(
                    (level, sub, empty.astype(np.int64), empty.astype(np.float32))
                )

        # register nodes (marks them visible; edges come next)
        for i, node in enumerate(ids):
            self.graph.add_node(int(node), int(levels[i]))

        # intra-batch candidates: batch-to-batch pairwise distances restore
        # visibility between nodes inserted in the same lockstep sub-batch
        bb = self.backend.pairwise_device(ids[None, :])[0]

        for level, sub, res_ids, res_d in link_plan:
            self._link_level(level, ids, sub, res_ids, res_d, bb)

    def _link_level(self, level, ids, sub, res_ids, res_d, bb) -> None:
        width = self.graph.width(level)
        b = len(ids)
        g = len(sub)

        # candidate matrix: search results + same-batch peers at this level,
        # built on the device. The peers of row i are the level's batch
        # nodes (exactly the nodes searched there, ``sub``) but i itself,
        # in batch order; the row is padded to res + b columns as in the
        # JAX index
        dev = self.device
        r = res_ids.shape[1]
        sub_t = torch.from_numpy(sub).to(dev)
        off = ~torch.eye(g, dtype=torch.bool, device=dev)
        node_ids = torch.from_numpy(ids[sub].astype(np.int64)).to(dev)
        cand = torch.full((g, r + b), NO_NODE, dtype=torch.int64, device=dev)
        cd = torch.full((g, r + b), float("inf"), device=dev)
        cand[:, :r] = torch.from_numpy(res_ids.astype(np.int64)).to(dev)
        cd[:, :r] = torch.from_numpy(res_d.astype(np.float32)).to(dev)
        cand[:, r:r + g - 1] = node_ids.expand(g, g)[off].view(g, g - 1)
        cd[:, r:r + g - 1] = bb[sub_t][:, sub_t][off].view(g, g - 1)

        sel, cnt = self._select_heuristic_batch(cand, cd, width)
        nodes = ids[sub].astype(np.int64)
        self.graph.set_neighbors_rows(level, nodes, sel, cnt)

        # apply backlinks; batch-prune overflowing nodes with the heuristic
        over_nodes, cand2 = self._apply_backlinks(level, nodes, sel, cnt,
                                                  width)
        if len(over_nodes):
            cd2 = self._node_dists(over_nodes, cand2)
            sel2, cnt2 = self._select_heuristic_batch(cand2, cd2, width)
            self.graph.set_neighbors_rows(level, over_nodes, sel2, cnt2)

    def _apply_backlinks(self, level, nodes, sel, cnt, width):
        """Link every selected neighbor back to its node: the JAX index's
        per-neighbor loop, batched. Neighbors are taken in order of first
        appearance, each with its new nodes in order, deduplicated and
        without the ones its row already holds. Where they fit, they are
        appended to the row's free slots (``HostGraph.append_neighbors``);
        otherwise the neighbor goes to the prune pass with the sorted
        union of its row and its new nodes. Returns (over_nodes [G] int64,
        their candidates [G, C] int64, -1 padded). ``sel`` [G, m] holds
        each node's selection, -1 padded after ``cnt``."""
        if not cnt.sum():
            return np.empty(0, np.int64), None
        src = np.repeat(np.asarray(nodes, np.int64), cnt)
        dst = sel[np.arange(sel.shape[1])[None, :] < cnt[:, None]]
        # each (neighbor, node) pair once, at its first appearance
        _, keep = np.unique(dst * (int(src.max()) + 1) + src,
                            return_index=True)
        keep = np.sort(keep)
        udst, first, inv = np.unique(dst, return_index=True, return_inverse=True)
        rows = self.graph.neighbors_batch(level, udst)             # [U, w]
        e_dst, e_src = inv[keep], src[keep]
        fresh = ~(rows[e_dst] == e_src[:, None]).any(1)
        e_dst, e_src = e_dst[fresh], e_src[fresh]
        # group by neighbor in order of first appearance, keeping order
        order = np.argsort(first[e_dst], kind="stable")
        e_dst, e_src = e_dst[order], e_src[order]
        n_new = np.bincount(e_dst, minlength=len(udst))
        cur_len = (rows >= 0).sum(1)
        fits = cur_len + n_new <= width
        start = np.zeros(len(udst), np.int64)
        g_vals, g_first = np.unique(e_dst, return_index=True)
        start[g_vals] = g_first
        rank = np.arange(len(e_dst)) - start[e_dst]  # place in its group
        ok = fits[e_dst]
        if ok.any():
            # the rank-th free slot of each row, in column order
            free = np.argsort(rows >= 0, axis=1, kind="stable")
            self.graph.append_neighbors(
                level, udst[e_dst[ok]], e_src[ok], free[e_dst[ok], rank[ok]])
        over = np.nonzero((n_new > 0) & ~fits)[0]
        over = over[np.argsort(first[over], kind="stable")]
        if not len(over):
            return np.empty(0, np.int64), None
        # candidates: the sorted union of the row and its new nodes
        big = np.iinfo(np.int64).max
        row_of = np.full(len(udst), -1, np.int64)
        row_of[over] = np.arange(len(over))
        extra = int(n_new[over].max())
        cand = np.full((len(over), width + extra), big, np.int64)
        cur = rows[over].astype(np.int64)
        cand[:, :width] = np.where(cur >= 0, cur, big)
        spill = ~fits[e_dst]
        cand[row_of[e_dst[spill]], width + rank[spill]] = e_src[spill]
        cand.sort(axis=1)
        dup = np.zeros_like(cand, bool)
        dup[:, 1:] = cand[:, 1:] == cand[:, :-1]
        cand[dup] = big
        cand.sort(axis=1)
        width2 = int((cand != big).sum(1).max())
        cand = cand[:, :width2]
        cand[cand == big] = NO_NODE
        return udst[over], cand

    def _select_heuristic_batch(self, cand_ids, cand_d, m: int):
        """Vectorized greedy diversity heuristic (reference heuristic.go:23):
        iterate candidates by ascending distance; keep c iff
        dist(c, q) < dist(c, s) for every already-selected s. One padded
        [G, C, C] distance block provides all candidate-to-candidate
        distances. ``cand_ids`` [G, C] (-1 padded) and ``cand_d`` are host
        arrays or device tensors; the sort, the block and the accept loop
        run on the device. Returns (selections [G, m] int64, -1 padded,
        in ascending distance; counts [G])."""
        dev = self.device
        cand_ids = torch.as_tensor(cand_ids).to(dev, torch.int64)
        cand_d = torch.as_tensor(cand_d).to(dev, torch.float32)
        g, c_in = cand_ids.shape
        if g == 0 or c_in == 0:
            return np.full((g, m), NO_NODE, np.int64), np.zeros(g, np.int64)
        # sort by distance (stable), cap candidate width (nearest
        # candidates dominate heuristic selections), pad rows to pow2 as
        # the JAX index does
        c_cap = min(c_in, max(3 * m, 96))
        order = torch.sort(cand_d, dim=1, stable=True).indices[:, :c_cap]
        ids_s = torch.gather(cand_ids, 1, order)
        d_s = torch.gather(cand_d, 1, order)
        c_pad = _pow2_pad(c_cap)
        g_pad = _pow2_pad(g)
        ids_p = torch.zeros((g_pad, c_pad), dtype=torch.int64, device=dev)
        d_p = torch.full((g_pad, c_pad), float("inf"), device=dev)
        ids_p[:g, :c_cap] = ids_s.clamp(min=0)  # clipped pads
        d_p[:g, :c_cap] = torch.where(ids_s >= 0, d_s, float("inf"))

        pair = self.backend.pairwise_device(ids_p)
        chosen = _accept_loop(pair, d_p, m)[:g, :c_cap]
        # the chosen columns, in column (= distance) order
        k = min(m, c_cap)
        cols = torch.sort((~chosen).to(torch.uint8), dim=1,
                          stable=True).indices[:, :k]
        counts = chosen.sum(1)
        sel = torch.gather(ids_s, 1, cols)
        sel = torch.where(torch.arange(k, device=dev)[None, :]
                          < counts[:, None], sel, NO_NODE)
        out = np.full((g, m), NO_NODE, np.int64)
        out[:, :k] = sel.cpu().numpy()
        return out, counts.cpu().numpy()

    # ------------------------------------------------------------------
    # deletes — tombstone semantics (reference delete.go): deleted nodes
    # stay traversable (their edges keep the graph connected) but are
    # excluded from results; cleanup_tombstones() rewires + drops them
    # ------------------------------------------------------------------
    def delete(self, doc_ids: np.ndarray) -> None:
        doc_ids = np.asarray(doc_ids, np.int64)
        self.backend.delete(doc_ids)
        if self._token_store is not None:
            self._token_store.delete(doc_ids)
        for d in doc_ids:
            self.graph.add_tombstone(int(d))
        if self._commitlog is not None:
            self._commitlog.flush_soft()

    def set_tokens(self, doc_ids: np.ndarray, token_sets: list) -> None:
        """Register late-interaction token sets for the rerank tier
        (overrides the 1-token default ``add_batch`` stores). Requires a
        configured rerank module."""
        if self._token_store is None:
            raise ValueError(
                "set_tokens requires a rerank module configured on this "
                "index (HNSWIndexConfig.rerank)")
        self._token_store.put(np.asarray(doc_ids, np.int64), token_sets)

    def cleanup_tombstones(self) -> int:
        """Rewire edges around tombstoned nodes, then drop them.

        For every live node with a dead neighbor, the dead neighbor is
        replaced by bridging to the dead node's own live neighbors, with the
        diversity heuristic re-selecting when over width.
        Returns the number of nodes removed.
        """
        dead = self.graph.tombstones
        if not dead:
            return 0
        for level in range(self.graph.max_level, -1, -1):
            if level == 0:
                nodes = np.nonzero(self.graph.levels >= 0)[0]
            else:
                nodes = np.asarray(list(self.graph.upper.get(level, {})), np.int64)
            width = self.graph.width(level)
            rewire_nodes: list[int] = []
            rewire_cands: list[np.ndarray] = []
            for node in nodes:
                node = int(node)
                if node in dead:
                    continue
                nbrs = self.graph.get_neighbors(level, node)
                dead_mask = np.asarray([int(n) in dead for n in nbrs])
                if not dead_mask.any():
                    continue
                keep = [int(n) for n in nbrs[~dead_mask]]
                bridge: set[int] = set()
                for dn in nbrs[dead_mask]:
                    for x in self.graph.get_neighbors(level, int(dn)):
                        x = int(x)
                        if x not in dead and x != node:
                            bridge.add(x)
                cand = np.asarray(sorted(set(keep) | bridge), np.int64)
                if len(cand) <= width:
                    self.graph.set_neighbors(level, node, cand)
                else:
                    rewire_nodes.append(node)
                    rewire_cands.append(cand)
            if rewire_nodes:
                cmax = max(len(c) for c in rewire_cands)
                cm = np.full((len(rewire_nodes), cmax), -1, np.int64)
                for r, c in enumerate(rewire_cands):
                    cm[r, : len(c)] = c
                cd = self._node_dists(np.asarray(rewire_nodes, np.int64), cm)
                sel, cnt = self._select_heuristic_batch(cm, cd, width)
                self.graph.set_neighbors_rows(
                    level, np.asarray(rewire_nodes, np.int64), sel, cnt)
        removed = len(dead)
        for dn in sorted(dead):
            self.graph.remove_node_hard(dn)
        return removed

    # ------------------------------------------------------------------
    # search
    # ------------------------------------------------------------------
    def _dynamic_ef(self, k: int) -> int:
        ef = self.config.ef
        if ef > 0:
            return max(ef, k)
        ef = k * self.config.dynamic_ef_factor
        ef = min(max(ef, self.config.dynamic_ef_min), self.config.dynamic_ef_max)
        return max(ef, k)

    def search(
        self,
        queries: np.ndarray,
        k: int,
        allow_list: Optional[np.ndarray] = None,
        rerank=None,
        est_selectivity: Optional[float] = None,
    ) -> SearchResult:
        # a demote/promote between the residency check and the tensor
        # access surfaces as ResidencyMoved: re-route, never fail.
        # ``allow_list`` is an ndarray mask OR a resident FilterPlane;
        # ``est_selectivity`` is the inverted index's sketch estimate,
        # surfaced on the plan's trace span.
        from weaviate_tpu_torch.index.base import run_tier_stable

        if rerank is not None and self._token_store is None:
            raise ValueError(
                "rerank requested but no rerank module is configured on "
                "this index (HNSWIndexConfig.rerank)")
        return run_tier_stable(
            lambda: self._search_tiered(queries, k, allow_list, rerank,
                                        est_selectivity))

    def _allow_host(self, allow_list):
        """Resolve a resident FilterPlane to its host bitmap; ad-hoc
        ndarray masks (and None) pass through untouched."""
        if allow_list is not None \
                and getattr(allow_list, "plane_id", None) is not None:
            return allow_list.mask(self.graph.capacity)
        return allow_list

    def _allow_popcount(self, allow_list) -> int:
        """Allowed count over present rows only: a capacity-sized mask's
        padding tail must not count, or selectivity inflates past 1.0
        and the planner mistakes a real filter for a no-op."""
        if getattr(allow_list, "plane_id", None) is not None:
            return allow_list.count()
        a = np.asarray(allow_list, bool)
        m = min(len(a), len(self.graph.levels))
        return int(np.count_nonzero(a[:m] & (self.graph.levels[:m] >= 0)))

    def _fetch_width(self, k: int, ef: int) -> int:
        """The over-fetch policy (reference hnsw/search.go:184
        shouldRescore): the candidate pool width the rescore tier promotes
        from, one owner for the device walk and the host walk. Code-space
        walks promote from up to ``rescore_limit`` candidates."""
        fetch = max(k, min(ef, 2 * k))
        if self.backend.quantized:
            rl = getattr(self.backend.quantizer.config, "rescore_limit", 0)
            fetch = min(ef, max(fetch, rl, 2 * k))
        return fetch

    def _host_rerank_topk(self, rerank_batch, cand_ids: np.ndarray,
                          k: int, reason: str
                          ) -> tuple[np.ndarray, np.ndarray]:
        """The rerank tier on the host, for the tiers the index picks by
        state (a demoted store, flat triage, the host walk): the candidate
        pool scored against the token store's host planes with the
        module's numpy twin, counted as such."""
        from weaviate_tpu_torch.monitoring import tracing
        from weaviate_tpu_torch.monitoring.metrics import (
            RERANK_FALLBACK,
            RERANK_REQUESTS,
        )

        module, rq, rqm = rerank_batch
        name = getattr(module, "name", type(module).__name__)
        RERANK_REQUESTS.inc(module=name, tier="host")
        RERANK_FALLBACK.inc(module=name, reason=reason)
        tracing.add_event("rerank.fallback", module=name, reason=reason)
        toks, mask = self._token_store.host_planes()
        cand_ids = np.asarray(cand_ids, np.int64)
        inside = (cand_ids >= 0) & (cand_ids < toks.shape[0])
        safe = np.clip(cand_ids, 0, toks.shape[0] - 1)
        ct = toks[safe]
        cm = mask[safe] & inside[:, :, None]
        scores = module.host_score(rq, rqm, ct, cm)
        scores = np.where(inside, scores, -np.inf)
        order = np.argsort(-scores, axis=1, kind="stable")[:, :k]
        ids = np.take_along_axis(cand_ids, order, axis=1)
        s = np.take_along_axis(scores, order, axis=1)
        ids = np.where(np.isfinite(s), ids, -1)
        d = np.where(np.isfinite(s), -s, _INF).astype(np.float32)
        if ids.shape[1] < k:
            pad = k - ids.shape[1]
            ids = np.pad(ids, ((0, 0), (0, pad)), constant_values=-1)
            d = np.pad(d, ((0, 0), (0, pad)), constant_values=_INF)
        return ids.astype(np.int64), d

    def _search_tiered(
        self,
        queries: np.ndarray,
        k: int,
        allow_list: Optional[np.ndarray] = None,
        rerank=None,
        est_selectivity: Optional[float] = None,
    ) -> SearchResult:
        queries = np.atleast_2d(np.asarray(queries, np.float32))
        if queries.shape[-1] != self.backend.dims:
            raise ValueError(
                f"query dims {queries.shape[-1]} != index dims {self.backend.dims}"
            )
        b = queries.shape[0]
        if self.graph.entrypoint == NO_NODE:
            return SearchResult(
                ids=np.full((b, k), -1, np.int64),
                dists=np.full((b, k), _INF, np.float32),
            )

        if not self.backend.device_resident:
            # warm tier: the arrays are demoted to host RAM; the exact host
            # pass serves the query without entering the device dispatcher
            from weaviate_tpu_torch.monitoring.tracing import TRACER

            with TRACER.span("tiering.host_search", rows=b, k=k):
                allow_host = self._allow_host(allow_list)
                if rerank is not None:
                    fetch = self._fetch_width(k, self._dynamic_ef(k))
                    _, ids = self.backend.host_topk(
                        queries, fetch, allow_host)
                    ids, d = self._host_rerank_topk(
                        rerank.batch_for(queries), ids, k, "warm_tier")
                else:
                    d, ids = self.backend.host_topk(queries, k, allow_host)
            return SearchResult(ids=ids, dists=d)

        # batch-group key: the residency epoch (a request enqueued under
        # one residency generation never rides a batch of another); the
        # JAX index adds the mesh epoch and the prewarm isolation token,
        # which come with slices 11 and 9
        tier_key = (self._residency_epoch, 0, None)

        # filtered-search triage is the cost-based planner's call
        # (query/planner/cost.py)
        if allow_list is not None:
            from weaviate_tpu_torch.monitoring import tracing
            from weaviate_tpu_torch.monitoring.metrics import PLANNER_PLANS
            from weaviate_tpu_torch.query.planner import (
                PLAN_EXACT,
                PLAN_OVERFETCH,
                PlanStats,
                plan,
            )

            plane = (allow_list if getattr(allow_list, "plane_id", None)
                     is not None else None)
            n_allowed = self._allow_popcount(allow_list)
            live = max(1, self.count())
            stats = PlanStats(
                live=live, k=k, ef=self._dynamic_ef(k),
                selectivity=n_allowed / live, exact_count=True,
                plane_resident=plane is not None,
                flat_cutoff=self.config.flat_search_cutoff,
                flat_selectivity=self.config.filter_flat_selectivity,
                graph_degree=self.config.max_connections,
                mesh=False)
            chosen = plan(stats)
            PLANNER_PLANS.inc(plan=chosen.plan_type)
            attrs = chosen.trace_attrs()
            if est_selectivity is not None:
                attrs["planner.sketch_selectivity"] = round(
                    float(est_selectivity), 6)
            if plane is not None:
                attrs["planner.plane"] = plane.plane_id
            tracing.annotate(**attrs)
            if chosen.plan_type == PLAN_EXACT:
                allow_host = self._allow_host(allow_list)
                if rerank is not None:
                    fetch = self._fetch_width(k, self._dynamic_ef(k))
                    _, ids = self.backend.flat_topk(
                        queries, fetch, allow_host)
                    ids, d = self._host_rerank_topk(
                        rerank.batch_for(queries), ids, k, "flat_triage")
                    return SearchResult(ids=ids, dists=d)
                return self._flat_filtered(queries, k, allow_host)
            if chosen.plan_type == PLAN_OVERFETCH and rerank is None:
                # over-fetch the unfiltered walk (it coalesces with plain
                # traffic at fetch_k), then post-filter on the host
                ids, d = self._dispatch.search(
                    queries, chosen.fetch_k, None, tier_key=tier_key)
                al = np.asarray(self._allow_host(allow_list), bool)
                ok = ((ids >= 0) & (ids < len(al))
                      & al[np.clip(ids, 0, len(al) - 1)])
                d = np.where(ok, d, _INF)
                ids = np.where(ok, ids, -1)
                order = np.argsort(d, axis=1, kind="stable")[:, :k]
                return SearchResult(
                    ids=np.take_along_axis(ids, order, axis=1),
                    dists=np.take_along_axis(d, order, axis=1))
            # PLAN_BEAM (and over-fetch under rerank, which takes the
            # filtered beam: the rerank stage needs the mask on the card):
            # the mask rides the dispatch below

        ids, d = self._dispatch.search(
            queries, k, allow_list, tier_key=tier_key, rerank=rerank)
        return SearchResult(ids=ids, dists=d)

    def _sub_batch(self) -> int:
        """Rows per walk. The fused walk takes as many as their visited
        bitsets fit (one launch a search up to ``_walk_rows``); the host
        walk keeps the JAX index's split of its [B, capacity] scratch."""
        if self._device_beam is not None:
            return _walk_rows(self.graph.capacity)
        return max(8, min(64, _VISITED_BUDGET // max(1, self.graph.capacity)))

    def _run_search_batch(self, queries: np.ndarray, k: int, allow_list,
                          rerank=None):
        """Single-flight batch runner behind the coalescing dispatcher.
        ``rerank``: (module, q_tokens [B, Tq, D], q_mask) concatenated by
        the leader across the coalesced group, or None."""
        if not self.backend.device_resident:
            # a demotion landed while this group was queued: the leader
            # re-routes the whole batch to the warm host tier
            allow_host = self._allow_host(allow_list)
            if rerank is not None:
                fetch = self._fetch_width(k, self._dynamic_ef(k))
                _, ids = self.backend.host_topk(queries, fetch, allow_host)
                return self._host_rerank_topk(rerank, ids, k, "warm_tier")
            d, ids = self.backend.host_topk(queries, k, allow_host)
            return ids, d
        b = queries.shape[0]
        sub_b = self._sub_batch()
        out_ids = np.full((b, k), -1, np.int64)
        out_d = np.full((b, k), _INF, np.float32)
        for s in range(0, b, sub_b):
            e = min(b, s + sub_b)
            sub_rr = rerank
            if rerank is not None and (s or e < b):
                sub_rr = (rerank[0], rerank[1][s:e], rerank[2][s:e])
            ids, d = self._search_one_batch(queries[s:e], k, allow_list,
                                            rerank=sub_rr)
            out_ids[s:e], out_d[s:e] = ids, d
        return out_ids, out_d

    def _keep_mask(self, allow_list: Optional[np.ndarray]) -> np.ndarray:
        cap = self.graph.capacity
        valid = self.backend.host_valid_mask
        if len(valid) < cap:
            valid = np.pad(valid, (0, cap - len(valid)))
        keep = valid[:cap] & (self.graph.levels >= 0)
        allow_list = self._allow_host(allow_list)
        if allow_list is not None:
            al = np.asarray(allow_list, bool)
            if len(al) < cap:
                al = np.pad(al, (0, cap - len(al)))
            keep &= al[:cap]
        return keep

    def _search_one_batch(self, queries, k, allow_list, rerank=None):
        b = queries.shape[0]
        qdev = self._qdev(queries)
        ef = self._dynamic_ef(k)
        # the leader derives the filtered beam's two-hop expansion budget
        # from the group's mask (one budget per coalesced batch)
        expand = 0
        if allow_list is not None:
            from weaviate_tpu_torch.query.planner import expansion_budget

            n_allowed = self._allow_popcount(allow_list)
            expand = expansion_budget(n_allowed / max(1, self.count()))
        if self._device_beam is not None and self.backend.device_resident:
            # fused walk: greedy descent + layer-0 beam in one launch; an
            # unfitted quantizer walks on the host (a lifecycle stage)
            out = self._device_beam_search(queries, qdev, ef, k, allow_list,
                                           rerank=rerank, expand=expand)
            if out is not None:
                return out
        eps = np.full(b, self.graph.entrypoint, np.int64)
        all_active = np.ones(b, bool)
        for level in range(self.graph.max_level, 0, -1):
            eps = self._greedy_step_until_stable(qdev, eps, level, all_active)
        keep = self._keep_mask(allow_list)
        # over-fetch so the rescore tier has candidates to promote (one
        # owner of the policy: the device walk uses the same width)
        keep_k = self._fetch_width(k, ef)
        _, _, kept_ids, kept_d = self._search_level(
            qdev, eps, ef, 0, keep_mask=keep, keep_k=keep_k, expand=expand
        )
        if rerank is not None:
            # the host walk (no device walk: the config, or an unfitted
            # quantizer): its kept candidates feed the module's numpy twin
            return self._host_rerank_topk(rerank, kept_ids, k, "host_walk")
        return self.backend.rescore_topk(queries, kept_ids, kept_d, k)

    def _device_beam_search(self, queries, qdev, ef, k, allow_list=None,
                            rerank=None, expand: int = 0):
        """The entrypoint -> layer-0 walk in one launch of the fused
        kernel, gather-scoring the device corpus. The host then drops
        tombstoned and deleted ids from the returned beam (sweeping
        semantics) and truncates to k. With a filter the kernel also keeps
        the best allowed nodes seen along the unchanged walk (the
        ``PLAN_BEAM`` route), and that kept track is the result. Returns
        None while the backend has no device scorer (an unfitted
        quantizer): the host walk serves then."""
        from weaviate_tpu_torch.monitoring import tracing
        from weaviate_tpu_torch.ops.device_beam import device_search

        scorer_pack = self.backend.device_scorer()
        if scorer_pack is None:
            return None
        scorer, operands = scorer_pack
        q = self.backend.beam_queries(qdev)
        fetch = self._fetch_width(k, ef)
        adj, present = self._device_beam.sync()
        upper_adj, upper_slots = self._device_beam.sync_upper()
        b = q.shape[0]
        # ef is padded to a power of two as in the JAX index; its batch
        # padding (row 0 repeated, for fewer compiled shapes) would only add
        # walks here, and the walks are independent
        ef_pad = _ef_pad(ef)
        # the filter: padded or cut to the graph's capacity, a resident
        # plane as its cached device mirror; the kept track is fetch wide,
        # padded to a power of two within the beam
        cap = int(adj.shape[0])
        fetch_pad = min(ef_pad, _pow2_pad(fetch))
        allow, keep_k = None, 0
        if allow_list is not None:
            if getattr(allow_list, "plane_id", None) is not None:
                allow = allow_list.device_mask(cap)
            else:
                al = np.asarray(allow_list, bool)
                if len(al) < cap:
                    al = np.pad(al, (0, cap - len(al)))
                allow = al[:cap]
            keep_k = fetch_pad
        # the rerank stage draws from the same fetch-wide pool: on the card
        # one B7a launch after the walk's, on the same stream
        rr_args: dict = {}
        rr_name = ""
        if rerank is not None:
            module, rq, rqm = rerank
            rr_name = getattr(module, "name", type(module).__name__)
            toks, tmask = self._token_store.sync(min_rows=cap)
            rr_args = dict(rerank=module, rerank_k=fetch_pad,
                           rerank_q=rq, rerank_qmask=rqm,
                           rerank_tokens=toks, rerank_tmask=tmask)
        eps = np.full(b, self.graph.entrypoint, np.int32)
        t_dev = time.perf_counter()
        out = device_search(
            scorer, q.contiguous(), operands, adj, present, eps,
            ef=ef_pad, max_steps=_max_steps(ef_pad),
            upper_adj=upper_adj, upper_slots=upper_slots,
            allow=allow, keep_k=keep_k, expand=expand, **rr_args)
        ids_t, d_t = out[2:] if (allow is not None or rerank is not None) \
            else out
        ids = ids_t.cpu().numpy().astype(np.int64)
        d = d_t.cpu().numpy()
        # the copy above is the completion sync: the bracket is the launch
        # plus the walk
        tracing.annotate(
            device_execute_ms=round((time.perf_counter() - t_dev) * 1000, 3),
            scorer=type(scorer).__name__, mesh_mode="single")
        # the keep test of ``_keep_mask`` (live in the store, present in
        # the graph), read at the returned ids only instead of built over
        # the whole capacity for every sub-batch
        valid, levels = self.backend.host_valid_mask, self.graph.levels
        safe = np.clip(ids, 0, min(len(valid), len(levels)) - 1)
        ok = (ids >= 0) & (ids < len(valid)) & valid[safe] & (levels[safe] >= 0)
        d = np.where(ok, d, _INF)
        ids = np.where(ok, ids, -1)
        order = np.argsort(d, axis=1, kind="stable")[:, :fetch]
        d = np.take_along_axis(d, order, axis=1)
        ids = np.take_along_axis(ids, order, axis=1)
        if rerank is not None:
            # the module score is the final order (d is the negated
            # score): no rescore tier after it
            from weaviate_tpu_torch.monitoring.metrics import (
                RERANK_CANDIDATES,
                RERANK_REQUESTS,
            )

            RERANK_REQUESTS.inc(module=rr_name, tier="fused")
            RERANK_CANDIDATES.observe(b * fetch_pad, module=rr_name)
            tracing.add_event("rerank.score", module=rr_name,
                              candidates=fetch_pad, rows=b)
            ids = ids[:, :k].astype(np.int64)
            d = d[:, :k].astype(np.float32)
        else:
            ids, d = self.backend.rescore_topk(queries, ids, d, k)
            ids = ids.astype(np.int64)
        if d.shape[1] < k:
            pad = k - d.shape[1]
            d = np.pad(d, ((0, 0), (0, pad)), constant_values=_INF)
            ids = np.pad(ids, ((0, 0), (0, pad)), constant_values=-1)
        return ids, d

    def multi_walk_inputs(self, queries, k: int, b_pad: int,
                          allow_list=None, expand: int = 0):
        """One walk leg of a multi-target search: what
        ``_device_beam_search`` would hand the walk (scorer and device
        operands, queries padded to ``b_pad`` rows by repeating row 0, the
        synced graph mirror, the entrypoints, the power-of-two widths, the
        device allow mask), for a shard to run every target's walk and
        the join (``core/shard.py``). None when this index cannot walk on
        the card now (no device walk, demoted, or an unfitted quantizer):
        the caller then serves the request from the host oracle."""
        if self._device_beam is None or not self.device_resident:
            return None
        scorer_pack = self.backend.device_scorer()
        if scorer_pack is None:
            return None  # quantizer unfitted: a lifecycle stage
        scorer, operands = scorer_pack
        q = self.backend.beam_queries(self._qdev(queries))
        ef = self._dynamic_ef(k)
        fetch = self._fetch_width(k, ef)
        ef_pad = _ef_pad(ef)
        fetch_pad = min(ef_pad, _pow2_pad(fetch))
        b = q.shape[0]
        if b_pad != b:
            q = torch.cat([q, q[:1].expand(b_pad - b, *q.shape[1:])])
        adj, present = self._device_beam.sync()
        upper_adj, upper_slots = self._device_beam.sync_upper()
        cap = int(adj.shape[0])
        leg = dict(
            scorer=scorer, operands=operands, q=q.contiguous(), adj=adj,
            present=present, upper_adj=upper_adj, upper_slots=upper_slots,
            ef_pad=ef_pad, fetch_pad=fetch_pad, cap=cap, allow=None,
            keep_k=0, expand=0,
            eps=np.full(b_pad, self.graph.entrypoint, np.int32))
        if allow_list is not None:
            if getattr(allow_list, "plane_id", None) is not None:
                leg["allow"] = allow_list.device_mask(cap)
            else:
                al = np.asarray(allow_list, bool)
                if len(al) < cap:
                    al = np.pad(al, (0, cap - len(al)))
                leg["allow"] = al[:cap]
            leg["keep_k"] = fetch_pad
            leg["expand"] = expand
        return leg

    def _flat_filtered(self, queries, k, allow_list):
        d, ids = self.backend.flat_topk(queries, k, allow_list)
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
            dists=np.where(keep, res.dists, _INF),
        )

    # ------------------------------------------------------------------
    def save_vectors(self, path: str, meta: Optional[dict] = None) -> bool:
        if self.store is None:  # quantized: codes rebuild from the objects
            return False
        self.store.save(path, meta)
        if self._token_store is not None:
            # the rerank tier's token planes checkpoint beside the corpus
            # (the JAX index's ``<path>.rrtok.npz`` sidecar)
            self._token_store.save(path)
        return True

    def load_vectors(self, path: str) -> Optional[dict]:
        if self.store is None:
            return None
        meta = self.store.load(path)
        if meta is None:
            return None
        if self._token_store is not None \
                and not self._token_store.load(path):
            # the corpus without its token sidecar: half a checkpoint is
            # no checkpoint (the caller rebuilds from the objects)
            return None
        return meta

    def count(self) -> int:
        return self.graph.node_count

    @property
    def capacity(self) -> int:
        return self.backend.capacity

    def contains(self, doc_id: int) -> bool:
        return self.graph.contains(doc_id) and self.backend.contains(doc_id)

    # -- tiered residency ---------------------------------------------------
    @property
    def device_resident(self) -> bool:
        return self.backend.device_resident

    def hbm_bytes(self) -> int:
        n = self.backend.hbm_bytes()
        if self._device_beam is not None:
            n += self._device_beam.nbytes
        if self._token_store is not None:
            n += self._token_store.nbytes
        return n

    def host_tier_bytes(self) -> int:
        n = self.backend.host_tier_bytes()
        if self._token_store is not None:
            n += self._token_store.host_bytes
        return n

    def demote_device(self) -> int:
        """Warm demotion: the corpus to host RAM and the walk's mirrored
        tables released. The mirror object survives and re-syncs
        wholesale on the next search after promotion."""
        freed = self.backend.demote_device()
        if self._device_beam is not None:
            freed += self._device_beam.drop_device()
        if self._token_store is not None:
            freed += self._token_store.drop_device()
        if freed:
            self._residency_epoch += 1
        return freed

    def promote_device(self) -> int:
        """Re-attach the demoted arrays; the walk's tables re-upload
        lazily on the next search's sync."""
        gained = self.backend.promote_device()
        if gained:
            self._residency_epoch += 1
        return gained

    def stats(self) -> dict:
        s = {
            "type": "hnsw",
            "count": self.count(),
            "capacity": self.capacity,
            "metric": self.metric,
            "max_level": self.graph.max_level,
            "entrypoint": self.graph.entrypoint,
        }
        s["device_resident"] = self.backend.device_resident
        if not self.backend.device_resident:
            s["host_tier_bytes"] = self.backend.host_tier_bytes()
        if self.backend.quantized:
            s["quantizer"] = self.backend.quantizer.kind
            s["fitted"] = self.backend.quantizer.fitted
            s["codes_hbm_bytes"] = self.backend.codes.nbytes
        else:
            s["corpus_hbm_bytes"] = self.backend.store.nbytes
        if self._device_beam is not None:
            # the fused walk's extra device rent: mirrored layer-0 rows,
            # presence mask, and compact upper-layer tables
            s["device_beam"] = True
            s["device_beam_hbm_bytes"] = self._device_beam.nbytes
        if self._rerank_module is not None:
            s["rerank_module"] = self._rerank_module.name
            s["rerank_hbm_bytes"] = self._token_store.nbytes
            s["rerank_host_bytes"] = self._token_store.host_bytes
        return s
