"""HFresh: SPFresh-style centroid/posting vector index (port of
``weaviate_tpu/index/hfresh.py``).

Vectors live in per-centroid POSTINGS; inserts append to the nearest
posting (and, by the SPFresh RNG rule, to up to ``replicas`` postings near
it); oversized postings SPLIT (local 2-means), undersized ones MERGE, and a
split re-homes the members of nearby postings; a search probes the closest
``search_probe`` postings. Split, merge, reassign, replication and the
probe selection are host numpy code, the JAX package's own, so centroids,
postings and probes are equal to the JAX index's after the same batches.
The vectors stay doc-addressed in a ``DeviceVectorStore`` on the index's
device; a search's device step is one call of kernel B9a
(``ops/hfresh.py posting_topk``: the candidates' distances, the mask and
the top-k) for the whole batch, fed the batch's probes
(``posting_operands``) beside the posting snapshot, which stays on the
device (``posting_table``) until the postings change, so that the kernel
reads each probed posting once for the queries that probe it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from weaviate_tpu_torch.index.base import SearchResult, VectorIndex
from weaviate_tpu_torch.index.store import DeviceVectorStore
from weaviate_tpu_torch.ops.distance import MASK_DISTANCE
from weaviate_tpu_torch.ops.hfresh import (posting_operands, posting_table,
                                           posting_topk)
from weaviate_tpu_torch.schema.config import HFreshIndexConfig


class HFreshIndex(VectorIndex):
    def __init__(self, dims: int, config: Optional[HFreshIndexConfig] = None,
                 device=None):
        import threading

        self.config = config or HFreshIndexConfig()
        self.metric = self.config.distance
        self.dims = dims
        self.store = DeviceVectorStore(
            dims, capacity=self.config.initial_capacity,
            normalized=(self.metric == "cosine"), device=device)
        self.device = self.store.device
        # centroid tier: host numpy (the probe's distances stay the JAX
        # package's float32 numpy expressions, so near ties pick the same
        # postings)
        self._centroids = np.zeros((0, dims), np.float32)
        # posting lists: centroid row -> doc id array
        self._postings: list[np.ndarray] = []
        self._doc_posting: dict[int, int] = {}  # doc -> primary posting row
        # every change of the postings counts here (_add_assign,
        # load_vectors, interop.hfresh_from_numpy); a search keeps the
        # device table of the snapshot it last saw with its count and
        # the store's size
        self._version = 0
        self._table = None  # (version, n, PostingTable)
        # guards centroids/postings against search-vs-insert races (the
        # guarded sections are tiny host work; device calls run outside)
        self._lock = threading.Lock()

    # -- centroid helpers ---------------------------------------------------
    def _centroid_dists(self, queries: np.ndarray) -> np.ndarray:
        """[B, C] distances on host (C is small; BLAS is fine and avoids
        device churn for the tiny first stage when C < ~1k). Cosine maps to
        1-ip (non-negative on normalized inputs) so the RNG replication
        ratio stays meaningful; dot stays a raw -ip ordering."""
        c = self._centroids
        if self.metric == "cosine":
            return 1.0 - (queries @ c.T)
        if self.metric == "dot":
            return -(queries @ c.T)
        q2 = (queries * queries).sum(1)[:, None]
        c2 = (c * c).sum(1)[None, :]
        return q2 - 2.0 * (queries @ c.T) + c2

    def _prep(self, v: np.ndarray) -> np.ndarray:
        v = np.asarray(v, np.float32)
        if self.metric == "cosine":
            v = v / (np.linalg.norm(v, axis=-1, keepdims=True) + 1e-12)
        return v

    # -- writes -------------------------------------------------------------
    def add_batch(self, doc_ids: np.ndarray, vectors: np.ndarray) -> None:
        doc_ids = np.asarray(doc_ids, np.int64)
        vectors = np.asarray(vectors, np.float32)
        if len(doc_ids) == 0:
            return
        if vectors.shape[-1] != self.dims:
            raise ValueError(
                f"vectors dims {vectors.shape[-1]} != index dims {self.dims}")
        self.store.put(doc_ids, vectors)
        prepped = self._prep(vectors)
        with self._lock:
            self._add_assign(doc_ids, prepped)

    def _add_assign(self, doc_ids: np.ndarray, prepped: np.ndarray) -> None:
        self._version += 1
        if len(self._centroids) == 0:
            self._centroids = prepped[:1].copy()
            self._postings = [np.empty(0, np.int64)]
        cd = self._centroid_dists(prepped)
        r = min(max(1, self.config.replicas), cd.shape[1])
        near = np.argpartition(cd, r - 1, axis=1)[:, :r] if r < cd.shape[1] \
            else np.argsort(cd, axis=1)
        nd = np.take_along_axis(cd, near, axis=1)
        order = np.argsort(nd, axis=1, kind="stable")
        near = np.take_along_axis(near, order, axis=1)
        nd = np.take_along_axis(nd, order, axis=1)
        # boundary replication (SPFresh RNG rule): beyond the primary,
        # join a posting only while its centroid distance stays within
        # rng_factor x the nearest — vectors deep inside a cell stay single
        appends: dict[int, list[int]] = {}
        for qi in range(len(doc_ids)):
            d0 = max(float(nd[qi, 0]), 1e-12)
            self._doc_posting[int(doc_ids[qi])] = int(near[qi, 0])
            appends.setdefault(int(near[qi, 0]), []).append(int(doc_ids[qi]))
            for j in range(1, r):
                # dot "distances" are unbounded-negative: the ratio rule
                # has no meaning there, so replicate unconditionally
                if (self.metric == "dot"
                        or float(nd[qi, j]) <= self.config.rng_factor * d0):
                    appends.setdefault(int(near[qi, j]), []).append(
                        int(doc_ids[qi]))
        for row, sel in appends.items():
            self._postings[row] = np.concatenate(
                [self._postings[row], np.asarray(sel, np.int64)])
        self._maintain(set(appends))

    def delete(self, doc_ids: np.ndarray) -> None:
        doc_ids = np.asarray(doc_ids).reshape(-1)
        self.store.delete(doc_ids)
        with self._lock:
            for d in doc_ids:
                self._doc_posting.pop(int(d), None)

    # -- split / merge (reference split.go / merge.go, inline) --------------
    def _live_posting(self, row: int) -> np.ndarray:
        """Live posting members (replicated docs legitimately appear in
        several postings; searches dedup candidates)."""
        ids = self._postings[row]
        if len(ids) == 0:
            return ids
        keep = np.asarray([self.store.contains(int(d)) for d in ids])
        ids = np.unique(ids[keep])
        self._postings[row] = ids
        return ids

    def _maintain(self, touched: Optional[set] = None) -> None:
        """Split/merge pass over the postings the current batch touched
        (plus rows created by its own splits) — insert cost stays O(batch),
        not O(total postings)."""
        if touched is None:
            touched = set(range(len(self._postings)))
        work = sorted(touched)
        i = 0
        while i < len(work):
            row = work[i]
            i += 1
            if row >= len(self._postings):
                continue
            before = len(self._postings)
            ids = self._live_posting(row)
            if len(ids) > self.config.max_posting_size:
                self._split(row)
                # a split's children may still be oversized
                work.extend(range(before, len(self._postings)))
                # re-queue only if the split made progress: a degenerate
                # posting (duplicate vectors) stays oversized forever and
                # re-appending it would spin _maintain without terminating
                after = len(self._live_posting(row))
                if self.config.max_posting_size < after < len(ids):
                    work.append(row)
        if len(self._postings) > 1:
            for row in sorted(touched, reverse=True):
                if row >= len(self._postings):
                    continue
                ids = self._live_posting(row)
                if 0 < len(ids) < self.config.min_posting_size \
                        and len(self._postings) > 1:
                    self._merge(row)

    def _split(self, row: int) -> None:
        """Local 2-means over the posting's vectors (SPFresh split)."""
        ids = self._postings[row]
        vecs = self._prep(self.store.get(ids))
        # 2-means with farthest-pair init, a few Lloyd rounds
        d0 = vecs[0]
        far = int(np.argmax(((vecs - d0) ** 2).sum(1)))
        c = np.stack([vecs[0], vecs[far]])
        for _ in range(4):
            d = ((vecs[:, None, :] - c[None]) ** 2).sum(-1)
            a = np.argmin(d, axis=1)
            for k in (0, 1):
                if (a == k).any():
                    c[k] = vecs[a == k].mean(0)
        d = ((vecs[:, None, :] - c[None]) ** 2).sum(-1)
        a = np.argmin(d, axis=1)
        if (a == 0).all() or (a == 1).all():
            return  # degenerate (duplicate vectors): keep as one posting
        new_row = len(self._postings)
        # copy-on-write: a concurrent search reads the OLD centroid array
        # outside the lock; in-place row writes would tear under it
        grown = np.vstack([self._centroids, c[1][None]])
        grown[row] = c[0]
        self._centroids = grown
        self._postings[row] = ids[a == 0]
        self._postings.append(ids[a == 1])
        for d_id in ids[a == 1]:
            self._doc_posting[int(d_id)] = new_row
        self._reassign_neighbors((row, new_row))

    def _reassign_neighbors(self, split_rows: tuple[int, int],
                            neighbors: int = 8) -> None:
        """Bounded SPFresh reassign (reference ``reassign.go``): a split
        moves the cell boundary, so members of NEARBY postings may now be
        closest to one of the two new centroids (and the split posting's
        own members may belong elsewhere). Recheck only the ``neighbors``
        postings closest to the split pair — cost stays O(local), never
        O(index)."""
        c = self._centroids
        if len(c) <= 2:
            return
        pair = c[list(split_rows)]
        d = ((c[None, :, :] - pair[:, None, :]) ** 2).sum(-1).min(0)
        for sr in split_rows:
            d[sr] = np.inf
        nrows = np.argsort(d)[:neighbors]
        check = list(split_rows) + [int(r) for r in nrows]
        moved: dict[int, list[int]] = {}
        for row in check:
            ids = self._live_posting(row)
            if len(ids) == 0:
                continue
            vecs = self._prep(self.store.get(ids))
            cd = self._centroid_dists(vecs)
            best = np.argmin(cd, axis=1)
            stay = best == row
            if stay.all():
                continue
            self._postings[row] = ids[stay]
            for d_id, b_row in zip(ids[~stay], best[~stay]):
                moved.setdefault(int(b_row), []).append(int(d_id))
        for row, sel in moved.items():
            self._postings[row] = np.unique(np.concatenate(
                [self._postings[row], np.asarray(sel, np.int64)]))
            for d_id in sel:
                self._doc_posting[int(d_id)] = row

    def _merge(self, row: int) -> None:
        ids = self._postings[row]
        c = self._centroids[row]
        d = ((self._centroids - c) ** 2).sum(1)
        d[row] = np.inf
        target = int(np.argmin(d))
        self._postings[target] = np.concatenate(
            [self._postings[target], ids])
        for d_id in ids:
            self._doc_posting[int(d_id)] = target
        # drop row by swapping the last one in (postings + centroids);
        # copy-on-write for the same reason as _split
        last = len(self._postings) - 1
        shrunk = self._centroids[:last].copy()
        if row != last:
            self._postings[row] = self._postings[last]
            shrunk[row] = self._centroids[last]
            for d_id in self._postings[row]:
                if self._doc_posting.get(int(d_id)) == last:
                    self._doc_posting[int(d_id)] = row
        self._postings.pop()
        self._centroids = shrunk

    # -- search -------------------------------------------------------------
    def search(self, queries: np.ndarray, k: int,
               allow_list: Optional[np.ndarray] = None,
               est_selectivity: Optional[float] = None) -> SearchResult:
        # est_selectivity: planner explainability payload — IVF probing has
        # no plan race, so it is accepted for interface parity and unused
        queries = np.atleast_2d(np.asarray(queries, np.float32))
        if queries.shape[-1] != self.dims:
            raise ValueError(
                f"query dims {queries.shape[-1]} != index dims {self.dims}")
        b = queries.shape[0]
        if len(self._centroids) == 0 or self.store.live_count == 0:
            return SearchResult(ids=np.full((b, k), -1, np.int64),
                                dists=np.full((b, k), np.inf, np.float32))
        qp = self._prep(queries)
        # snapshot under the lock: centroid count and posting arrays must
        # be mutually consistent (a racing merge truncates both); postings
        # read RAW — dead docs fall to the vectorized valid-mask below, so
        # no per-element contains() loop runs on the hot path
        with self._lock:
            centroids = self._centroids
            postings = list(self._postings)
            version = self._version
        if len(centroids) == 0:
            return SearchResult(ids=np.full((b, k), -1, np.int64),
                                dists=np.full((b, k), np.inf, np.float32))
        nprobe = min(self.config.search_probe, len(centroids))
        if self.metric == "cosine":
            cd = 1.0 - (qp @ centroids.T)
        elif self.metric == "dot":
            cd = -(qp @ centroids.T)
        else:
            cd = ((qp * qp).sum(1)[:, None] - 2.0 * (qp @ centroids.T)
                  + (centroids * centroids).sum(1)[None, :])
        probe = np.argpartition(cd, nprobe - 1, axis=1)[:, :nprobe]

        # candidate sets per query, padded into one [B, Cmax] device gather
        cand_lists = []
        for qi in range(b):
            parts = [postings[int(r)] for r in probe[qi]]
            ids = (np.unique(np.concatenate(parts)) if parts
                   else np.empty(0, np.int64))  # replicas dedup here
            cand_lists.append(ids)
        cmax = max((len(c) for c in cand_lists), default=0)
        if cmax == 0:
            return SearchResult(ids=np.full((b, k), -1, np.int64),
                                dists=np.full((b, k), np.inf, np.float32))
        # padded past each query's candidates with ids above every row, so
        # that each row stays sorted (B9a searches it)
        cand = np.full((b, cmax), np.iinfo(np.int64).max)
        mask = np.zeros((b, cmax), bool)
        for qi, ids in enumerate(cand_lists):
            cand[qi, : len(ids)] = ids
            mask[qi, : len(ids)] = True
        if allow_list is not None:
            al = np.asarray(allow_list, bool)
            ok = (cand < len(al)) & mask
            mask = mask & np.where(ok, al[np.clip(cand, 0, len(al) - 1)],
                                   False)

        # one B9a call: distances, the mask (and the store's valid bits)
        # and the top-k stay on the device; only [B, kk] crosses back. The
        # queries, candidates, mask and probes go up in one copy, beside
        # the device's posting table, so that the kernel reads each
        # posting once for the queries that probe it
        corpus, valid, _ = self.store.snapshot()
        dev = corpus.device
        n = corpus.shape[0]
        held = self._table
        if held is None or held[:2] != (version, n):
            held = self._table = (version, n,
                                  posting_table(postings, n, dev))
        q_t, rows, mask_t, posts = posting_operands(
            qp, cand, mask, probe, held[2], n, dev)
        kk = min(k, cmax)
        out_d_t, sel_t = posting_topk(q_t, corpus, valid, rows, mask_t, kk,
                                      self.metric, posts)
        out_d = out_d_t.cpu().numpy()
        sel = sel_t.cpu().numpy().astype(np.int64)
        out_i = np.take_along_axis(cand, sel, axis=1)
        out_i = np.where(out_d >= MASK_DISTANCE, -1, out_i)
        out_d = np.where(out_i < 0, np.inf, out_d)
        if kk < k:
            pad = k - kk
            out_i = np.pad(out_i, ((0, 0), (0, pad)), constant_values=-1)
            out_d = np.pad(out_d, ((0, 0), (0, pad)),
                           constant_values=np.inf)
        return SearchResult(ids=out_i.astype(np.int64),
                            dists=out_d.astype(np.float32))

    def search_by_distance(self, queries, max_distance, allow_list=None,
                           limit: int = 1024):
        res = self.search(queries, min(limit, max(1, self.count())),
                          allow_list)
        keep = res.dists <= max_distance
        return SearchResult(ids=np.where(keep, res.ids, -1),
                            dists=np.where(keep, res.dists, np.inf))

    # -- checkpoint ---------------------------------------------------------
    def save_vectors(self, path: str, meta: Optional[dict] = None) -> bool:
        m = dict(meta or {})
        with self._lock:
            m["hfresh"] = {
                "centroids": self._centroids.tobytes(),
                "n_centroids": len(self._centroids),
                "postings": [p.tobytes() for p in self._postings],
            }
        self.store.save(path, m)
        return True

    def load_vectors(self, path: str) -> Optional[dict]:
        m = self.store.load(path)
        if m is None:
            return None
        hf = m.get("hfresh")
        if not hf:
            return None
        self._centroids = np.frombuffer(
            hf["centroids"], np.float32).reshape(
            hf["n_centroids"], self.dims).copy()
        self._postings = [np.frombuffer(p, np.int64).copy()
                          for p in hf["postings"]]
        self._version += 1
        self._doc_posting = {
            int(d): row
            for row, ids in enumerate(self._postings)
            for d in ids
        }
        return m

    # -- bookkeeping ---------------------------------------------------------
    def count(self) -> int:
        return self.store.live_count

    @property
    def capacity(self) -> int:
        return self.store.capacity

    def contains(self, doc_id: int) -> bool:
        return self.store.contains(doc_id)

    # -- tiered residency (docs/tiering.md): hfresh has no warm search
    # tier (its posting walk reads the device store directly), so it
    # stays non-demotable — demote_device keeps the base-class 0 and the
    # controller can only cold-release the whole shard. But its device rent
    # is REAL and must reach the budget ledger; hiding it would let
    # actual residency grow past the budget unseen.
    def hbm_bytes(self) -> int:
        return self.store.nbytes

    def stats(self) -> dict:
        sizes = [len(p) for p in self._postings]
        return {
            "type": "hfresh",
            "count": self.count(),
            "centroids": len(self._centroids),
            "max_posting": max(sizes, default=0),
            "min_posting": min(sizes, default=0),
            "metric": self.metric,
        }
