"""Distance backends for HNSW traversal, and the warm-tier exact search
over a detached store's host corpus (port of
``weaviate_tpu/index/hnsw/backend.py``).

The graph walk is the same for every backend; only the batched distance
calls differ. ``RawBackend`` keeps the full-precision corpus in device
memory (``DeviceVectorStore``) and scores with ``ops/distance.py``.
``QuantizedBackend`` keeps a quantizer's code planes (BQ, SQ, PQ or RQ)
in device memory
(``DeviceArraySet``), the originals in host RAM (``HostVectorStore``), and
rescores exactly on the host. The port's stores are single-device, so the
JAX backend's mesh branches have no counterpart here (multi-GPU: slice 11).
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from weaviate_tpu_torch.index.store import DeviceVectorStore, resolve_device
from weaviate_tpu_torch.ops.distance import (
    candidate_pairwise,
    flat_search,
    gather_distance,
    normalize,
)

_INF = np.float32(np.inf)
# elements of one code-space frontier gather's [rows, C, D] block
_GATHER_ELEMS = 1 << 25


def _host_metric(a: np.ndarray, b: np.ndarray, metric: str) -> np.ndarray:
    """Broadcasted exact distances on host (small candidate blocks only)."""
    if metric == "l2-squared":
        diff = a - b
        return np.einsum("...d,...d->...", diff, diff).astype(np.float32)
    if metric in ("dot", "cosine"):
        ip = np.einsum("...d,...d->...", a, b).astype(np.float32)
        return -ip if metric == "dot" else 1.0 - ip
    if metric == "manhattan":
        return np.abs(a - b).sum(axis=-1).astype(np.float32)
    return (a != b).sum(axis=-1).astype(np.float32)


def host_exact_topk(q: np.ndarray, vecs: np.ndarray, live_ids: np.ndarray,
                    metric: str, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Exact top-k over host rows — the warm-tier search executor: a
    demoted tenant's queries are served by one BLAS pass instead of
    re-renting device memory. ``vecs`` [L, D] are the live rows,
    ``live_ids`` their doc ids. Returns (dists [B, k], ids [B, k])
    ascending, -1/inf padded."""
    b = q.shape[0]
    if len(live_ids) == 0:
        return (np.full((b, k), _INF, np.float32),
                np.full((b, k), -1, np.int64))
    v = vecs.astype(np.float32, copy=False)
    if metric in ("l2-squared", "dot", "cosine"):
        ip = q @ v.T  # [B, L] — BLAS, never a [B, L, D] intermediate
        if metric == "l2-squared":
            sq = np.einsum("ld,ld->l", v, v)
            qsq = np.einsum("bd,bd->b", q, q)
            d = qsq[:, None] - 2.0 * ip + sq[None, :]
        elif metric == "dot":
            d = -ip
        else:
            d = 1.0 - ip
        d = d.astype(np.float32, copy=False)
    else:
        # manhattan/hamming: chunk the row axis (~64MB intermediates)
        d = np.empty((b, len(live_ids)), np.float32)
        step = max(1, (1 << 24) // max(1, b * v.shape[1]))
        for s in range(0, len(live_ids), step):
            d[:, s:s + step] = _host_metric(
                q[:, None, :], v[None, s:s + step, :], metric)
    kk = min(k, d.shape[1])
    part = np.argpartition(d, kk - 1, axis=1)[:, :kk]
    pd = np.take_along_axis(d, part, axis=1)
    order = np.argsort(pd, axis=1, kind="stable")
    sel = np.take_along_axis(part, order, axis=1)
    out_d = np.take_along_axis(d, sel, axis=1)
    out_i = live_ids[sel].astype(np.int64)
    if kk < k:
        out_d = np.pad(out_d, ((0, 0), (0, k - kk)), constant_values=_INF)
        out_i = np.pad(out_i, ((0, 0), (0, k - kk)), constant_values=-1)
    return out_d, out_i


def _live_under_allow(valid: np.ndarray,
                      allow: Optional[np.ndarray]) -> np.ndarray:
    live = np.flatnonzero(valid)
    if allow is not None:
        al = np.asarray(allow, bool)
        live = live[live < len(al)]
        live = live[al[live]]
    return live


def _gather_rows(corpus: torch.Tensor, rows: np.ndarray) -> np.ndarray:
    """Rows of a host corpus tensor as a float32 numpy array."""
    return corpus[torch.from_numpy(rows)].float().numpy()


def host_store_topk(store: DeviceVectorStore, metric: str,
                    queries: np.ndarray, k: int,
                    allow: Optional[np.ndarray]
                    ) -> tuple[np.ndarray, np.ndarray]:
    """Warm-tier exact search over a detached store's host corpus: cosine
    normalize, live-under-allow mask, exact top-k."""
    q = np.atleast_2d(np.asarray(queries, np.float32))
    if metric == "cosine":
        q = q / np.maximum(
            np.linalg.norm(q, axis=-1, keepdims=True), 1e-12)
    corpus, _valid, _sq = store.host_arrays
    if allow is None:
        # the unfiltered live view is immutable while detached (a demoted
        # store rejects mutations), so gather it once per demotion;
        # attach()/detach() invalidate the cache
        cached = store._warm_live_cache
        if cached is None:
            live = np.flatnonzero(store.host_valid_mask)
            cached = (live, _gather_rows(corpus, live))
            store._warm_live_cache = cached
        live, vecs = cached
        return host_exact_topk(q, vecs, live, metric, k)
    live = _live_under_allow(store.host_valid_mask, allow)
    return host_exact_topk(q, _gather_rows(corpus, live), live, metric, k)


class RawBackend:
    """Full-precision distances over the device-resident corpus."""

    quantized = False

    def __init__(self, dims: int, config, store: Optional[DeviceVectorStore] = None,
                 device=None):
        self.config = config
        self.metric = config.distance
        self.dims = dims
        self.store = store or DeviceVectorStore(
            dims,
            capacity=config.initial_capacity,
            normalized=(self.metric == "cosine"),
            device=device,
        )

    @property
    def device(self) -> torch.device:
        return self.store.device

    # -- storage ----------------------------------------------------------
    def put(self, doc_ids: np.ndarray, vectors: np.ndarray) -> None:
        self.store.put(doc_ids, vectors)

    def delete(self, doc_ids: np.ndarray) -> None:
        self.store.delete(doc_ids)

    def contains(self, doc_id: int) -> bool:
        return self.store.contains(doc_id)

    @property
    def capacity(self) -> int:
        return self.store.capacity

    def device_plane_capacity(self) -> int:
        """Rows of the device plane the walk gathers (the rerank tier's
        token planes align to it)."""
        return self.store.capacity

    @property
    def host_valid_mask(self) -> np.ndarray:
        return self.store.host_valid_mask

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

    def host_topk(self, queries: np.ndarray, k: int,
                  allow: Optional[np.ndarray]
                  ) -> tuple[np.ndarray, np.ndarray]:
        """Warm-tier exact search over the detached host corpus."""
        return host_store_topk(self.store, self.metric, queries, k, allow)

    # -- query prep -------------------------------------------------------
    def prep_queries(self, queries: np.ndarray) -> torch.Tensor:
        q = torch.from_numpy(np.ascontiguousarray(
            np.atleast_2d(np.asarray(queries, np.float32)))).to(self.device)
        if self.metric == "cosine":
            q = normalize(q)
        return q

    def prep_query_ids(self, ids: np.ndarray) -> torch.Tensor:
        corpus = self.store.corpus
        q = corpus[_index(ids, corpus.device)]
        if self.metric == "cosine":
            q = normalize(q)
        return q

    @staticmethod
    def take_queries(qrep: torch.Tensor, rows: np.ndarray) -> torch.Tensor:
        """Row subset of a query rep (lockstep construction sub-batching)."""
        return qrep[_index(rows, qrep.device)]

    # -- device beam ------------------------------------------------------
    def device_scorer(self):
        """(scorer, operands) for the fused device walk: the raw corpus
        snapshot, gather-scored at full precision. None while demoted to
        the warm tier (searches belong on the host path then)."""
        if not self.store.device_resident:
            return None
        from weaviate_tpu_torch.ops.device_beam import RawScorer

        corpus, _valid, _sqnorms = self.store.snapshot()
        return RawScorer(self.metric, self.config.precision), (corpus,)

    def beam_queries(self, qrep: torch.Tensor) -> torch.Tensor:
        """Device query rep for the fused walk (``prep_queries`` output is
        already a normalized device tensor)."""
        return qrep

    def beam_queries_for_ids(self, ids: np.ndarray) -> torch.Tensor:
        """Construction-side query rep gathered from the device corpus by
        id: nothing crosses from the host. Rows are already metric-prepped
        (cosine rows are normalized at put)."""
        corpus, _valid, _sqnorms = self.store.snapshot()
        return corpus[_index(ids, corpus.device)].float().contiguous()

    # -- distance calls ---------------------------------------------------
    def frontier_dists(self, qrep: torch.Tensor, cand: np.ndarray) -> np.ndarray:
        """Host-walk frontier evaluation: one device call per beam hop
        (the host walk serves when the device beam is off, and at the
        upper levels of construction)."""
        corpus = self.store.corpus
        clipped = _index(np.maximum(cand, 0), corpus.device)
        d = gather_distance(qrep, corpus, clipped, self.metric,
                            precision=self.config.precision).cpu().numpy()
        d[cand < 0] = _INF
        return d

    def pairwise(self, ids: np.ndarray) -> np.ndarray:
        """[G, C] ids (pads clipped to 0 by caller) -> [G, C, C] distances."""
        return self.pairwise_device(ids).cpu().numpy()

    def pairwise_device(self, ids) -> torch.Tensor:
        """``pairwise`` left on the device (the selection heuristic's
        accept loop runs there)."""
        corpus = self.store.corpus
        return candidate_pairwise(
            corpus, _index(ids, corpus.device), self.metric,
            precision=self.config.precision)

    def flat_topk(
        self, queries: np.ndarray, k: int, allow: Optional[np.ndarray]
    ) -> tuple[np.ndarray, np.ndarray]:
        """Brute-force top-k (the planner's exact route). Returns (dists,
        ids)."""
        if not self.store.device_resident:
            return self.host_topk(queries, k, allow)
        qrep = self.prep_queries(queries)
        corpus, valid, sqnorms = self.store.snapshot()
        cap = corpus.shape[0]
        allow_t = None
        if allow is not None:
            al = np.asarray(allow, bool)
            if len(al) < cap:
                al = np.pad(al, (0, cap - len(al)))
            allow_t = torch.from_numpy(
                np.ascontiguousarray(al[:cap])).to(corpus.device)
        d, ids = flat_search(
            qrep,
            corpus,
            k=k,
            metric=self.metric,
            valid_mask=valid,
            allow_mask=allow_t,
            corpus_sqnorms=sqnorms if self.metric == "l2-squared" else None,
            precision=self.config.precision,
            approx_recall=_resolved_approx_recall(self.config),
        )
        d = d.cpu().numpy()
        ids = ids.cpu().numpy().astype(np.int64)
        d[ids < 0] = _INF
        return d, ids

    def rescore_topk(
        self, queries: np.ndarray, cand_ids: np.ndarray, cand_d: np.ndarray, k: int
    ) -> tuple[np.ndarray, np.ndarray]:
        """Raw distances are already exact: just truncate."""
        return cand_ids[:, :k], cand_d[:, :k]


def _index(ids, device) -> torch.Tensor:
    """An int64 index tensor on ``device`` from host ids (or a tensor)."""
    if torch.is_tensor(ids):
        return ids.to(device, torch.int64)
    return torch.from_numpy(np.ascontiguousarray(ids, np.int64)).to(device)


def _resolved_approx_recall(config) -> float:
    """The unset (-1) resolution ``FlatIndex.search`` applies: follow the
    hot-reloadable fleet default; 0.0 stays pinned exact."""
    r = config.flat_approx_recall
    if r < 0.0:
        from weaviate_tpu_torch.utils.runtime_config import (
            FLAT_APPROX_RECALL_DEFAULT,
        )

        return FLAT_APPROX_RECALL_DEFAULT.get()
    return r


class QueryRep(NamedTuple):
    """Per-search query representation: host float32 (metric-prepped) for
    the exact rescore and the pre-fit route, and the quantizer's device rep
    (packed bits or float32), computed once and reused across every
    frontier hop."""

    host: np.ndarray
    code: Any  # None while the quantizer is not fitted

    @property
    def shape(self) -> tuple:
        return self.host.shape


class QuantizedBackend:
    """Code-space distances + exact host rescore (HNSW or flat + a
    quantizer)."""

    quantized = True

    def __init__(self, dims: int, config, device=None):
        from weaviate_tpu_torch.compression import (
            DeviceArraySet,
            HostVectorStore,
            build_quantizer,
        )
        from weaviate_tpu_torch.compression.store import raw_tier_dtype

        self.config = config
        self.metric = config.distance
        self.dims = dims
        dtype = raw_tier_dtype(getattr(config, "raw_tier", "ram"))
        device = resolve_device(device)
        # a product quantizer fits and encodes on the codes' device
        self.quantizer = build_quantizer(config.quantizer, dims, self.metric,
                                         device=device)
        self.originals = HostVectorStore(
            dims, capacity=config.initial_capacity, dtype=dtype)
        self.codes = DeviceArraySet(
            self.quantizer.fields(), capacity=config.initial_capacity,
            device=device)

    @property
    def device(self) -> torch.device:
        return self.codes.device

    def _prep_vectors(self, vectors: np.ndarray) -> np.ndarray:
        v = np.asarray(vectors, np.float32)
        if self.metric == "cosine":
            v = v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-12)
        return v

    def _encode(self, vectors: np.ndarray) -> dict:
        """Code planes of prepped vectors: on the device where the
        quantizer has an encode there (BQ, the same bits), else on the
        host."""
        enc = getattr(self.quantizer, "encode_device", None)
        if enc is None:
            return self.quantizer.encode(vectors)
        return enc(torch.from_numpy(np.ascontiguousarray(vectors)).to(
            self.device))

    # -- storage ----------------------------------------------------------
    def put(self, doc_ids: np.ndarray, vectors: np.ndarray) -> None:
        v = self._prep_vectors(vectors)
        self.originals.put(doc_ids, v)
        if self.quantizer.fitted:
            self.codes.put(doc_ids, self._encode(v))
            return
        if self.originals.live_count >= self.quantizer.min_training:
            limit = getattr(self.quantizer.config, "training_limit", 100_000)
            self.quantizer.fit(self.originals.sample(limit))
            ids, vecs = self.originals.all_live()
            self.codes.put(ids, self._encode(vecs))

    def delete(self, doc_ids: np.ndarray) -> None:
        self.originals.delete(doc_ids)
        self.codes.delete(doc_ids)

    def contains(self, doc_id: int) -> bool:
        return doc_id < self.originals.capacity and bool(
            self.originals.valid[doc_id]
        )

    @property
    def capacity(self) -> int:
        return self.originals.capacity

    def device_plane_capacity(self) -> int:
        """Rows of the device code planes the walk gathers."""
        return self.codes.capacity

    @property
    def host_valid_mask(self) -> np.ndarray:
        return self.originals.valid

    # -- tiered residency ---------------------------------------------------
    @property
    def device_resident(self) -> bool:
        return self.codes.device_resident

    def hbm_bytes(self) -> int:
        return self.codes.nbytes

    def host_tier_bytes(self) -> int:
        return self.codes.host_bytes

    def demote_device(self) -> int:
        return self.codes.detach()

    def promote_device(self) -> int:
        return self.codes.attach()

    def host_topk(self, queries: np.ndarray, k: int,
                  allow: Optional[np.ndarray]
                  ) -> tuple[np.ndarray, np.ndarray]:
        """Warm-tier exact search over the host originals (the rescore tier
        already lives there — demotion only evicts the codes)."""
        q = self._prep_vectors(np.atleast_2d(queries))
        live = _live_under_allow(self.originals.valid, allow)
        return host_exact_topk(
            q, self.originals.get(live), live, self.metric, k)

    # -- query prep -------------------------------------------------------
    def prep_queries(self, queries: np.ndarray) -> QueryRep:
        host = self._prep_vectors(np.atleast_2d(queries))
        code = (self.quantizer.prep(host, self.device)
                if self.quantizer.fitted else None)
        return QueryRep(host=host, code=code)

    def prep_query_ids(self, ids: np.ndarray) -> QueryRep:
        return self.prep_queries(self.originals.get(ids))

    @staticmethod
    def take_queries(qrep: QueryRep, rows: np.ndarray) -> QueryRep:
        return QueryRep(
            host=qrep.host[rows],
            code=None if qrep.code is None
            else qrep.code[_index(rows, qrep.code.device)],
        )

    # -- device beam ------------------------------------------------------
    def device_scorer(self):
        """(scorer, operands) over the device code planes, or None while the
        quantizer is unfitted (walks before training stay on the host: a
        lifecycle stage, not a failure) or the codes are demoted to the warm
        tier."""
        if not self.quantizer.fitted or not self.codes.device_resident:
            return None
        return self.quantizer.beam_scorer(self.codes)

    def beam_queries(self, qrep: QueryRep):
        """Device query rep for the fused walk: the quantizer's code-space
        rep (packed bits / float32), None before fit."""
        return qrep.code

    def beam_queries_for_ids(self, ids: np.ndarray):
        """Construction-side query rep: originals gathered on the host and
        prepped once per chunk (one upload), not once per hop."""
        return self.prep_query_ids(ids).code

    # -- distance calls ---------------------------------------------------
    def frontier_dists(self, qrep: QueryRep, cand: np.ndarray) -> np.ndarray:
        """Host-walk frontier evaluation in code space (the fallback tier;
        the serving path is the one-launch device walk)."""
        if qrep.code is None:
            return self._exact_host_dists(qrep.host, cand)
        clipped = _index(np.maximum(cand, 0), self.device)
        # the gathers unpack [rows, C, D] blocks: rows in chunks bound them
        step = max(1, _GATHER_ELEMS // max(1, cand.shape[1] * self.dims))
        d = np.concatenate([
            self.quantizer.gather_distance(
                qrep.code[s:s + step], self.codes,
                clipped[s:s + step]).cpu().numpy()
            for s in range(0, max(1, cand.shape[0]), step)])
        d[cand < 0] = _INF
        return d

    def _exact_host_dists(self, q: np.ndarray, cand: np.ndarray) -> np.ndarray:
        clipped = np.maximum(cand, 0)
        vecs = self.originals.get(clipped.reshape(-1)).reshape(
            *cand.shape, self.dims
        )
        d = _host_metric(q[:, None, :], vecs, self.metric)
        d[cand < 0] = _INF
        return d

    def pairwise(self, ids: np.ndarray) -> np.ndarray:
        """Construction heuristic pairwise: exact over the host originals
        (JAX ``QuantizedBackend.pairwise``), [G, C] -> [G, C, C]."""
        vecs = self.originals.get(ids.reshape(-1)).reshape(*ids.shape, self.dims)
        if self.metric == "cosine":
            vecs = vecs / np.maximum(
                np.linalg.norm(vecs, axis=-1, keepdims=True), 1e-12
            )
        g_n, c_n, d_n = vecs.shape
        out = np.empty((g_n, c_n, c_n), np.float32)
        if self.metric in ("l2-squared", "dot", "cosine"):
            for g in range(g_n):
                v = vecs[g]
                ip = (v @ v.T).astype(np.float32)
                if self.metric == "l2-squared":
                    sq = np.einsum("cd,cd->c", v, v).astype(np.float32)
                    out[g] = sq[:, None] + sq[None, :] - 2.0 * ip
                elif self.metric == "dot":
                    out[g] = -ip
                else:
                    out[g] = 1.0 - ip
            return out
        step = max(1, (1 << 24) // max(1, c_n * d_n))  # ~64MB intermediate
        for g in range(g_n):
            v = vecs[g]
            for s in range(0, c_n, step):
                out[g, s:s + step] = _host_metric(
                    v[s:s + step, None, :], v[None, :, :], self.metric)
        return out

    def pairwise_device(self, ids) -> torch.Tensor:
        """``pairwise`` on the device (the selection heuristic's accept loop
        runs there): the distinct originals of ``ids`` are gathered on the
        host and uploaded once, then the [G, C, C] block is float32
        products of the exact originals, as ``pairwise``'s."""
        ids = ids.cpu().numpy() if torch.is_tensor(ids) else np.asarray(ids)
        uniq, inv = np.unique(ids.reshape(-1), return_inverse=True)
        rows = torch.from_numpy(np.ascontiguousarray(
            self.originals.get(uniq))).to(self.device)
        if self.metric == "cosine":
            rows = rows / torch.clamp(
                torch.linalg.vector_norm(rows, dim=-1, keepdim=True),
                min=1e-12)
        if self.metric not in ("l2-squared", "dot", "cosine"):
            return torch.from_numpy(self.pairwise(ids)).to(self.device)
        g_n, c_n = ids.shape
        inv = _index(inv, self.device).view(g_n, c_n)
        out = torch.empty((g_n, c_n, c_n), device=self.device)
        # groups in chunks: a [groups, C, D] block of rows stays bounded
        step = max(1, _GATHER_ELEMS // max(1, c_n * self.dims))
        for s in range(0, g_n, step):
            v = rows[inv[s:s + step]]
            ip = torch.bmm(v, v.transpose(1, 2))
            if self.metric == "l2-squared":
                sq = torch.sum(v * v, dim=-1)
                out[s:s + step] = sq[:, :, None] + sq[:, None, :] - 2.0 * ip
            else:
                out[s:s + step] = -ip if self.metric == "dot" else 1.0 - ip
        return out

    def flat_topk(
        self, queries: np.ndarray, k: int, allow: Optional[np.ndarray]
    ) -> tuple[np.ndarray, np.ndarray]:
        """Brute-force top-k: one code scan over-fetching
        max(4k, rescore_limit, k) candidates, then the exact host rescore.
        Returns (dists, ids)."""
        from weaviate_tpu_torch.index.flat import exact_rescore

        if not self.codes.device_resident:
            return self.host_topk(queries, k, allow)
        qrep = self.prep_queries(queries)
        if qrep.code is None:
            # pre-fit: exact over the (tiny) host corpus
            live = _live_under_allow(self.originals.valid, allow)
            if len(live) == 0:
                b = qrep.host.shape[0]
                return (
                    np.full((b, k), _INF, np.float32),
                    np.full((b, k), -1, np.int64),
                )
            ids = np.broadcast_to(live[None, :], (qrep.host.shape[0], len(live)))
            res = exact_rescore(
                qrep.host, ids, self.originals, self.metric, min(k, len(live))
            )
        else:
            planes, mask = self.codes.snapshot()
            cap = mask.shape[0]
            if allow is not None:
                al = np.asarray(allow, bool)
                if len(al) < cap:
                    al = np.pad(al, (0, cap - len(al)))
                mask = mask & torch.from_numpy(
                    np.ascontiguousarray(al[:cap])).to(mask.device)
            rescore_limit = getattr(self.quantizer.config, "rescore_limit", 0)
            fetch = max(4 * k, rescore_limit, k)
            chunk = self.config.search_chunk_size
            _, ids = self.quantizer.search(
                qrep.code, planes, fetch, mask, chunk if cap > chunk else 0)
            res = exact_rescore(qrep.host, ids.cpu().numpy(), self.originals,
                                self.metric, k)
        d = res.dists.astype(np.float32).copy()
        ids = res.ids.astype(np.int64)
        d[ids < 0] = _INF
        if ids.shape[1] < k:
            pad = k - ids.shape[1]
            ids = np.pad(ids, ((0, 0), (0, pad)), constant_values=-1)
            d = np.pad(d, ((0, 0), (0, pad)), constant_values=_INF)
        return d, ids

    def rescore_topk(
        self, queries: np.ndarray, cand_ids: np.ndarray, cand_d: np.ndarray, k: int
    ) -> tuple[np.ndarray, np.ndarray]:
        """Exact promotion of code-space candidates against the originals."""
        from weaviate_tpu_torch.index.flat import exact_rescore

        # metric prep (cosine normalization) must match the stored originals,
        # otherwise returned distances are scaled by ||q||
        q = self._prep_vectors(np.atleast_2d(queries))
        res = exact_rescore(q, cand_ids, self.originals, self.metric, k)
        d = res.dists.astype(np.float32).copy()
        ids = res.ids.astype(np.int64)
        d[ids < 0] = _INF
        return ids, d
