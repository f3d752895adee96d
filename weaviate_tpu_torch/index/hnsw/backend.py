"""Warm-tier exact search over a detached store's host corpus (port of
``host_exact_topk``, ``_live_under_allow`` and ``host_store_topk`` from
``weaviate_tpu/index/hnsw/backend.py``; the HNSW backends come with the
HNSW slice).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from weaviate_tpu_torch.index.store import DeviceVectorStore

_INF = np.float32(np.inf)


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
