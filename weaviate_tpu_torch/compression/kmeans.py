"""Segmented k-means: PQ codebook training (port of
``weaviate_tpu/compression/kmeans.py``).

Reference: ``adapters/repos/db/vector/kmeans/`` (plain Lloyd's iterations used
by ``compressionhelpers/kmeans_encoder.go``). All M segments train together:
the assignment step is one batched product ``[S, n, d] x [S, d, c]`` and an
``argmin``, the update step an ``index_add_``. They are plain torch ops on
the card unless the caller names another device (the index's device on
the card path), with float32 products as the JAX program's: TF32 stays
off, which is PyTorch's default (``ops/distance.py``).

Ties follow the JAX program: the assignment takes the first centroid of
equal distances (``jnp.argmin``), and the empty-cluster reseed takes the
farthest points with the lower point first on equal residuals
(``lax.top_k``): a stable descending sort, not ``torch.topk``, whose order
among ties is not promised.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch


def _assign_chunked(data: torch.Tensor, centroids: torch.Tensor,
                    chunk: int) -> torch.Tensor:
    """Nearest-centroid assignment. data [S, n, d], centroids [S, c, d] ->
    [S, n] int64, in chunks of ``chunk`` points so the [S, chunk, c]
    distance block stays bounded."""
    s, n, _ = data.shape
    cn = torch.sum(centroids * centroids, dim=-1)  # [S, c]
    ct = centroids.transpose(1, 2)
    out = torch.empty((s, n), dtype=torch.int64, device=data.device)
    for start in range(0, n, chunk):
        ip = torch.bmm(data[:, start:start + chunk], ct)  # [S, chunk, c]
        # argmin of ||x-c||^2 == argmin of -2 x.c + ||c||^2
        d2 = cn[:, None, :] - 2.0 * ip
        out[:, start:start + chunk] = torch.argmin(d2, dim=-1)
    return out


def _lloyd(data: torch.Tensor, centroids: torch.Tensor, iters: int,
           chunk: int) -> torch.Tensor:
    """Lloyd's iterations over all segments at once. The reseed takes the
    ``c`` farthest points, so it needs at least ``c`` points (JAX's
    ``lax.top_k`` refuses fewer too)."""
    s, n, d = data.shape
    c = centroids.shape[1]
    if n < c:
        raise ValueError(f"k-means of {c} centroids needs at least {c} "
                         f"points, got {n}")
    flat = data.reshape(s * n, d)
    base = (torch.arange(s, device=data.device) * c)[:, None]  # [S, 1]
    ones = torch.ones(s * n, device=data.device)
    cents = centroids
    for _ in range(iters):
        assign = _assign_chunked(data, cents, chunk)
        slot = (base + assign).reshape(-1)
        sums = torch.zeros((s * c, d), device=data.device).index_add_(
            0, slot, flat).view(s, c, d)
        counts = torch.zeros(s * c, device=data.device).index_add_(
            0, slot, ones).view(s, c)
        new = sums / torch.clamp(counts[..., None], min=1.0)
        # Empty clusters reseed to the points farthest from their assigned
        # centroid: the i-th empty slot takes the i-th farthest point
        own = torch.gather(new, 1, assign[..., None].expand(s, n, d))
        resid = torch.sum((data - own) ** 2, dim=-1)  # [S, n]
        far = torch.sort(resid, dim=1, descending=True,
                         stable=True).indices[:, :c]
        far_pts = torch.gather(data, 1, far[..., None].expand(-1, -1, d))
        empty = counts <= 0
        rank = torch.cumsum(empty.to(torch.int64), dim=1) - 1  # [S, c]
        reseed = torch.gather(far_pts, 1,
                              rank.clamp(0, c - 1)[..., None].expand(s, c, d))
        cents = torch.where(empty[..., None], reseed, new)
    return cents


def segmented_kmeans(data: np.ndarray, n_centroids: int, iters: int = 10,
                     seed: int = 0, assign_chunk: int = 16384,
                     device=None) -> np.ndarray:
    """Train one k-means per segment. data [S, n, d] -> centroids [S, c, d]
    float32 numpy, trained on ``device`` (the card when None).

    Init = random sample of the data, drawn with the JAX package's numpy
    calls (the same picks from the same seed)."""
    data = np.asarray(data, np.float32)
    _, n, _ = data.shape
    rng = np.random.default_rng(seed)
    if n >= n_centroids:
        picks = rng.choice(n, size=n_centroids, replace=False)
    else:
        picks = rng.integers(0, n, size=n_centroids)
    from weaviate_tpu_torch.index.store import resolve_device

    dev = resolve_device(device)
    x = torch.from_numpy(np.ascontiguousarray(data)).to(dev)
    init = x[:, torch.from_numpy(picks).to(dev)]  # [S, c, d]
    chunk = min(assign_chunk, max(256, n))
    return _lloyd(x, init, iters, chunk).cpu().numpy()


def assign_codes(data: np.ndarray,
                 centroids: Union[np.ndarray, torch.Tensor],
                 chunk: int = 16384, device=None) -> np.ndarray:
    """Encode: nearest-centroid codes. data [S, n, d], centroids [S, c, d]
    (numpy, or a float32 tensor the caller keeps on the device) -> [S, n],
    uint8 when c <= 256 (the PQ case), else int32. Runs on ``device`` (the
    card when None)."""
    from weaviate_tpu_torch.index.store import resolve_device

    dev = resolve_device(device)
    x = torch.from_numpy(np.ascontiguousarray(data, np.float32)).to(dev)
    cents = torch.as_tensor(centroids, dtype=torch.float32, device=dev)
    a = _assign_chunked(x, cents, min(chunk, max(256, x.shape[1])))
    if cents.shape[1] <= 256:
        return a.to(torch.uint8).cpu().numpy()
    return a.to(torch.int32).cpu().numpy()
