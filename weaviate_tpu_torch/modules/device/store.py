"""Candidate token planes: the device residency of the rerank tier (port
of ``weaviate_tpu/modules/device/store.py``).

The rerank stage gathers each candidate's token set on the card, so the
token sets live there as doc-id-addressed planes: ``tokens [cap, T, D]``
float32 and ``mask [cap, T]`` bool. The host copy is authoritative (writes
land there first; the device copy scatters the dirty rows before a search,
as ``ops/device_beam.py DeviceAdjacency`` does), which makes the host
tiers and the warm demotion free: dropping the device planes loses
nothing. ``T`` is a power of two; the capacity follows the owning index's
``cap_fn`` so candidate ids index both planes alike.

Unlike the JAX store, the scatter of dirty rows is in place
(``index_copy_``): an out-of-place copy would hold two token planes on the
card. It is ordered on the current stream after any launch that read the
planes before it. The mesh form (row-sharded planes) comes with slice 11.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np
import torch


def _pow2(n: int) -> int:
    return 1 << max(0, (max(1, n) - 1).bit_length())


class CandidateTokenStore:
    def __init__(self, dims: int, max_tokens: int = 8,
                 cap_fn: Optional[Callable[[], int]] = None,
                 mesh=None, initial_capacity: int = 1024, device=None):
        if mesh is not None:
            raise NotImplementedError(
                "mesh-sharded token planes: not ported yet (ROADMAP queue "
                "A, slice 11)")
        from weaviate_tpu_torch.index.store import resolve_device

        self.device = resolve_device(device)
        self.dims = dims
        self.tmax = _pow2(max_tokens)
        self.cap_fn = cap_fn
        self.mesh = None
        cap = self._target_capacity(initial_capacity)
        self._tokens = np.zeros((cap, self.tmax, dims), np.float32)
        self._mask = np.zeros((cap, self.tmax), bool)
        self._dev: Optional[tuple] = None
        self._dev_shape: Optional[tuple] = None
        self._dirty: set[int] = set()

    # -- host-authoritative writes ---------------------------------------
    def _target_capacity(self, need: int) -> int:
        cap = max(1024, need)
        if self.cap_fn is not None:
            # aligned to the index's device plane, so ids index both alike
            cap = max(cap, int(self.cap_fn()))
        return cap

    def _ensure(self, need_rows: int, need_tokens: int) -> None:
        cap = self._target_capacity(need_rows)
        tmax = self.tmax if need_tokens <= self.tmax else _pow2(need_tokens)
        if cap <= self._tokens.shape[0] and tmax == self.tmax:
            return
        cap = max(cap, self._tokens.shape[0])
        grown_t = np.zeros((cap, tmax, self.dims), np.float32)
        grown_m = np.zeros((cap, tmax), bool)
        old = self._tokens.shape[0]
        grown_t[:old, : self.tmax] = self._tokens
        grown_m[:old, : self.tmax] = self._mask
        self._tokens, self._mask, self.tmax = grown_t, grown_m, tmax
        # the shape moved: the device copy re-uploads wholesale on the next
        # sync
        self._dev = None
        self._dirty.clear()

    def put(self, doc_ids: np.ndarray, token_sets) -> None:
        doc_ids = np.asarray(doc_ids, np.int64).reshape(-1)
        if len(doc_ids) == 0:
            return
        if isinstance(token_sets, np.ndarray) and token_sets.ndim == 3:
            # a uniform [m, T, D] block: one vectorized write
            t = token_sets.astype(np.float32, copy=False)
            self._ensure(int(doc_ids.max()) + 1, t.shape[1])
            self._tokens[doc_ids, : t.shape[1]] = t
            self._tokens[doc_ids, t.shape[1]:] = 0.0
            self._mask[doc_ids, : t.shape[1]] = True
            self._mask[doc_ids, t.shape[1]:] = False
            self._dirty.update(int(d) for d in doc_ids)
        else:
            sets = [np.atleast_2d(np.asarray(t, np.float32))
                    for t in token_sets]
            self._ensure(int(doc_ids.max()) + 1,
                         max(s.shape[0] for s in sets))
            for d, t in zip(doc_ids, sets):
                d = int(d)
                n = t.shape[0]
                self._tokens[d, :n] = t
                self._tokens[d, n:] = 0.0
                self._mask[d, :n] = True
                self._mask[d, n:] = False
                self._dirty.add(d)
        if len(self._dirty) > self._tokens.shape[0] // 2:
            # more dirty rows than a scatter is worth: the next sync
            # re-uploads wholesale
            self._dev = None
            self._dirty.clear()

    def delete(self, doc_ids: np.ndarray) -> None:
        cap = self._tokens.shape[0]
        for d in np.asarray(doc_ids, np.int64).reshape(-1):
            d = int(d)
            if d < cap:
                self._mask[d] = False
                self._dirty.add(d)

    # -- reads ------------------------------------------------------------
    def host_planes(self) -> tuple[np.ndarray, np.ndarray]:
        """(tokens, mask) host arrays: the host tiers' scoring source and
        the device copy's upload source."""
        return self._tokens, self._mask

    def sync(self, min_rows: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
        """-> (tokens [cap, T, D] float32, mask [cap, T] bool) on the
        store's device, up to date: a wholesale upload after a shape change
        or a demotion, a scatter of the dirty rows otherwise. ``min_rows``:
        the caller's candidate-id space (the graph's or the corpus's rows),
        which the planes must cover."""
        self._ensure(max(1, min_rows), self.tmax)
        shape = self._tokens.shape
        if self._dev is None or self._dev_shape != shape:
            self._dev = None  # release the old planes before the upload
            self._dev = (torch.from_numpy(self._tokens).to(self.device),
                         torch.from_numpy(self._mask).to(self.device))
            self._dev_shape = shape
            self._dirty.clear()
            return self._dev
        if self._dirty:
            # swap the set first: writers keep adding ids while this runs
            dirty, self._dirty = self._dirty, set()
            idx = np.fromiter((i for i in dirty if i < shape[0]), np.int64)
            if len(idx):
                idx.sort()
                toks, mask = self._dev
                it = torch.from_numpy(idx).to(self.device)
                toks.index_copy_(0, it, torch.from_numpy(
                    self._tokens[idx]).to(self.device))
                mask.index_copy_(0, it, torch.from_numpy(
                    self._mask[idx]).to(self.device))
        return self._dev

    # -- tiered residency -------------------------------------------------
    @property
    def device_resident(self) -> bool:
        return self._dev is not None

    @property
    def nbytes(self) -> int:
        """Device bytes of the mirrored planes (0 while demoted)."""
        if self._dev is None:
            return 0
        return sum(a.numel() * a.element_size() for a in self._dev)

    @property
    def host_bytes(self) -> int:
        return self._tokens.nbytes + self._mask.nbytes

    def drop_device(self) -> int:
        """Release the planes from the card (warm demotion); the host copy
        is authoritative. Returns bytes released."""
        freed = self.nbytes
        self._dev = None
        self._dev_shape = None
        self._dirty.clear()
        return freed

    # -- checkpoint (the JAX store's sidecar format) ------------------------
    def save(self, path: str) -> None:
        """Persist the host planes as an atomic sidecar next to the owning
        index's checkpoint (``<path>.rrtok.npz``)."""
        tmp = path + ".rrtok.tmp.npz"
        np.savez_compressed(tmp, tokens=self._tokens, mask=self._mask)
        os.replace(tmp, path + ".rrtok.npz")

    def load(self, path: str) -> bool:
        """Restore the host planes from the sidecar; False when absent or
        corrupt (half a checkpoint is no checkpoint)."""
        p = path + ".rrtok.npz"
        if not os.path.exists(p):
            return False
        try:
            with np.load(p) as z:
                tokens = z["tokens"]
                mask = z["mask"]
        except (OSError, ValueError, KeyError):
            return False
        if tokens.ndim != 3 or tokens.shape[2] != self.dims \
                or mask.shape != tokens.shape[:2]:
            return False
        self._tokens = tokens.astype(np.float32, copy=False)
        self._mask = mask.astype(bool, copy=False)
        self.tmax = tokens.shape[1]
        self._dev = None
        self._dev_shape = None
        self._dirty.clear()
        return True
