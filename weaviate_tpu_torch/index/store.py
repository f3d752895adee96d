"""Device-resident vector store with append watermark + tombstone mask
(port of the single-device ``DeviceVectorStore`` of
``weaviate_tpu/index/store.py``).

A padded ``[capacity, D]`` tensor indexed directly by internal doc id, plus
a validity mask and float32 squared norms, grown by doubling in pages of
4096 rows. Updates are copy-on-write: every write builds new tensors and
swaps the ``(corpus, valid, sqnorms)`` tuple in one assignment, so a search
holding an older ``snapshot()`` never sees half a batch. The mesh-sharded
store comes with the multi-GPU slice.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from weaviate_tpu_torch.compression.store import ResidencyMoved, TieredResidency
from weaviate_tpu_torch.ops.distance import normalize

_PAGE = 4096


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another. Raises when no card is present and none was named."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card; pass device='cpu' "
            "to run on the CPU")
    return torch.device("cuda")


# Out-of-place updates: a concurrent search may hold the old tensors.
def _scatter_impl(corpus, valid, sqnorms, ids, vecs, norms):
    return (corpus.index_copy(0, ids, vecs),
            valid.index_fill(0, ids, True),
            sqnorms.index_copy(0, ids, norms))


def _mask_off_impl(valid, ids):
    return valid.index_fill(0, ids, False)


def _grow_impl(corpus, valid, sqnorms, new_cap):
    d = corpus.shape[1]
    nc = corpus.new_zeros((new_cap, d))
    nc[: corpus.shape[0]] = corpus
    nv = valid.new_zeros((new_cap,))
    nv[: valid.shape[0]] = valid
    ns = sqnorms.new_zeros((new_cap,))
    ns[: sqnorms.shape[0]] = sqnorms
    return nc, nv, ns


def _to_bytes(t: torch.Tensor) -> bytes:
    """Raw little-endian bytes of a CPU tensor (bfloat16 included)."""
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.contiguous().numpy().tobytes()


def _dtype_name(dtype: torch.dtype) -> str:
    """The checkpoint's dtype string: numpy's name, or "bfloat16"."""
    if dtype == torch.bfloat16:
        return "bfloat16"
    return str(torch.empty((), dtype=dtype).numpy().dtype)


def _from_bytes(buf: bytes, dtype_name: str, rows: int, dims: int) -> torch.Tensor:
    if dtype_name == "bfloat16":
        if rows == 0:
            return torch.empty((0, dims), dtype=torch.bfloat16)
        t = torch.frombuffer(bytearray(buf), dtype=torch.bfloat16)
    else:
        t = torch.from_numpy(np.frombuffer(buf, np.dtype(dtype_name)).copy())
    return t.reshape(rows, dims)


class DeviceVectorStore(TieredResidency):
    """Doc-id-addressed [capacity, D] device tensor + validity mask + sq-norms."""

    def __init__(
        self,
        dims: int,
        capacity: int = _PAGE,
        dtype: torch.dtype = torch.float32,
        normalized: bool = False,
        device=None,
    ):
        self.dims = dims
        self.dtype = dtype
        self.normalized = normalized
        self.device = resolve_device(device)
        self._page = _PAGE
        cap = max(self._page, _round_up(capacity, self._page))
        # device state lives in ONE tuple swapped atomically so a concurrent
        # reader never sees corpus/valid/sqnorms of different generations
        self._state = (
            torch.zeros((cap, dims), dtype=dtype, device=self.device),
            torch.zeros((cap,), dtype=torch.bool, device=self.device),
            torch.zeros((cap,), dtype=torch.float32, device=self.device),
        )
        # warm tier: when detached, the device tuple is replaced by a host
        # (CPU tensor) mirror and every device accessor raises
        self._host_state: Optional[tuple] = None
        # warm-tier unfiltered (live_ids, gathered rows) view, built lazily
        # by host_store_topk; valid only while detached
        self._warm_live_cache: Optional[tuple] = None
        self._host_valid = np.zeros((cap,), bool)  # host mirror of valid
        self._watermark = 0  # max assigned id + 1
        self._live = 0

    # -- residency (warm tier; protocol on TieredResidency) ----------------
    def detach(self) -> int:
        """Demote to the warm tier: copy the device triple to host RAM and
        drop the device references. Returns device bytes released. Readers
        holding an older ``snapshot()`` keep their tensors alive; new
        readers must take the host tier until ``attach``."""
        if self._host_state is not None:
            return 0
        freed = sum(_nbytes(a) for a in self._state)
        self._host_state = tuple(a.cpu() for a in self._state)
        self._state = None
        self._warm_live_cache = None
        return freed

    def attach(self) -> int:
        """Promote back to the device. Returns device bytes charged."""
        if self._host_state is None:
            return 0
        corpus, valid, sqnorms = self._host_state
        self._state = (corpus.to(self.device, self.dtype),
                       valid.to(self.device), sqnorms.to(self.device))
        self._host_state = None
        self._warm_live_cache = None
        return sum(_nbytes(a) for a in self._state)

    @property
    def host_arrays(self) -> tuple:
        """(corpus, valid, sqnorms) as CPU tensors — the warm search tier.
        Only valid while detached."""
        hs = self._host_state
        if hs is None:
            raise ResidencyMoved(
                "store is device-resident; use snapshot()")
        return hs

    # -- properties -------------------------------------------------------
    @property
    def capacity(self) -> int:
        hs = self._host_state
        if hs is not None:
            return hs[0].shape[0]
        return self._device_state()[0].shape[0]

    @property
    def watermark(self) -> int:
        return self._watermark

    @property
    def live_count(self) -> int:
        return self._live

    @property
    def nbytes(self) -> int:
        """Device footprint: corpus + validity mask + sq-norms; zero while
        detached to the warm tier."""
        s = self._state
        if s is None:
            return 0
        return sum(_nbytes(a) for a in s)

    @property
    def host_bytes(self) -> int:
        """Host-RAM footprint of the warm tier (0 while device-resident)."""
        hs = self._host_state
        if hs is None:
            return 0
        return sum(_nbytes(a) for a in hs)

    def snapshot(self) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Consistent (corpus, valid, sqnorms) triple — the only safe way to
        read device state from search threads."""
        return self._device_state()

    @property
    def corpus(self) -> torch.Tensor:
        return self._device_state()[0]

    @property
    def valid_mask(self) -> torch.Tensor:
        return self._device_state()[1]

    @property
    def host_valid_mask(self) -> np.ndarray:
        """Incrementally-maintained host copy (no device transfer)."""
        return self._host_valid

    @property
    def sqnorms(self) -> torch.Tensor:
        return self._device_state()[2]

    # -- mutation ---------------------------------------------------------
    def ensure_capacity(self, min_capacity: int) -> None:
        if min_capacity <= self.capacity:
            return
        self._require_device()  # writers promote before growing
        cap = self.capacity
        new_cap = _round_up(max(min_capacity, cap * 2), self._page)
        self._state = _grow_impl(*self._state, new_cap=new_cap)
        hv = np.zeros((new_cap,), bool)
        hv[: len(self._host_valid)] = self._host_valid
        self._host_valid = hv

    def put(self, doc_ids: np.ndarray, vectors: np.ndarray) -> None:
        doc_ids = np.asarray(doc_ids, np.int32)
        vectors = np.asarray(vectors, np.float32)
        if vectors.ndim != 2 or vectors.shape[1] != self.dims:
            raise ValueError(
                f"expected vectors [n, {self.dims}], got {vectors.shape}"
            )
        if len(doc_ids) == 0:
            return
        self._require_device()  # ingest promotes the tenant first
        self.ensure_capacity(int(doc_ids.max()) + 1)
        vt = torch.from_numpy(np.ascontiguousarray(vectors)).to(
            self.device, self.dtype)
        if self.normalized:
            vt = normalize(vt)
        norms = torch.sum(vt.float() ** 2, dim=-1)
        prev_valid = self._host_valid[doc_ids]
        ids = torch.from_numpy(doc_ids.astype(np.int64)).to(self.device)
        self._state = _scatter_impl(*self._state, ids, vt, norms)
        self._host_valid[doc_ids] = True
        self._live += int((~prev_valid).sum())
        self._watermark = max(self._watermark, int(doc_ids.max()) + 1)

    def delete(self, doc_ids: np.ndarray) -> None:
        doc_ids = np.asarray(doc_ids, np.int32)
        if len(doc_ids) == 0:
            return
        self._require_device()  # writers promote before mutating
        doc_ids = doc_ids[doc_ids < self.capacity]
        was = self._host_valid[doc_ids]
        corpus, valid, sqnorms = self._state
        ids = torch.from_numpy(doc_ids.astype(np.int64)).to(self.device)
        self._state = (corpus, _mask_off_impl(valid, ids), sqnorms)
        self._host_valid[doc_ids] = False
        self._live -= int(was.sum())

    def get(self, doc_ids: np.ndarray) -> np.ndarray:
        """Host gather as float32 (debug/rescore path; serves from either
        tier)."""
        ids = torch.from_numpy(np.asarray(doc_ids, np.int64))
        hs = self._host_state
        if hs is not None:
            return hs[0][ids].float().numpy()
        corpus = self._device_state()[0]
        return corpus[ids.to(corpus.device)].float().cpu().numpy()

    def contains(self, doc_id: int) -> bool:
        if doc_id >= self.capacity:
            return False
        return bool(self._host_valid[doc_id])

    # -- checkpoint ---------------------------------------------------------
    # The same msgpack format as the JAX store (version 1: packed valid bits,
    # raw corpus and sqnorms up to the watermark), so either package reads
    # the other's file.
    def save(self, path: str, meta: Optional[dict] = None) -> None:
        import msgpack

        corpus, _valid, sqnorms = (self._host_state if self._host_state
                                   is not None else self._state)
        wm = self._watermark
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(msgpack.packb({
                "version": 1,
                "meta": meta or {},
                "dims": self.dims,
                "dtype": _dtype_name(self.dtype),
                "watermark": wm,
                "live": self._live,
                "normalized": self.normalized,
                "valid": np.packbits(self._host_valid[:wm]).tobytes(),
                "corpus": _to_bytes(corpus[:wm].cpu()),
                "sqnorms": _to_bytes(sqnorms[:wm].cpu()),
            }, use_bin_type=True))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    def load(self, path: str) -> Optional[dict]:
        """Restore from ``save``; returns the saved ``meta`` dict, or None
        when the file is absent/incompatible."""
        import msgpack

        if not os.path.exists(path):
            return None
        try:
            with open(path, "rb") as f:
                d = msgpack.unpackb(f.read(), raw=False)
            if d.get("version") != 1 or d["dims"] != self.dims:
                return None
            wm = d["watermark"]
            host = _from_bytes(d["corpus"], d["dtype"], wm, self.dims)
            norms = np.frombuffer(d["sqnorms"], np.float32)
            hv = np.unpackbits(
                np.frombuffer(d["valid"], np.uint8), count=wm).astype(bool)
        except (OSError, ValueError, KeyError, TypeError, AttributeError,
                RuntimeError):
            # absent/torn/foreign-dtype file: caller rebuilds from source
            return None
        self.ensure_capacity(max(wm, 1))
        cap = self.capacity
        full = torch.zeros((cap, self.dims), dtype=self.dtype)
        full[:wm] = host.to(self.dtype)
        fv = np.zeros(cap, bool)
        fv[:wm] = hv
        fn = np.zeros(cap, np.float32)
        fn[:wm] = norms
        self._state = (full.to(self.device), torch.from_numpy(fv).to(self.device),
                       torch.from_numpy(fn).to(self.device))
        self._host_state = None  # a restored store is device-resident
        self._host_valid = fv.copy()
        self._watermark = wm
        self._live = d["live"]
        return d.get("meta", {})


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _round_up(n: int, page: int = _PAGE) -> int:
    """Round capacity up to a page multiple."""
    return ((n + page - 1) // page) * page
