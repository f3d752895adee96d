"""Growable device-resident code planes, the host store of the original
vectors, and the warm-tier residency protocol (port of
``weaviate_tpu/compression/store.py``, one device).

``DeviceArraySet`` is the compressed analogue of ``index/store.py``'s
``DeviceVectorStore``: device memory holds only the quantized code planes,
addressed by doc id, with a validity mask. Its updates are copy-on-write:
every write builds new tensors and swaps the ``(planes, valid)`` tuple in one
assignment, so a search holding an older ``snapshot()`` sees one consistent
generation. ``HostVectorStore`` keeps the full-precision originals in host
RAM for the exact rescore tier, as float32 (``ram``) or float16 (``ram16``);
the disk-paged tiers come with slice 9 and the mesh-sharded planes with
slice 11.

A ``uint32`` plane (BQ's packed bits) is held as an ``int32`` tensor with
the same bits, since torch has no full ``uint32`` arithmetic; ``to_numpy``
views it back as ``uint32``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

_PAGE = 4096


class ResidencyMoved(RuntimeError):
    """A reader raced a tier move: the arrays it was promised moved between
    its residency check and the access. Search entry points catch this and
    retry against the settled tier — both tiers can serve any query, so a
    flip must never fail one."""


class TieredResidency:
    """Shared warm-tier residency protocol. The device state lives in
    ``_state`` and its detached host mirror in ``_host_state`` — exactly one
    is non-None at any time. Subclasses own ``detach``/``attach``; the
    check-then-raise accessors live here so the single-read rule — read
    ``_state`` once, never check one attribute and then dereference the
    other — is the same for every store."""

    _state = None
    _host_state: Optional[tuple] = None
    _DETACHED_MSG = ("arrays are detached (warm tier): device access "
                     "would silently re-rent device memory — attach() first")

    @property
    def device_resident(self) -> bool:
        return self._host_state is None

    def _require_device(self) -> None:
        if self._host_state is not None:
            raise ResidencyMoved(self._DETACHED_MSG)

    def _device_state(self):
        """The device state, or ResidencyMoved if a detach raced the
        caller's residency check."""
        s = self._state
        if s is None:
            raise ResidencyMoved(self._DETACHED_MSG)
        return s


def _round_up(n: int, page: int = _PAGE) -> int:
    return ((n + page - 1) // page) * page


def torch_dtype(dtype) -> torch.dtype:
    """The tensor dtype holding a numpy plane dtype (uint32 as int32 bits)."""
    dtype = np.dtype(dtype)
    if dtype == np.uint32:
        return torch.int32
    return torch.from_numpy(np.zeros(0, dtype)).dtype


def to_tensor(values: np.ndarray, dtype) -> torch.Tensor:
    """A CPU tensor of ``values`` cast to the numpy plane ``dtype``
    (uint32 viewed as int32 bits)."""
    arr = np.ascontiguousarray(np.asarray(values).astype(dtype, copy=False))
    if not arr.flags.writeable:
        arr = arr.copy()
    if arr.dtype == np.uint32:
        arr = arr.view(np.int32)
    return torch.from_numpy(arr)


def to_numpy(t: torch.Tensor, dtype) -> np.ndarray:
    """The numpy array of plane tensor ``t`` in its numpy ``dtype``."""
    arr = t.detach().cpu().numpy()
    if np.dtype(dtype) == np.uint32:
        return arr.view(np.uint32)
    return arr


# Out-of-place updates: a concurrent search may hold the old tensors.
def _das_scatter_impl(arrays, valid, ids, values):
    out = dict(arrays)
    for name, val in values.items():
        out[name] = out[name].index_copy(0, ids, val)
    return out, valid.index_fill(0, ids, True)


def _das_mask_off_impl(valid, ids):
    return valid.index_fill(0, ids, False)


def _das_grow_impl(arrays, valid, new_cap):
    grown = {}
    for name, arr in arrays.items():
        na = arr.new_zeros((new_cap, *arr.shape[1:]))
        na[: arr.shape[0]] = arr
        grown[name] = na
    nv = valid.new_zeros((new_cap,))
    nv[: valid.shape[0]] = valid
    return grown, nv


class DeviceArraySet(TieredResidency):
    """Named device tensors sharing a doc-id-addressed leading dim + validity.

    fields: name -> (trailing_shape tuple, numpy dtype). All planes grow
    together by doubling in pages of 4096 rows."""

    def __init__(self, fields: dict[str, tuple[tuple[int, ...], np.dtype]],
                 capacity: int = _PAGE, device=None):
        from weaviate_tpu_torch.index.store import resolve_device

        self.fields = fields
        self.device = resolve_device(device)
        self._page = _PAGE
        cap = max(self._page, _round_up(capacity, self._page))
        # (planes, valid) live in ONE tuple swapped atomically: a concurrent
        # search never pairs new-capacity planes with an old-capacity mask
        self._state: Optional[tuple[dict[str, torch.Tensor], torch.Tensor]] = (
            {name: torch.zeros((cap, *shape), dtype=torch_dtype(dtype),
                               device=self.device)
             for name, (shape, dtype) in fields.items()},
            torch.zeros((cap,), dtype=torch.bool, device=self.device),
        )
        self._host_valid = np.zeros((cap,), bool)
        # warm tier: detached planes live here as CPU tensors; device
        # accessors raise until attach
        self._host_state: Optional[tuple] = None
        self._watermark = 0
        self._live = 0

    # -- residency (warm tier; protocol on TieredResidency) ----------------
    def detach(self) -> int:
        """Demote the code planes to host RAM; returns device bytes
        released. Readers holding an old snapshot keep their tensors."""
        if self._host_state is not None:
            return 0
        arrays, valid = self._state
        freed = self.nbytes
        self._host_state = ({name: a.cpu() for name, a in arrays.items()},
                            valid.cpu())
        self._state = None
        return freed

    def attach(self) -> int:
        """Re-upload the code planes at identical shapes and dtypes.
        Returns device bytes charged."""
        if self._host_state is None:
            return 0
        arrays, valid = self._host_state
        self._state = ({name: a.to(self.device) for name, a in arrays.items()},
                       valid.to(self.device))
        self._host_state = None
        return self.nbytes

    @property
    def host_bytes(self) -> int:
        hs = self._host_state
        if hs is None:
            return 0
        arrays, valid = hs
        return sum(_nbytes(a) for a in arrays.values()) + _nbytes(valid)

    @property
    def capacity(self) -> int:
        hs = self._host_state
        if hs is not None:
            return hs[1].shape[0]
        return self._device_state()[1].shape[0]

    @property
    def watermark(self) -> int:
        return self._watermark

    @property
    def live_count(self) -> int:
        return self._live

    @property
    def valid_mask(self) -> torch.Tensor:
        return self._device_state()[1]

    @property
    def nbytes(self) -> int:
        """Device footprint of all code planes + the valid mask (zero while
        detached to the warm tier)."""
        s = self._state
        if s is None:
            return 0
        arrays, valid = s
        return sum(_nbytes(a) for a in arrays.values()) + _nbytes(valid)

    @property
    def host_valid_mask(self) -> np.ndarray:
        return self._host_valid

    def __getitem__(self, name: str) -> torch.Tensor:
        return self._device_state()[0][name]

    def snapshot(self) -> tuple[dict[str, torch.Tensor], torch.Tensor]:
        """Consistent (planes, valid) pair for search threads — mutations
        swap the whole state tuple, never edit it in place."""
        return self._device_state()

    def ensure_capacity(self, min_capacity: int) -> None:
        if min_capacity <= self.capacity:
            return
        self._require_device()  # writers promote before growing
        cap = self.capacity
        new_cap = _round_up(max(min_capacity, cap * 2), self._page)
        arrays, valid = self._state
        hv = np.zeros((new_cap,), bool)
        hv[: len(self._host_valid)] = self._host_valid
        # swap the state tuple after every plane is built
        self._state = _das_grow_impl(arrays, valid, new_cap=new_cap)
        self._host_valid = hv

    def put(self, doc_ids: np.ndarray, values: dict[str, np.ndarray]) -> None:
        doc_ids = np.asarray(doc_ids, np.int32)
        if len(doc_ids) == 0:
            return
        self._require_device()  # ingest promotes the tenant first
        self.ensure_capacity(int(doc_ids.max()) + 1)
        idx = torch.from_numpy(doc_ids.astype(np.int64)).to(self.device)
        arrays, valid = self._state
        vals = {name: (val if torch.is_tensor(val) else
                       to_tensor(val, self.fields[name][1])).to(
                           self.device, arrays[name].dtype)
                for name, val in values.items()}
        self._state = _das_scatter_impl(arrays, valid, idx, vals)
        prev = self._host_valid[doc_ids]
        self._host_valid[doc_ids] = True
        self._live += int((~prev).sum())
        self._watermark = max(self._watermark, int(doc_ids.max()) + 1)

    def delete(self, doc_ids: np.ndarray) -> None:
        doc_ids = np.asarray(doc_ids, np.int32)
        if len(doc_ids) == 0:
            return
        self._require_device()  # writers promote before mutating
        doc_ids = doc_ids[doc_ids < self.capacity]
        was = self._host_valid[doc_ids]
        arrays, valid = self._state
        idx = torch.from_numpy(doc_ids.astype(np.int64)).to(self.device)
        self._state = (arrays, _das_mask_off_impl(valid, idx))
        self._host_valid[doc_ids] = False
        self._live -= int(was.sum())


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


# raw tiers of the originals: float32 or float16 in host RAM
_RAM_TIERS = {"ram": np.float32, "ram16": np.float16}


def raw_tier_dtype(tier: str):
    """The host dtype of a raw tier; the disk tiers raise (slice 9)."""
    if tier in ("disk16", "disk8"):
        raise NotImplementedError(
            f"raw_tier {tier!r} (disk-paged originals): not ported yet "
            "(ROADMAP queue A, slice 9)")
    if tier not in _RAM_TIERS:
        raise ValueError(f"invalid raw_tier {tier!r}")
    return _RAM_TIERS[tier]


class HostVectorStore:
    """Doc-id-addressed originals on the host (the rescore/refit tier).

    ``dtype`` selects the residency tier: float32 RAM (``ram``, the
    default) or float16 RAM (``ram16``, half the footprint)."""

    def __init__(self, dims: int, capacity: int = _PAGE, dtype=np.float32):
        self.dims = dims
        self.dtype = np.dtype(dtype)
        if self.dtype not in (np.dtype(np.float32), np.dtype(np.float16)):
            raise NotImplementedError(
                f"host originals as {self.dtype}: only the ram (float32) and "
                "ram16 (float16) tiers are ported; the disk tiers come with "
                "slice 9")
        self._vecs = np.zeros((max(_PAGE, _round_up(capacity)), dims),
                              self.dtype)
        self._valid = np.zeros((self._vecs.shape[0],), bool)
        self._watermark = 0

    @property
    def nbytes(self) -> int:
        return self._vecs.shape[0] * self.dims * self.dtype.itemsize

    @property
    def capacity(self) -> int:
        return self._vecs.shape[0]

    @property
    def watermark(self) -> int:
        return self._watermark

    @property
    def live_count(self) -> int:
        return int(self._valid.sum())

    @property
    def valid(self) -> np.ndarray:
        return self._valid

    def ensure_capacity(self, min_capacity: int) -> None:
        if min_capacity <= self.capacity:
            return
        new_cap = _round_up(max(min_capacity, self.capacity * 2))
        nv = np.zeros((new_cap, self.dims), self.dtype)
        nv[: self._vecs.shape[0]] = self._vecs
        self._vecs = nv
        va = np.zeros((new_cap,), bool)
        va[: len(self._valid)] = self._valid
        self._valid = va

    def put(self, doc_ids: np.ndarray, vectors: np.ndarray) -> None:
        doc_ids = np.asarray(doc_ids, np.int64)
        if len(doc_ids) == 0:
            return
        self.ensure_capacity(int(doc_ids.max()) + 1)
        self._vecs[doc_ids] = np.asarray(vectors).astype(self.dtype,
                                                         copy=False)
        self._valid[doc_ids] = True
        self._watermark = max(self._watermark, int(doc_ids.max()) + 1)

    def delete(self, doc_ids: np.ndarray) -> None:
        doc_ids = np.asarray(doc_ids, np.int64)
        doc_ids = doc_ids[doc_ids < self.capacity]
        self._valid[doc_ids] = False

    def get(self, doc_ids: np.ndarray) -> np.ndarray:
        out = self._vecs[np.asarray(doc_ids, np.int64)]
        return out.astype(np.float32) if out.dtype != np.float32 else out

    def sample(self, limit: int, seed: int = 0) -> np.ndarray:
        """Up to ``limit`` live vectors (quantizer training sample)."""
        live = np.flatnonzero(self._valid)
        if len(live) > limit:
            rng = np.random.default_rng(seed)
            live = rng.choice(live, size=limit, replace=False)
        return self._vecs[live].astype(np.float32, copy=False)

    def all_live(self) -> tuple[np.ndarray, np.ndarray]:
        live = np.flatnonzero(self._valid)
        return live, self._vecs[live]
