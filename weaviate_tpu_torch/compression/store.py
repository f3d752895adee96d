"""Warm-tier residency protocol (port of the residency part of
``weaviate_tpu/compression/store.py``).

``DeviceArraySet`` and ``HostVectorStore`` come with the quantizer slice.
"""

from __future__ import annotations

from typing import Optional


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
