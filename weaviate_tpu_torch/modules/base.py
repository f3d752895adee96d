"""Module SPI base (port of the ``Module`` class of
``weaviate_tpu/modules/base.py``).

Reference: ``entities/modulecapabilities/module.go:45``. A module declares
its name and capabilities; the registry that wires providers into the
write and query paths comes with slice 9. The port keeps only the base
that ``modules/device/base.py DeviceRerankerProvider`` derives from.
"""

from __future__ import annotations

import abc
from typing import Optional


class Module(abc.ABC):
    """Base module: name + capability discovery. ``module_type`` names the
    capability; a module that declares none is an ``extension``."""

    name: str = "module"

    def init(self, config: Optional[dict] = None) -> None:
        """Late init hook (reference InitExtension/InitVectorizer)."""

    def meta(self) -> dict:
        return {"name": self.name, "type": self.module_type()}

    def module_type(self) -> str:
        return "extension"
