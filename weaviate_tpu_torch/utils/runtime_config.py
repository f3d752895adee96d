"""Runtime-mutable configuration (port of the registry in
``weaviate_tpu/utils/runtime_config.py``).

A ``DynamicValue`` wraps a knob that can be overridden at run time;
consumers call ``.get()`` on every use so a change lands without restart.
Only the knobs of ported modules are registered here, under the JAX
package's names and defaults.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Generic, Optional, TypeVar

T = TypeVar("T")


class DynamicValue(Generic[T]):
    """A named knob: default + optional runtime override."""

    __slots__ = ("name", "_default", "_override", "_cast")

    def __init__(self, name: str, default: T,
                 cast: Optional[Callable[[Any], T]] = None):
        self.name = name
        self._default = default
        self._override: Optional[T] = None
        self._cast = cast

    def get(self) -> T:
        ov = self._override
        return self._default if ov is None else ov

    def set_override(self, value: Any) -> None:
        if self._cast is not None:
            value = self._cast(value)
        elif self._default is not None:
            value = type(self._default)(value)
        self._override = value

    def clear_override(self) -> None:
        self._override = None

    @property
    def overridden(self) -> bool:
        return self._override is not None


class RuntimeConfig:
    """Registry of named knobs. The JAX package's file reload (an overrides
    JSON polled by a server thread) comes with the serving slice; until then
    an override is set on the knob itself (``set_override``)."""

    def __init__(self):
        self._values: dict[str, DynamicValue] = {}
        self._lock = threading.Lock()

    def register(self, name: str, default: T,
                 cast: Optional[Callable[[Any], T]] = None) -> DynamicValue[T]:
        with self._lock:
            dv = self._values.get(name)
            if dv is None:
                dv = DynamicValue(name, default, cast)
                self._values[name] = dv
            return dv

    def get(self, name: str, default: Any = None) -> Any:
        dv = self._values.get(name)
        return dv.get() if dv is not None else default

    def snapshot(self) -> dict[str, Any]:
        with self._lock:
            return {
                n: {"value": dv.get(), "overridden": dv.overridden}
                for n, dv in sorted(self._values.items())
            }


# process-wide registry
RUNTIME = RuntimeConfig()

# flat-scan selection default followed by indexes whose config leaves
# flat_approx_recall unset (-1): 0.0 = exact
FLAT_APPROX_RECALL_DEFAULT = RUNTIME.register("flat_approx_recall_default",
                                              0.0, cast=float)

# slow-query log threshold (monitoring/slow_query.py)
SLOW_QUERY_THRESHOLD_S = RUNTIME.register("slow_query_threshold_s", 0.5,
                                          cast=float)
# pauses every background maintenance cycle (utils/cycles.py)
MAINTENANCE_PAUSED = RUNTIME.register("maintenance_paused", False,
                                      cast=bool)
# fraction of request traces kept (monitoring/tracing.py)
TRACING_SAMPLE_RATE = RUNTIME.register(
    "tracing_sample_rate", 1.0, cast=float)
# tiered tenant store budget; the port refuses a budget > 0 until the
# tiering slice (core/db.py)
TIERING_HBM_BUDGET = RUNTIME.register(
    "tiering_hbm_budget_bytes", 0, cast=int)
# debt-driven compaction (core/db.py): merge when total debt crosses the
# target, at most this many merges a pass
COMPACTION_DEBT_TARGET_BYTES = RUNTIME.register(
    "compaction_debt_target_bytes", 64 << 20, cast=int)
COMPACTION_MAX_MERGES = RUNTIME.register(
    "compaction_max_merges", 2, cast=int)
# resident filter planes (query/planner/planes.py): an ad-hoc filter seen
# this many times auto-promotes to a device-resident bitmap plane; 0
# disables auto-promotion (declared planes still build). Max bounds the
# per-shard plane count.
FILTER_PLANE_PROMOTE_HITS = RUNTIME.register(
    "filter_plane_promote_hits", 3, cast=int)
FILTER_PLANE_MAX = RUNTIME.register("filter_plane_max", 8, cast=int)
# hybrid search (core/collection.py hybrid_search): each leg over-fetches
# ceil(factor * k) candidates so fusion has room beyond the final page
HYBRID_OVERFETCH_FACTOR = RUNTIME.register(
    "hybrid_overfetch_factor", 2.0, cast=float)
# the keyword leg's engine: "auto" scores FILTERED hybrid keyword legs on
# the device (ops/sparse.py, where WAND's skipping advantage collapses) and
# unfiltered ones with WAND on the host, "on" sends every hybrid keyword
# leg to the device, "off" every one to WAND
HYBRID_SPARSE_DEVICE = RUNTIME.register(
    "hybrid_sparse_device", "auto", cast=str)
