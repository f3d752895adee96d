"""Property-based result sorting.

Reference: ``adapters/repos/db/sorter/`` — sorts result sets by one or more
property paths (asc/desc) with typed comparators; special paths ``id``,
``_creationTimeUnix``, ``_lastUpdateTimeUnix``. Objects missing the property
sort last regardless of order, like the reference's null handling.
"""

from __future__ import annotations

from typing import Any, Optional

from weaviate_tpu_torch.storage.objects import StorageObject


def _sort_value(obj: StorageObject, path: str) -> Optional[Any]:
    if path in ("id", "_id", "uuid"):
        return obj.uuid
    if path == "_creationTimeUnix":
        return obj.creation_time_ms
    if path == "_lastUpdateTimeUnix":
        return obj.update_time_ms
    v = obj.properties.get(path)
    if isinstance(v, list):
        return v[0] if v else None
    if isinstance(v, bool):
        return int(v)
    return v


class _Key:
    """Comparator wrapper: missing values sort last; mixed types by repr."""

    __slots__ = ("missing", "value")

    def __init__(self, value: Any):
        self.missing = value is None
        self.value = value

    def _coerce(self, other: "_Key"):
        a, b = self.value, other.value
        if type(a) is type(b):
            return a, b
        if isinstance(a, (int, float)) and isinstance(b, (int, float)):
            return a, b
        return str(a), str(b)

    def __lt__(self, other: "_Key") -> bool:
        if self.missing or other.missing:
            # missing never wins a comparison => stable, sorts last via key tuple
            return other.missing and not self.missing
        a, b = self._coerce(other)
        return a < b

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, _Key):
            return NotImplemented
        if self.missing or other.missing:
            return self.missing == other.missing
        a, b = self._coerce(other)
        return a == b


def sort_objects(
    objs: list[StorageObject],
    criteria: list[tuple[str, str]],
) -> list[StorageObject]:
    """Sort by [(property_path, "asc"|"desc"), ...], first criterion primary."""
    out = list(objs)
    # stable sort: apply criteria in reverse order
    for path, order in reversed(criteria):
        desc = order.lower() == "desc"
        # missing-last must survive reverse=True, so desc sorts the present
        # objects alone and re-appends the missing ones
        if desc:
            present = [o for o in out if _sort_value(o, path) is not None]
            missing = [o for o in out if _sort_value(o, path) is None]
            present.sort(key=lambda o: _Key(_sort_value(o, path)), reverse=True)
            out = present + missing
        else:
            out.sort(key=lambda o: (
                _sort_value(o, path) is None,
                _Key(_sort_value(o, path)),
            ))
    return out
