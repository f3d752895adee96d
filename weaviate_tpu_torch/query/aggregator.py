"""Aggregations over collection properties.

Reference: ``adapters/repos/db/aggregator/`` (numeric/text/bool/date
aggregations, grouped + filtered) surfaced through the Aggregate API
(``usecases/traverser/traverser_aggregate.go``). Values come from the
inverted index's per-property value map (the filterable tier), optionally
masked by a filter allow-list — the same data path the reference's
aggregator reads from LSM property buckets.
"""

from __future__ import annotations

import datetime as _dt
from collections import Counter
from typing import Any, Optional

import numpy as np

NUMERIC_AGGS = ("count", "sum", "mean", "min", "max", "median", "mode")
TEXT_AGGS = ("count", "topOccurrences")
BOOL_AGGS = (
    "count", "totalTrue", "totalFalse", "percentageTrue", "percentageFalse",
)
DATE_AGGS = ("count", "min", "max", "median", "mode")


def _parse_date(v: Any) -> Optional[_dt.datetime]:
    if isinstance(v, _dt.datetime):
        return v
    if isinstance(v, str):
        try:
            return _dt.datetime.fromisoformat(v.replace("Z", "+00:00"))
        except ValueError:
            return None
    return None


def _flatten(values: list[Any]) -> list[Any]:
    out: list[Any] = []
    for v in values:
        if isinstance(v, list):
            out.extend(v)
        else:
            out.append(v)
    return out


def aggregate_numeric(values: list[Any]) -> dict:
    nums = [float(v) for v in _flatten(values)
            if isinstance(v, (int, float)) and not isinstance(v, bool)]
    if not nums:
        return {"count": 0}
    arr = np.asarray(nums, np.float64)
    # deterministic mode: ties break to the smallest value, not insertion
    # order — the segment tier reconstructs values in key order, the RAM
    # tier sees doc order, and both must answer identically
    counts = Counter(nums)
    best = max(counts.values())
    mode_val = min(v for v, c in counts.items() if c == best)
    return {
        "count": len(nums),
        "sum": float(arr.sum()),
        "mean": float(arr.mean()),
        "min": float(arr.min()),
        "max": float(arr.max()),
        "median": float(np.median(arr)),
        "mode": mode_val,
    }


def aggregate_text(values: list[Any], top_occurrences_limit: int = 5) -> dict:
    texts = [v for v in _flatten(values) if isinstance(v, str)]
    counter = Counter(texts)
    # ties break lexicographically (engine-order independence, see mode)
    ranked = sorted(counter.items(), key=lambda t: (-t[1], t[0]))
    return {
        "count": len(texts),
        "topOccurrences": [
            {"value": v, "occurs": n}
            for v, n in ranked[:top_occurrences_limit]
        ],
    }


def aggregate_bool(values: list[Any]) -> dict:
    bools = [v for v in _flatten(values) if isinstance(v, bool)]
    n = len(bools)
    t = sum(bools)
    return {
        "count": n,
        "totalTrue": t,
        "totalFalse": n - t,
        "percentageTrue": (t / n) if n else 0.0,
        "percentageFalse": ((n - t) / n) if n else 0.0,
    }


def aggregate_date(values: list[Any]) -> dict:
    dates = [d for d in (_parse_date(v) for v in _flatten(values)) if d is not None]
    if not dates:
        return {"count": 0}
    stamps = sorted(dates)
    iso = lambda d: d.isoformat()
    dcounts = Counter(iso(d) for d in dates)
    dbest = max(dcounts.values())
    mode_val = min(v for v, c in dcounts.items() if c == dbest)
    return {
        "count": len(dates),
        "min": iso(stamps[0]),
        "max": iso(stamps[-1]),
        "median": iso(stamps[len(stamps) // 2]),
        "mode": mode_val,
    }


def aggregate_reference(values: list[Any]) -> dict:
    return {"count": len(_flatten(values))}


_BY_KIND = {
    "numeric": aggregate_numeric,
    "text": aggregate_text,
    "boolean": aggregate_bool,
    "date": aggregate_date,
    "reference": aggregate_reference,
}


def infer_kind(values: list[Any]) -> str:
    for v in _flatten(values):
        if isinstance(v, bool):
            return "boolean"
        if isinstance(v, (int, float)):
            return "numeric"
        if isinstance(v, str):
            return "date" if _parse_date(v) is not None else "text"
    return "text"


def per_doc_distinct(v):
    """A value repeated WITHIN one doc's array counts once —
    inverted-index (per-doc distinct) semantics, identical to what the
    segment tier's bitmaps can express. Shared by collection-wide and
    search-scoped aggregation so the two can never drift."""
    if isinstance(v, list):
        try:
            return list(dict.fromkeys(v))
        except TypeError:  # unhashable elements (geo dicts)
            return v
    return v


# distance-bounded (no objectLimit) search-scoped Aggregate refuses to
# truncate past this many hits — erroring beats a silently-wrong mean
DISTANCE_AGG_CAP = 100_000


def aggregate_objects(objs, props: dict, group_by=None,
                      top_occurrences_limit: int = 5) -> dict:
    """Aggregate over an explicit object list — the search-scoped
    Aggregate (reference ``traverser_aggregate.go``: near*/hybrid +
    objectLimit aggregates the top hits). Returns the same shape as
    ``Collection.aggregate`` so reply builders are shared."""
    def _vals(obj_list, prop):
        out = []
        for o in obj_list:
            v = o.properties.get(prop)
            if v is None:
                continue
            v = per_doc_distinct(v)
            out.extend(v) if isinstance(v, list) else out.append(v)
        return out

    def _props(obj_list):
        return {p: aggregate_property(_vals(obj_list, p), kind,
                                      top_occurrences_limit)
                for p, kind in props.items()}

    if group_by is None:
        return {"meta": {"count": len(objs)},
                "properties": _props(objs)}
    groups: dict = {}
    for o in objs:
        gv = o.properties.get(group_by)
        for g in (gv if isinstance(gv, list) else [gv]):
            groups.setdefault(g, []).append(o)
    return {"groups": [
        {"groupedBy": {"path": [group_by], "value": g},
         "meta": {"count": len(members)},
         "properties": _props(members)}
        for g, members in groups.items()]}


def aggregate_property(
    values: list[Any],
    kind: Optional[str] = None,
    top_occurrences_limit: int = 5,
) -> dict:
    """Aggregate one property's values; kind inferred when not given."""
    if kind is None or kind == "auto":
        kind = infer_kind(values)
    if kind == "text":
        out = aggregate_text(values, top_occurrences_limit)
    else:
        out = _BY_KIND.get(kind, aggregate_text)(values)
    out["type"] = kind
    return out
