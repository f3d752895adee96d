"""Legacy vector grouping — the GraphQL ``group: {type, force}`` arg.

Reference: ``usecases/traverser/grouper`` — greedy single-link
clustering of the result set by normalized vector distance < force,
then flattened per strategy: ``closest`` keeps each group's first
(best-ranked) member; ``merge`` folds a group into one synthetic
result — vectors averaged, text values deduped and joined as
"first (b, c)", numbers averaged, booleans majority, geo averaged
(``merge_group.go``). Distinct from the modern ``groupBy`` argument
(reference keeps both; so do we)."""

from __future__ import annotations

from typing import Optional

import numpy as np


def _normalized_distance(a: np.ndarray, b: np.ndarray) -> float:
    """Cosine distance scaled to [0, 1] (reference
    ``vectorizer.NormalizedDistance``)."""
    na = float(np.linalg.norm(a))
    nb = float(np.linalg.norm(b))
    if na == 0.0 or nb == 0.0:
        return 1.0
    sim = float(np.dot(a, b)) / (na * nb)
    return (1.0 - sim) / 2.0


def _merge_text(values: list[str]) -> str:
    seen: dict[str, None] = {}
    for v in values:
        seen.setdefault(v, None)
    uniq = list(seen)
    if len(uniq) == 1:
        return uniq[0]
    return f"{uniq[0]} ({', '.join(uniq[1:])})"


def _merge_values(values: list):
    first = values[0]
    if isinstance(first, bool):
        return sum(bool(v) for v in values) >= len(values) / 2
    if isinstance(first, (int, float)):
        return float(sum(values)) / len(values)
    if isinstance(first, str):
        return _merge_text([str(v) for v in values])
    if isinstance(first, dict) and "latitude" in first:
        return {
            "latitude": sum(v["latitude"] for v in values) / len(values),
            "longitude": sum(v["longitude"] for v in values) / len(values),
        }
    if isinstance(first, list):  # references / arrays concatenate
        out = []
        for v in values:
            out.extend(v if isinstance(v, list) else [v])
        return out
    return first  # unknown type: keep the best-ranked member's value


def legacy_group(hits: list, strategy: str, force: float) -> list:
    """Group ``hits`` (explorer Hit objects, rank order) and flatten.
    Hits without a vector pass through ungrouped (nothing to cluster
    on)."""
    if strategy not in ("closest", "merge"):
        raise ValueError(
            f"unrecognized grouping strategy {strategy!r} "
            "(closest | merge)")
    groups: list[list] = []
    passthrough: list = []
    for h in hits:
        vec = getattr(h.object, "vector", None)
        if vec is None:
            passthrough.append(h)
            continue
        v = np.asarray(vec, np.float32)
        placed = False
        for g in groups:
            if any(_normalized_distance(
                    v, np.asarray(m.object.vector, np.float32)) < force
                   for m in g):
                g.append(h)
                placed = True
                break
        if not placed:
            groups.append([h])

    out = []
    for g in groups:
        if strategy == "closest" or len(g) == 1:
            out.append(g[0])
            continue
        head = g[0]
        merged_props: dict = {}
        names: dict[str, None] = {}
        for m in g:
            for p in m.object.properties:
                names.setdefault(p, None)
        for p in names:
            vals = [m.object.properties[p] for m in g
                    if m.object.properties.get(p) is not None]
            if vals:
                merged_props[p] = _merge_values(vals)
        vecs = [np.asarray(m.object.vector, np.float32) for m in g]
        head.object.properties = merged_props
        head.object.vector = np.mean(np.stack(vecs), axis=0)
        head.additional["group"] = {
            "count": len(g),
            "ids": [m.object.uuid for m in g],
        }
        out.append(head)
    return out + passthrough
