"""Multi-target-vector score combination (port of
``weaviate_tpu/query/multi_target.py``).

Reference: ``adapters/repos/db/shard_combine_multi_target.go`` +
``usecases/traverser/target_vector_param_helper.go`` — a query against several
named vectors runs one search per target, joins by doc, fills in missing
distances by recomputing them exactly, and combines with one of: sum, average,
minimum, manual weights, relative score.
"""

from __future__ import annotations

import numpy as np

COMBINATIONS = ("sum", "average", "minimum", "manualWeights", "relativeScore")


def np_distance(q: np.ndarray, v: np.ndarray, metric: str) -> float:
    """Exact single-pair distance on host, matching ops.distance semantics."""
    q = np.asarray(q, np.float32)
    v = np.asarray(v, np.float32)
    if metric == "l2-squared":
        d = q - v
        return float(np.dot(d, d))
    if metric == "dot":
        return float(-np.dot(q, v))
    if metric == "cosine":
        qn = q / max(float(np.linalg.norm(q)), 1e-12)
        vn = v / max(float(np.linalg.norm(v)), 1e-12)
        return float(1.0 - np.dot(qn, vn))
    if metric == "manhattan":
        return float(np.abs(q - v).sum())
    if metric == "hamming":
        return float(np.sum(q != v))
    raise ValueError(f"unknown metric {metric!r}")


def join_mode(combination: str) -> str:
    """Map an API combination to the join variant of kernel B7b. sum /
    average / manualWeights all lower to "weighted": only the weight rows
    differ."""
    if combination == "minimum":
        return "minimum"
    if combination == "relativeScore":
        return "relative"
    return "weighted"


def weight_row(targets: list[str], combination: str,
               weights: dict[str, float] | None) -> np.ndarray:
    """Per-target weight row [T] feeding the join's ``weights`` input,
    reproducing the host oracle's arithmetic exactly: sum → 1,
    average → 1/T, manualWeights/relativeScore → caller weights
    (default 1), minimum → ones (the join ignores them)."""
    t = len(targets)
    if combination == "average":
        return np.full(t, 1.0 / t, np.float32)
    if combination in ("manualWeights", "relativeScore"):
        return np.asarray([(weights or {}).get(tg, 1.0) for tg in targets],
                          np.float32)
    return np.ones(t, np.float32)


def validate_multi_target(
    targets: list[str], combination: str,
    weights: dict[str, float] | None, known_targets,
) -> None:
    """Request-shape validation shared by every API surface: raises
    ``ValueError`` (GraphQL errors / 400 at REST, INVALID_ARGUMENT at
    gRPC) on unknown targets, duplicate targets, unknown combination,
    or weight/target-set mismatch."""
    if not targets:
        raise ValueError("multi-target search requires at least one "
                         "target vector")
    if len(set(targets)) != len(targets):
        raise ValueError("duplicate target vectors in targetVectors")
    known = set(known_targets)
    for t in targets:
        if t not in known:
            raise ValueError(f"unknown target vector {t!r}")
    if combination not in COMBINATIONS:
        raise ValueError(f"unknown combination {combination!r}")
    if weights:
        if combination not in ("manualWeights", "relativeScore"):
            raise ValueError(
                "targetVectors weights require the manualWeights or "
                f"relativeScore combination, not {combination!r}")
        extra = set(weights) - set(targets)
        if extra:
            raise ValueError(
                f"weights name unknown targets: {sorted(extra)}")
        if combination == "manualWeights" and set(weights) != set(targets):
            missing = set(targets) - set(weights)
            raise ValueError(
                "manualWeights requires one weight per target; missing: "
                f"{sorted(missing)}")


def combine_multi_target(
    per_target: dict[str, dict], combination: str,
    weights: dict[str, float] | None = None,
) -> list[tuple[object, float]]:
    """Join per-target results into one ranking (ascending combined distance).

    ``per_target``: target -> {key: distance} with every key present in every
    target (callers fill gaps by exact recompute first). Returns
    [(key, combined)] sorted ascending.
    """
    if combination not in COMBINATIONS:
        raise ValueError(f"unknown combination {combination!r}")
    targets = list(per_target.keys())
    keys = set()
    for dists in per_target.values():
        keys.update(dists.keys())
    keys = list(keys)
    if not keys:
        return []

    mat = np.asarray(
        [[per_target[t].get(k, np.inf) for k in keys] for t in targets],
        np.float64,
    )  # [T, K]

    if combination == "minimum":
        combined = mat.min(axis=0)
    elif combination == "sum":
        combined = mat.sum(axis=0)
    elif combination == "average":
        combined = mat.mean(axis=0)
    elif combination == "manualWeights":
        w = np.asarray([(weights or {}).get(t, 1.0) for t in targets])
        combined = (mat * w[:, None]).sum(axis=0)
    else:  # relativeScore: min-max normalize each target's distances first
        lo = mat.min(axis=1, keepdims=True)
        hi = mat.max(axis=1, keepdims=True)
        span = np.where(hi - lo <= 0, 1.0, hi - lo)
        norm = (mat - lo) / span
        w = np.asarray([(weights or {}).get(t, 1.0) for t in targets])
        combined = (norm * w[:, None]).sum(axis=0)

    order = np.argsort(combined, kind="stable")
    return [(keys[i], float(combined[i])) for i in order]
