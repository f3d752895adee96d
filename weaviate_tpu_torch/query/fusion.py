"""Hybrid fusion algorithms (port of ``weaviate_tpu/query/fusion.py``).

Reference: ``usecases/traverser/hybrid/hybrid_fusion.go`` — rankedFusion
(``:22``, reciprocal-rank with a 60 offset) and relativeScoreFusion (``:93``,
min-max normalize each branch then weighted sum). Keys are object UUIDs so
fusion works across shards: the caller fuses the globally merged per-leg
candidate sets, so relativeScoreFusion's min-max normalization spans the
whole corpus, never one shard's skewed slice.

``fuse_result_sets`` fuses on the device: kernel B6b (``ops/fusion.py``)
on the card, its plain version for CPU tensors; a failed launch raises.
The pure-python functions below are the exact host twins: the parity
oracle of the tests, never a fallback.
"""

from __future__ import annotations

from typing import Hashable

# the classic RRF constant used by the reference
RANKED_FUSION_OFFSET = 60.0


def ranked_fusion(
    result_sets: list[list[tuple[Hashable, float]]],
    weights: list[float],
    k: int,
) -> list[tuple[Hashable, float]]:
    """Reciprocal-rank fusion: score = Σ_set weight / (60 + rank).

    Each result set is [(key, score)] sorted best-first; scores themselves
    are ignored, only ranks matter.
    """
    fused: dict[Hashable, float] = {}
    for rs, w in zip(result_sets, weights):
        for rank, (key, _score) in enumerate(rs):
            fused[key] = fused.get(key, 0.0) + w / (RANKED_FUSION_OFFSET + rank)
    out = sorted(fused.items(), key=lambda t: -t[1])
    return out[:k]


def relative_score_fusion(
    result_sets: list[list[tuple[Hashable, float]]],
    weights: list[float],
    k: int,
) -> list[tuple[Hashable, float]]:
    """Min-max normalize each branch's scores to [0,1], then weighted sum.

    Scores must be "higher is better" in every set (invert distances before
    calling). Matches the reference's relativeScoreFusion (:93): a set with
    a single distinct score normalizes to 1.0.
    """
    fused: dict[Hashable, float] = {}
    for rs, w in zip(result_sets, weights):
        if not rs:
            continue
        scores = [s for _, s in rs]
        lo, hi = min(scores), max(scores)
        span = hi - lo
        for key, s in rs:
            norm = 1.0 if span <= 0 else (s - lo) / span
            fused[key] = fused.get(key, 0.0) + w * norm
    out = sorted(fused.items(), key=lambda t: -t[1])
    return out[:k]


FUSION_ALGORITHMS = {
    "rankedFusion": ranked_fusion,
    "relativeScoreFusion": relative_score_fusion,
}


def hybrid_fetch(k: int) -> int:
    """Per-leg over-fetch: ceil(hybrid_overfetch_factor · k), never below
    k. The one definition the collection path derives each leg's fetch
    from."""
    import math

    from weaviate_tpu_torch.utils.runtime_config import (
        HYBRID_OVERFETCH_FACTOR,
    )

    factor = max(1.0, float(HYBRID_OVERFETCH_FACTOR.get()))
    return max(k, int(math.ceil(k * factor)))


def validate_fusion(name: str) -> None:
    """Reject unknown fusion names with a clean ValueError — mapped to
    400 / INVALID_ARGUMENT at every API surface, never a 500."""
    if name not in FUSION_ALGORITHMS:
        raise ValueError(
            f"unknown fusion algorithm {name!r} (expected one of "
            f"{sorted(FUSION_ALGORITHMS)})")


def assemble_slots(
    result_sets: list[list[tuple[Hashable, float]]],
) -> tuple[list[Hashable], list[list[int]], list[list[float]]]:
    """Dense union-slot encoding of the legs' (key, score) lists.

    Slot ids are assigned in the host twin's dict-insertion order (leg 0
    in rank order, then each later leg's NEW keys in rank order), so the
    device kernel's lower-index-wins tie-break reproduces the host's
    stable-sort order exactly. Returns (keys by slot, per-leg slot
    lists, per-leg score lists).
    """
    slot_of: dict[Hashable, int] = {}
    keys: list[Hashable] = []
    slot_sets: list[list[int]] = []
    score_sets: list[list[float]] = []
    for rs in result_sets:
        slots = []
        scores = []
        for key, score in rs:
            idx = slot_of.get(key)
            if idx is None:
                idx = slot_of[key] = len(keys)
                keys.append(key)
            slots.append(idx)
            scores.append(float(score))
        slot_sets.append(slots)
        score_sets.append(scores)
    return keys, slot_sets, score_sets


def fuse_result_sets(
    result_sets: list[list[tuple[Hashable, float]]],
    weights: list[float],
    k: int,
    algorithm: str,
    device=None,
) -> list[tuple[Hashable, float]]:
    """Fuse the legs in one launch on ``device`` (the card unless the
    caller names another). Same contract as the host functions:
    [(key, fused score)] best-first, at most ``k`` entries."""
    from weaviate_tpu_torch.ops.fusion import fuse_topk

    validate_fusion(algorithm)
    if not any(result_sets):
        return []
    keys, slot_sets, score_sets = assemble_slots(result_sets)
    ids, vals = fuse_topk(slot_sets, score_sets, weights, k, algorithm,
                          len(keys), device=device)
    return [(keys[int(i)], float(v)) for i, v in zip(ids, vals)]
