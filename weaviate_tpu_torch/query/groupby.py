"""GroupBy: bucket search results by a property value.

Reference: ``adapters/repos/db/shard_group_by.go`` + ``entities/searchparams``
(GroupBy{Property, Groups, ObjectsPerGroup}) — results are walked best-first,
each object lands in the group keyed by its property value (array values join
each group), capped at ``groups`` groups of ``objects_per_group`` members.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

from weaviate_tpu_torch.storage.objects import StorageObject


@dataclass
class GroupByParams:
    property: str
    groups: int = 5
    objects_per_group: int = 10


@dataclass
class Group:
    value: Any
    objects: list[tuple[StorageObject, float]] = field(default_factory=list)

    @property
    def min_score(self) -> float:
        return min((s for _, s in self.objects), default=0.0)

    @property
    def max_score(self) -> float:
        return max((s for _, s in self.objects), default=0.0)


def group_results(
    results: list[tuple[StorageObject, float]],
    params: GroupByParams,
) -> list[Group]:
    """Walk results best-first into capped groups (reference shard_group_by.go)."""
    groups: dict[Any, Group] = {}
    order: list[Any] = []
    for obj, score in results:
        raw = obj.properties.get(params.property)
        keys = raw if isinstance(raw, list) else [raw]
        for key in keys:
            k = str(key) if isinstance(key, (dict,)) else key
            g = groups.get(k)
            if g is None:
                if len(groups) >= params.groups:
                    continue
                g = Group(value=k)
                groups[k] = g
                order.append(k)
            if len(g.objects) < params.objects_per_group:
                g.objects.append((obj, score))
    return [groups[k] for k in order]
