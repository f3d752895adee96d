"""Query orchestration: hybrid fusion, sorting, grouping, aggregation (port
of ``weaviate_tpu/query/``).

Reference: ``usecases/traverser`` (Traverser/Explorer) + ``adapters/repos/db``
post-processing (sorter, aggregator, group-by, autocut). The cost-based
planner and the resident filter planes live in ``query/planner/``;
multi-target score joining in ``query/multi_target.py``.
"""

from weaviate_tpu_torch.query.aggregator import aggregate_property
from weaviate_tpu_torch.query.autocut import autocut
from weaviate_tpu_torch.query.explorer import (
    AskParams,
    Explorer,
    GenerateParams,
    Hit,
    HybridParams,
    QueryParams,
    QueryResult,
    RerankParams,
    SummaryParams,
    TokenParams,
)
from weaviate_tpu_torch.query.fusion import ranked_fusion, relative_score_fusion
from weaviate_tpu_torch.query.groupby import Group, GroupByParams, group_results
from weaviate_tpu_torch.query.sorter import sort_objects

__all__ = [
    "Explorer", "Hit", "HybridParams", "QueryParams", "QueryResult",
    "RerankParams", "GenerateParams", "AskParams", "SummaryParams",
    "TokenParams",
    "GroupByParams", "Group", "group_results", "sort_objects", "autocut",
    "ranked_fusion", "relative_score_fusion", "aggregate_property",
]
