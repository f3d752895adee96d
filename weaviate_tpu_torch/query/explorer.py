"""Explorer: the query orchestration façade (port of
``weaviate_tpu/query/explorer.py``).

Reference: ``usecases/traverser/explorer.go:132`` (GetClass) — decides
keyword vs vector vs hybrid vs plain-filtered, then applies groupBy, autocut,
sort and pagination. The REST/gRPC/GraphQL layers build a ``QueryParams`` and
call ``Explorer.get`` — the analogue of ``dto.GetParams`` flowing into the
traverser.

The port serves nearVector, bm25, hybrid, multi-target (as far as the
collection does), plain and filtered fetches with sort, autocut, groupBy and
the legacy group. The module steps raise ``NotImplementedError`` naming their
ROADMAP queue-A slice: rerank (slice 7), generate, ask, summary, tokens
and the vectorizer behind nearText (slice 9). ``autocorrect`` needs a
spellcheck module, which a collection of the port never holds: as in the
JAX package without one, it changes nothing.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np

from weaviate_tpu_torch.core.db import DB
from weaviate_tpu_torch.inverted.filters import Filter
from weaviate_tpu_torch.query.autocut import autocut as autocut_fn
from weaviate_tpu_torch.query.groupby import Group, GroupByParams, group_results
from weaviate_tpu_torch.query.sorter import sort_objects
from weaviate_tpu_torch.storage.objects import StorageObject


@dataclass
class HybridParams:
    query: Optional[str] = None
    vector: Optional[np.ndarray] = None
    alpha: float = 0.75
    fusion: str = "relativeScoreFusion"
    properties: Optional[list[str]] = None
    # keyword-branch SearchOperatorOptions (reference hybrid.go:170)
    operator: str = "Or"
    minimum_match: int = 0


@dataclass
class RerankParams:
    """Reference ``modulecapabilities`` rerank additional property.

    ``module`` "" = collection default: the target index's configured
    DEVICE module when one exists (fused into the search dispatch, see
    docs/modules.md), else the host ``reranker-lexical``. Naming a
    registered device module routes the fused tier; any other name runs
    the host module tier after search."""

    query: str
    property: str = ""  # document text property; "" = all text props
    module: str = ""


@dataclass
class GenerateParams:
    """Reference generative additional property (singlePrompt/groupedTask)."""

    single_prompt: Optional[str] = None  # "{prop}" placeholders
    grouped_task: Optional[str] = None
    properties: Optional[list[str]] = None  # context props for grouped
    module: str = "generative-template"


@dataclass
class AskParams:
    """Reference ``qna-*`` GraphQL ``ask`` argument: answer a question from
    the best-matching object's text."""

    question: str
    properties: Optional[list[str]] = None  # context props; None = all text
    certainty: float = 0.0  # drop answers below this confidence
    module: str = "qna-transformers"


@dataclass
class SummaryParams:
    """Reference ``sum-transformers`` ``_additional { summary }``."""

    properties: list[str] = field(default_factory=list)
    module: str = "sum-transformers"


@dataclass
class TokenParams:
    """Reference ``ner-transformers`` ``_additional { tokens }``."""

    properties: list[str] = field(default_factory=list)
    certainty: float = 0.0
    module: str = "ner-transformers"


@dataclass
class QueryParams:
    collection: str
    tenant: str = ""
    limit: int = 10
    offset: int = 0
    filters: Optional[Filter] = None
    # nearText: vectorized via the collection's vectorizer module
    near_text: Optional[str] = None
    # concept movement (reference nearText moveTo/moveAwayFrom):
    # {"concepts": [...], "objects": [uuid, ...], "force": float}
    near_text_move_to: Optional[dict] = None
    near_text_move_away: Optional[dict] = None
    # vector search (single or multi target)
    near_vector: Optional[np.ndarray] = None
    target_vector: str = ""
    targets: Optional[dict[str, np.ndarray]] = None  # multi-target
    target_combination: str = "minimum"
    target_weights: Optional[dict[str, float]] = None
    max_distance: Optional[float] = None
    # keyword search
    bm25_query: Optional[str] = None
    bm25_properties: Optional[list[str]] = None
    # SearchOperatorOptions (reference base_search.proto:38): "And"
    # requires every query token; minimum_match bounds "Or"
    bm25_operator: str = "Or"
    bm25_minimum_match: int = 0
    # hybrid
    hybrid: Optional[HybridParams] = None
    # post-processing
    # exhaustive-cursor pagination (reference filters.Cursor): only
    # valid for plain fetches — no search/sort/filters. None = no
    # cursor; "" = cursor from the start (uuid order, reference REST
    # ``?after=`` semantics)
    after: Optional[str] = None
    sort: list[tuple[str, str]] = field(default_factory=list)
    group_by: Optional[GroupByParams] = None
    # legacy GraphQL group: {type: closest|merge, force} (reference
    # traverser/grouper; distinct from groupBy)
    legacy_group: Optional[dict] = None
    autocut: int = 0
    # module-powered additional properties
    rerank: Optional[RerankParams] = None
    generate: Optional[GenerateParams] = None
    ask: Optional[AskParams] = None
    summary: Optional[SummaryParams] = None
    tokens: Optional[TokenParams] = None
    # query spellcheck (reference text-spellcheck): autocorrect nearText /
    # bm25 input before vectorization when enabled
    autocorrect: bool = False


@dataclass
class Hit:
    object: StorageObject
    score: Optional[float] = None  # higher is better (bm25/hybrid)
    distance: Optional[float] = None  # lower is better (vector)
    additional: dict[str, Any] = field(default_factory=dict)


@dataclass
class QueryResult:
    hits: list[Hit] = field(default_factory=list)
    groups: Optional[list[Group]] = None
    generated: Optional[str] = None  # groupedTask output


class Explorer:
    def __init__(self, db: DB):
        self.db = db

    def _query_vector(self, col, text: str) -> np.ndarray:
        """nearText → query vector via the collection's vectorizer module
        (reference ``near_params_vector.go``)."""
        name = col.config.vectorizer
        if name == "none":
            raise ValueError(
                f"collection {col.config.name!r} has no vectorizer: "
                "nearText requires one (use nearVector instead)"
            )
        raise NotImplementedError(
            f"vectorizer module {name!r}: not ported yet (ROADMAP queue A, "
            "slice 9)")

    def _apply_moves(self, col, vector: np.ndarray,
                     move_to: Optional[dict], move_away: Optional[dict],
                     tenant: str = "") -> np.ndarray:
        """nearText concept movement (reference
        ``nearText/searcher_movements.go``): moveTo lerps toward the
        target with weight force*0.5; moveAwayFrom pushes along
        (source - target) by the same weight. Targets average the
        vectorized concepts plus the named objects' vectors."""
        def _target(move: dict) -> Optional[np.ndarray]:
            parts = []
            for concept in move.get("concepts") or ():
                parts.append(np.asarray(
                    self._query_vector(col, concept), np.float32))
            for uuid in move.get("objects") or ():
                obj = col.get(uuid, tenant=tenant)
                if obj is None or obj.vector is None:
                    raise ValueError(
                        f"move object {uuid!r} not found or has no "
                        "vector")
                parts.append(np.asarray(obj.vector, np.float32))
            if not parts:
                return None
            return np.mean(np.stack(parts), axis=0)

        vector = np.asarray(vector, np.float32)
        if move_to and float(move_to.get("force", 0)) > 0:
            t = _target(move_to)
            if t is not None:
                w = float(move_to["force"]) * 0.5
                vector = vector * (1.0 - w) + t * w
        if move_away and float(move_away.get("force", 0)) > 0:
            t = _target(move_away)
            if t is not None:
                w = float(move_away["force"]) * 0.5
                vector = vector + w * (vector - t)
        return vector

    @staticmethod
    def _refuse_unported(params: QueryParams) -> None:
        """The module-powered steps come with later slices: asking for one
        raises before any search runs."""
        if params.rerank is not None:
            raise NotImplementedError(
                "rerank (modules/device and the host rerankers): not ported "
                "yet (ROADMAP queue A, slice 7)")
        for name in ("generate", "ask", "summary", "tokens"):
            if getattr(params, name):
                raise NotImplementedError(
                    f"{name} (the module registry, modules/): not ported "
                    "yet (ROADMAP queue A, slice 9)")

    def get(self, params: QueryParams) -> QueryResult:
        col = self.db.get_collection(params.collection)
        fetch = params.offset + params.limit
        if params.after is not None and (
                params.filters is not None
                or params.near_vector is not None
                or params.near_text is not None
                or params.bm25_query is not None
                or params.hybrid is not None or params.targets):
            # reference restriction: the exhaustive cursor is a plain
            # scan; ranked or filtered orders have no stable cursor
            raise ValueError(
                "cursor pagination (after) requires a plain fetch "
                "without search operators or filters")
        scored: list[tuple[StorageObject, float]] = []
        kind = "none"

        self._refuse_unported(params)
        if params.near_text is not None and params.near_vector is None \
                and params.hybrid is None:
            params.near_vector = self._apply_moves(
                col, self._query_vector(col, params.near_text),
                params.near_text_move_to, params.near_text_move_away,
                params.tenant)
        if params.hybrid is not None:
            # reject unknown fusion names BEFORE any leg work (or query
            # vectorization) — every surface maps this ValueError to
            # 400 / INVALID_ARGUMENT, never a 500
            from weaviate_tpu_torch.query.fusion import validate_fusion

            validate_fusion(params.hybrid.fusion)
        if params.hybrid is not None and params.hybrid.vector is None \
                and params.hybrid.query and col.config.vectorizer != "none" \
                and col.modules is not None:
            # hybrid with text only: vectorize the query for the dense branch
            params.hybrid.vector = self._query_vector(col, params.hybrid.query)

        if params.hybrid is not None:
            h = params.hybrid
            scored = col.hybrid_search(
                query=h.query, vector=h.vector, alpha=h.alpha, k=fetch,
                fusion=h.fusion, properties=h.properties,
                flt=params.filters, tenant=params.tenant,
                target=params.target_vector,
                max_vector_distance=params.max_distance,
                operator=h.operator, minimum_match=h.minimum_match,
            )
            kind = "score"
        elif params.targets:
            scored = col.multi_target_search(
                params.targets, k=fetch,
                combination=params.target_combination,
                weights=params.target_weights,
                flt=params.filters, tenant=params.tenant,
            )
            kind = "distance"
        elif params.near_vector is not None:
            scored = col.vector_search(
                params.near_vector, k=fetch, target=params.target_vector,
                flt=params.filters, tenant=params.tenant,
                max_distance=params.max_distance,
            )
            kind = "distance"
        elif params.bm25_query is not None:
            scored = col.bm25_search(
                params.bm25_query, k=fetch,
                properties=params.bm25_properties,
                flt=params.filters, tenant=params.tenant,
                operator=params.bm25_operator,
                minimum_match=params.bm25_minimum_match,
            )
            kind = "score"
        elif params.filters is not None:
            # a sort over unranked results must see the FULL candidate
            # set — sorting a pre-truncated page returns the first
            # objects reordered, not the global order (reference sorts
            # at the shard against the whole allowlist, sorter/)
            want = (1 << 62) if params.sort else fetch
            objs = col.filter_search(params.filters, limit=want,
                                     tenant=params.tenant)
            scored = [(o, 0.0) for o in objs]
        else:
            if params.after is not None and (params.sort or params.offset):
                raise ValueError(
                    "cursor pagination (after) cannot combine with "
                    "sort or offset")
            # offset applies once, in the common paging below — passing
            # it here too double-applied it (offset=10 returned [])
            want = (1 << 62) if params.sort else fetch
            objs = col.objects_page(limit=want, offset=0,
                                    tenant=params.tenant,
                                    after=params.after)
            scored = [(o, 0.0) for o in objs]

        # autocut applies to ranked results only (reference entities/autocut)
        if params.autocut > 0 and kind != "none":
            cut = autocut_fn([s for _, s in scored], params.autocut)
            scored = scored[:cut]

        # groupBy bypasses sort/pagination (reference shard_group_by.go)
        if params.group_by is not None:
            groups = group_results(scored, params.group_by)
            return QueryResult(hits=[], groups=groups)

        if params.sort:
            # Ranked queries sort the already-fetched top-k, matching
            # the reference (index.go:1630 sorts the merged per-shard
            # top-limit results); only UNRANKED fetches widen to the
            # full candidate set above.
            ordered = sort_objects([o for o, _ in scored], params.sort)
            by_id = {id(o): s for o, s in scored}
            scored = [(o, by_id.get(id(o), 0.0)) for o in ordered]

        page = scored[params.offset: params.offset + params.limit]
        hits = [
            Hit(object=o,
                score=s if kind == "score" else None,
                distance=s if kind == "distance" else None)
            for o, s in page
        ]
        if params.legacy_group is not None:
            from weaviate_tpu_torch.query.legacy_group import legacy_group

            hits = legacy_group(
                hits,
                str(params.legacy_group.get("type", "closest")),
                float(params.legacy_group.get("force", 0.0)))
        return QueryResult(hits=hits)

    def aggregate(
        self,
        collection: str,
        properties: Optional[dict[str, Optional[str]]] = None,
        filters: Optional[Filter] = None,
        group_by: Optional[str] = None,
        tenant: str = "",
    ) -> dict:
        col = self.db.get_collection(collection)
        return col.aggregate(properties=properties, flt=filters,
                             group_by=group_by, tenant=tenant)
