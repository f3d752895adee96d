"""Schema + vector-index configuration entities (port of
``weaviate_tpu/schema/config.py``).

Mirrors the reference's ``entities/schema`` (class/property models) and
``entities/vectorindex/{hnsw,flat,dynamic}/config.go`` (index config structs
with validation + defaults). Everything is a plain dataclass serializable to
JSON, with the JAX package's field names and defaults, so a ``schema.json``
written by either package loads in the other.

Every index config is here as a plain dataclass, but only ``flat``,
``hnsw`` and ``dynamic`` have an implementation in the port: ``validate``
refuses the other index types and rerank modules, and the shard's index
factory raises ``NotImplementedError`` naming the slice that brings each
one.
"""

from __future__ import annotations

import dataclasses
import enum
from dataclasses import dataclass, field
from typing import Any, Optional


class DataType(str, enum.Enum):
    """Property data types (reference ``entities/schema/data_types.go``)."""

    TEXT = "text"
    TEXT_ARRAY = "text[]"
    INT = "int"
    INT_ARRAY = "int[]"
    NUMBER = "number"
    NUMBER_ARRAY = "number[]"
    BOOL = "boolean"
    BOOL_ARRAY = "boolean[]"
    DATE = "date"
    DATE_ARRAY = "date[]"
    UUID = "uuid"
    UUID_ARRAY = "uuid[]"
    GEO = "geoCoordinates"
    BLOB = "blob"
    OBJECT = "object"
    OBJECT_ARRAY = "object[]"
    REFERENCE = "cref"


class Tokenization(str, enum.Enum):
    """Text tokenization schemes (reference ``entities/models/property.go``)."""

    WORD = "word"
    LOWERCASE = "lowercase"
    WHITESPACE = "whitespace"
    FIELD = "field"
    TRIGRAM = "trigram"
    # CJK schemes (reference gse/kagome integrations; dictionary-free
    # bigram segmentation here — see inverted/analyzer.py)
    GSE = "gse"
    KAGOME_JA = "kagome_ja"
    KAGOME_KR = "kagome_kr"


# CJK scheme -> env flags that enable it (reference
# ``entities/tokenizer/tokenizer.go:54-96`` gates gse/kagome behind
# ENABLE_TOKENIZER_* / USE_GSE; ``usecases/schema/class.go:832-847``
# rejects classes using a non-enabled tokenizer). This build carries no
# segmentation dictionaries, so enabling a CJK scheme opts in to the
# dictionary-free bigram approximation — the error and the one-time
# warning both say so.
_CJK_TOKENIZER_FLAGS = {
    "gse": ("ENABLE_TOKENIZER_GSE", "USE_GSE"),
    "kagome_ja": ("ENABLE_TOKENIZER_KAGOME_JA",),
    "kagome_kr": ("ENABLE_TOKENIZER_KAGOME_KR",),
}
_CJK_WARNED: set = set()


def _validate_cjk_tokenization(p: "Property") -> None:
    import logging
    import os

    scheme = p.tokenization.value
    flags = _CJK_TOKENIZER_FLAGS.get(scheme)
    if flags is None:
        return
    if not any(os.environ.get(f, "").lower() in ("1", "true", "on", "enabled")
               for f in flags):
        raise ValueError(
            f"the {scheme!r} tokenizer is not enabled; set {flags[0]!r} to "
            f"'true' to enable it (in this build it is approximated by "
            f"dictionary-free overlapping CJK bigrams, not a "
            f"dictionary segmenter)")
    if scheme not in _CJK_WARNED:
        _CJK_WARNED.add(scheme)
        logging.getLogger("weaviate_tpu_torch.schema").warning(
            "tokenization %r enabled: approximated as overlapping CJK "
            "bigrams (no segmentation dictionary in this build); recall "
            "matches bigram indexing, not gse/kagome dictionary output",
            scheme)


@dataclass
class Property:
    name: str
    data_type: DataType = DataType.TEXT
    tokenization: Tokenization = Tokenization.WORD
    index_filterable: bool = True
    index_searchable: bool = True
    index_range_filters: bool = False
    description: str = ""
    nested: list["Property"] = field(default_factory=list)
    # for data_type REFERENCE (cref): the class the beacons point at
    # (reference dataType=["TargetClass"] form)
    target_collection: str = ""

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["data_type"] = self.data_type.value
        d["tokenization"] = self.tokenization.value
        d["nested"] = [p.to_dict() if isinstance(p, Property) else p for p in self.nested]
        return d

    @staticmethod
    def from_dict(d: dict) -> "Property":
        d = dict(d)
        d["data_type"] = DataType(d.get("data_type", "text"))
        d["tokenization"] = Tokenization(d.get("tokenization", "word"))
        d["nested"] = [Property.from_dict(p) for p in d.get("nested", [])]
        return Property(**d)


# ---------------------------------------------------------------------------
# Quantizer configs (reference entities/vectorindex/hnsw/config.go PQConfig etc.)
# ---------------------------------------------------------------------------


@dataclass
class QuantizerConfig:
    enabled: bool = False
    kind: str = "none"  # pq | sq | bq | rq
    # candidates fetched from code space before exact rescore (0 = 4*k)
    rescore_limit: int = 0

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclass
class PQConfig(QuantizerConfig):
    """Product quantization (reference ``compressionhelpers/product_quantization.go:155``)."""

    kind: str = "pq"
    enabled: bool = True
    segments: int = 0  # 0 = auto (D/4, like the reference default)
    centroids: int = 256
    training_limit: int = 100_000
    encoder: str = "kmeans"  # kmeans | tile
    rescore_limit: int = 40


@dataclass
class SQConfig(QuantizerConfig):
    """Scalar (byte) quantization (reference ``scalar_quantization.go:28``)."""

    kind: str = "sq"
    enabled: bool = True
    training_limit: int = 100_000
    rescore_limit: int = 20


@dataclass
class BQConfig(QuantizerConfig):
    """Binary quantization (reference ``binary_quantization.go:18``)."""

    kind: str = "bq"
    enabled: bool = True
    rescore_limit: int = 10


@dataclass
class RQConfig(QuantizerConfig):
    """Rotational 8-bit quantization (reference ``rotational_quantization.go:25``)."""

    kind: str = "rq"
    enabled: bool = True
    bits: int = 8
    rescore_limit: int = 20


def quantizer_from_dict(d: Optional[dict]) -> Optional[QuantizerConfig]:
    if not d or not d.get("enabled"):
        return None
    kind = d.get("kind", "none")
    cls = {"pq": PQConfig, "sq": SQConfig, "bq": BQConfig, "rq": RQConfig}.get(kind)
    if cls is None:
        return None
    fields = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in d.items() if k in fields})


# ---------------------------------------------------------------------------
# Device rerank module config (the reference configures modules per class
# in the schema, usecases/modules; here the device rerank tier hangs off
# the vector-index config it fuses into — docs/modules.md)
# ---------------------------------------------------------------------------


@dataclass
class RerankModuleConfig:
    """Fused device rerank for one vector index: which registered device
    module (``modules/device/``) scores the walk's candidates inside the
    one-dispatch search, how wide its candidate token planes are, and
    its frozen parameters."""

    enabled: bool = True
    module: str = "rerank-maxsim"
    # candidate token plane width (pow2-rounded); token sets longer than
    # this grow the plane, shorter ones zero-pad
    max_tokens: int = 8
    # module constructor params (frozen into the jit-static scorer —
    # e.g. {"w_mean": 0.5} for rerank-linear)
    params: dict = field(default_factory=dict)

    def validate(self) -> None:
        from weaviate_tpu_torch.modules.device.base import (
            build_device_reranker,
        )

        if self.max_tokens < 1:
            raise ValueError(
                f"rerank max_tokens must be >= 1, got {self.max_tokens}")
        # instantiating validates both the name and the params (a typo'd
        # weight silently defaulting would change ranking quality)
        try:
            build_device_reranker(self.module, self.params)
        except (KeyError, TypeError) as e:
            raise ValueError(f"invalid rerank module config: {e}") from e

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def rerank_from_dict(d: Optional[dict]) -> Optional[RerankModuleConfig]:
    if not d or not d.get("enabled", True):
        return None
    fields = {f.name for f in dataclasses.fields(RerankModuleConfig)}
    return RerankModuleConfig(
        **{k: v for k, v in d.items() if k in fields})


# ---------------------------------------------------------------------------
# Vector index configs
# ---------------------------------------------------------------------------


# Index types with a registered implementation (kept in sync with
# weaviate_tpu_torch.core.shard.build_vector_index).
AVAILABLE_INDEX_TYPES = ("flat", "hnsw", "dynamic", "multivector", "hfresh")


@dataclass
class VectorIndexConfig:
    """Common knobs for every vector index."""

    index_type: str = "flat"
    distance: str = "cosine"  # l2-squared | dot | cosine | manhattan | hamming
    quantizer: Optional[QuantizerConfig] = None
    # fused device rerank module (docs/modules.md); None = no rerank tier
    rerank: Optional[RerankModuleConfig] = None
    # device placement / batching
    precision: str = "bf16"  # matmul precision: bf16 | fp32
    initial_capacity: int = 1024
    search_chunk_size: int = 131072
    # Flat-scan selection: -1 = unset (follows the runtime-config fleet
    # default); 0 = PINNED exact top_k (immune to the fleet override); in
    # (0, 1) = approximate selection allowed with this recall target, which
    # routes l2/bf16 scans with k <= 64 to the fused kernel
    # (ops/fused_flat.py). The reference's flat scan is always exact.
    flat_approx_recall: float = -1.0
    # Quantized indexes keep raw originals host-side for the exact rescore
    # tier (reference keeps them LSM-resident, flat/index.go:49): "ram"
    # float32, "ram16" float16 (half the RAM), "disk16" a float16 memmap
    # paged from disk, "disk8" per-row affine int8. The port has the four
    # quantizers (BQ, SQ, PQ, RQ) and the two RAM tiers; the disk tiers
    # come with slice 9. Without a quantizer the
    # raw corpus stays in device memory and this is not read.
    raw_tier: str = "ram"  # ram | ram16 | disk16 | disk8
    raw_path: Optional[str] = None

    def validate(self) -> None:
        from weaviate_tpu_torch.ops.distance import METRICS

        if self.index_type not in AVAILABLE_INDEX_TYPES:
            raise ValueError(
                f"index type {self.index_type!r} not available; "
                f"have {AVAILABLE_INDEX_TYPES}"
            )
        if self.distance not in METRICS:
            raise ValueError(f"invalid distance {self.distance!r}")
        if self.precision not in ("bf16", "fp32"):
            raise ValueError(f"invalid precision {self.precision!r}")
        if self.flat_approx_recall != -1.0 and \
                not 0.0 <= self.flat_approx_recall < 1.0:
            raise ValueError(
                "flat_approx_recall must be -1 (unset) or in [0, 1), "
                f"got {self.flat_approx_recall}"
            )
        if self.raw_tier not in ("ram", "ram16", "disk16", "disk8"):
            raise ValueError(
                f"invalid raw_tier {self.raw_tier!r}; "
                "expected ram | ram16 | disk16 | disk8")
        sel = getattr(self, "filter_flat_selectivity", 0.0)
        if not 0.0 <= sel < 1.0:
            raise ValueError(
                "filter_flat_selectivity must be in [0, 1), got "
                f"{sel} — above 1 every filtered query would silently "
                "take the exact flat scan")
        if self.rerank is not None:
            if self.index_type not in ("hnsw", "multivector"):
                raise ValueError(
                    f"rerank modules fuse into the hnsw and multivector "
                    f"search programs only; index_type "
                    f"{self.index_type!r} does not support them")
            self.rerank.validate()

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        if self.quantizer is not None:
            d["quantizer"] = self.quantizer.to_dict()
        if self.rerank is not None:
            d["rerank"] = self.rerank.to_dict()
        return d

    def as_type(self, cls: type, index_type: str) -> "VectorIndexConfig":
        """Convert to a concrete index-config subclass, preserving the live
        quantizer/rerank objects (a plain to_dict round-trip would
        flatten them)."""
        quant = self.quantizer
        rer = self.rerank
        d = self.to_dict()
        d.pop("quantizer", None)
        d.pop("rerank", None)
        d["index_type"] = index_type
        fields = {f.name for f in dataclasses.fields(cls)}
        cfg = cls(**{k: v for k, v in d.items() if k in fields})
        cfg.quantizer = quant
        cfg.rerank = rer
        return cfg

    @staticmethod
    def from_dict(d: Optional[dict]) -> "VectorIndexConfig":
        if not d:
            return FlatIndexConfig()
        d = dict(d)
        q = quantizer_from_dict(d.pop("quantizer", None))
        r = rerank_from_dict(d.pop("rerank", None))
        t = d.get("index_type", "flat")
        cls = {
            "flat": FlatIndexConfig,
            "hnsw": HNSWIndexConfig,
            "dynamic": DynamicIndexConfig,
            "multivector": MultiVectorIndexConfig,
            "hfresh": HFreshIndexConfig,
        }.get(t, FlatIndexConfig)
        fields = {f.name for f in dataclasses.fields(cls)}
        cfg = cls(**{k: v for k, v in d.items() if k in fields})
        cfg.quantizer = q
        cfg.rerank = r
        return cfg


@dataclass
class FlatIndexConfig(VectorIndexConfig):
    """Brute-force index config (reference ``entities/vectorindex/flat/config.go``):
    masked product + top-k over the corpus held in device memory."""

    index_type: str = "flat"


@dataclass
class HNSWIndexConfig(VectorIndexConfig):
    """HNSW config (reference ``entities/vectorindex/hnsw/config.go``)."""

    index_type: str = "hnsw"
    max_connections: int = 32  # M; layer0 uses 2M like the reference
    ef_construction: int = 128
    ef: int = -1  # -1 => dynamic ef from k
    dynamic_ef_min: int = 100
    dynamic_ef_max: int = 500
    dynamic_ef_factor: int = 8
    flat_search_cutoff: int = 40000
    # Filtered-search triage (reference picks SWEEPING / ACORN / RRE per
    # query, hnsw/search.go:36-41 + flat_search.go:28): allowlists under
    # flat_search_cutoff brute-force; filters below this fraction of live
    # docs take the masked flat scan; permissive filters above it walk the
    # graph. 0 disables the flat tier.
    filter_flat_selectivity: float = 0.35
    cleanup_interval_seconds: int = 300
    vector_cache_max_objects: int = 1_000_000_000_000
    # frontier candidates evaluated per device call
    frontier_batch: int = 256
    # device-resident layer-0 beam walk: one dispatch per search batch
    # instead of one per hop
    device_beam: bool = False
    # lockstep construction batch: larger = fewer device round-trips
    insert_batch: int = 1024


@dataclass
class MultiVectorIndexConfig(VectorIndexConfig):
    """ColBERT-style multi-vector index via MUVERA fixed-dim encoding
    (reference ``multivector/muvera.go:26``, ``entities/vectorindex/hnsw``
    MuveraConfig) + exact MaxSim rescore (``hnsw/search.go:927``)."""

    index_type: str = "multivector"
    distance: str = "dot"  # FDE space similarity; MaxSim rescore is exact
    ksim: int = 4           # simhash bits -> 2^ksim buckets
    dproj: int = 16         # per-bucket projection dims
    repetitions: int = 10
    rescore_limit: int = 0  # candidates for exact MaxSim (0 = 4k)


@dataclass
class HFreshIndexConfig(VectorIndexConfig):
    """SPFresh-style centroid/posting index (reference
    ``vector/hfresh/config.go``): postings split above max_posting_size,
    merge below min_posting_size, searches probe search_probe postings."""

    index_type: str = "hfresh"
    max_posting_size: int = 128
    min_posting_size: int = 8
    search_probe: int = 8
    # SPFresh boundary replication: a vector joins up to `replicas`
    # postings whose centroid distance is within rng_factor x the nearest
    # (reference hfresh.go `replicas`/`rngFactor`) — recall insurance for
    # vectors near posting boundaries
    replicas: int = 2
    rng_factor: float = 2.0


@dataclass
class DynamicIndexConfig(VectorIndexConfig):
    """Flat until threshold, then upgrade to HNSW (reference ``dynamic/index.go``)."""

    index_type: str = "dynamic"
    threshold: int = 10_000
    hnsw: Optional[dict] = None  # HNSWIndexConfig dict used after upgrade
    flat: Optional[dict] = None
    # background cutover (docs/ingest.md): past the threshold the HNSW
    # graph builds OFF-THREAD on a snapshot while searches keep serving
    # from flat, then swaps in atomically after a writer-quiesced delta
    # replay — no write ever pays the graph-build tax. False restores the
    # legacy synchronous upgrade (the unlucky write blocks until built).
    cutover_background: bool = True


# ---------------------------------------------------------------------------
# Collection (class) config
# ---------------------------------------------------------------------------


@dataclass
class InvertedIndexConfig:
    """BM25 + filter indexing knobs (reference ``entities/models/inverted_index_config.go``)."""

    bm25_k1: float = 1.2
    bm25_b: float = 0.75
    stopwords_preset: str = "en"  # en | none
    index_timestamps: bool = False
    index_null_state: bool = False
    index_property_length: bool = False
    # "ram": columnar + dict postings, whole-index snapshots (fast, RAM-bound)
    # "segment": filters/postings live in LSM buckets and stream from disk
    # segments at query time (reference inverted/searcher.go architecture)
    # "auto": ram until segment_cutoff live docs, then a background
    # migration streams the shard into the segment tier and swaps it in
    # (delta-replay catch-up, same pattern as the dynamic vector index)
    storage: str = "ram"
    segment_cutoff: int = 1_000_000


@dataclass
class MultiTenancyConfig:
    enabled: bool = False
    auto_tenant_creation: bool = False
    auto_tenant_activation: bool = False
    # tiering (docs/tiering.md): per-tenant HBM cap — a tenant whose
    # device footprint exceeds it is pinned to the warm (host RAM) tier
    # and served by the exact host fallback; 0 = no per-tenant cap
    tenant_hbm_budget_bytes: int = 0


@dataclass
class ReplicationConfig:
    factor: int = 1
    async_enabled: bool = False
    deletion_strategy: str = "NoAutomatedResolution"


@dataclass
class ShardingConfig:
    """Reference ``usecases/sharding/config.go``."""

    desired_count: int = 1
    virtual_per_physical: int = 128
    replicas: int = 1


@dataclass
class CollectionConfig:
    """A collection == reference 'class' (``entities/models/class.go``)."""

    name: str
    properties: list[Property] = field(default_factory=list)
    vector_config: VectorIndexConfig = field(default_factory=FlatIndexConfig)
    # named vectors: name -> VectorIndexConfig (reference target vectors)
    named_vectors: dict[str, VectorIndexConfig] = field(default_factory=dict)
    inverted_config: InvertedIndexConfig = field(default_factory=InvertedIndexConfig)
    multi_tenancy: MultiTenancyConfig = field(default_factory=MultiTenancyConfig)
    replication: ReplicationConfig = field(default_factory=ReplicationConfig)
    sharding: ShardingConfig = field(default_factory=ShardingConfig)
    vectorizer: str = "none"  # module name, e.g. text2vec-hash
    description: str = ""
    # ASYNC_INDEXING analogue: vectors enqueue to disk, background workers
    # batch-feed the index (reference queue/scheduler.go)
    async_indexing: bool = False
    # object TTL: objects expire this many seconds after creation
    # (reference usecases/object_ttl; 0 = disabled)
    object_ttl_seconds: int = 0
    # declared hot predicates: each entry is a Filter dict compiled to a
    # device-resident bitmap plane per shard (query/planner/planes.py);
    # predicates not listed here can still auto-promote by hit rate
    resident_filters: list = field(default_factory=list)

    def validate(self) -> None:
        if not self.name or not self.name[0].isupper():
            raise ValueError(
                f"invalid collection name {self.name!r}: must be non-empty and capitalized"
            )
        self.vector_config.validate()
        for cfg in self.named_vectors.values():
            cfg.validate()
        seen = set()
        for p in self.properties:
            if p.name in seen:
                raise ValueError(f"duplicate property {p.name!r}")
            seen.add(p.name)
            _validate_cjk_tokenization(p)

    def property(self, name: str) -> Optional[Property]:
        for p in self.properties:
            if p.name == name:
                return p
        return None

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "properties": [p.to_dict() for p in self.properties],
            "vector_config": self.vector_config.to_dict(),
            "named_vectors": {k: v.to_dict() for k, v in self.named_vectors.items()},
            "inverted_config": dataclasses.asdict(self.inverted_config),
            "multi_tenancy": dataclasses.asdict(self.multi_tenancy),
            "replication": dataclasses.asdict(self.replication),
            "sharding": dataclasses.asdict(self.sharding),
            "vectorizer": self.vectorizer,
            "description": self.description,
            "async_indexing": self.async_indexing,
            "object_ttl_seconds": self.object_ttl_seconds,
            "resident_filters": list(self.resident_filters),
        }

    @staticmethod
    def from_dict(d: dict) -> "CollectionConfig":
        return CollectionConfig(
            name=d["name"],
            properties=[Property.from_dict(p) for p in d.get("properties", [])],
            vector_config=VectorIndexConfig.from_dict(d.get("vector_config")),
            named_vectors={
                k: VectorIndexConfig.from_dict(v)
                for k, v in d.get("named_vectors", {}).items()
            },
            inverted_config=InvertedIndexConfig(**d.get("inverted_config", {})),
            multi_tenancy=MultiTenancyConfig(**d.get("multi_tenancy", {})),
            replication=ReplicationConfig(**d.get("replication", {})),
            sharding=ShardingConfig(**d.get("sharding", {})),
            vectorizer=d.get("vectorizer", "none"),
            description=d.get("description", ""),
            async_indexing=d.get("async_indexing", False),
            object_ttl_seconds=d.get("object_ttl_seconds", 0),
            resident_filters=d.get("resident_filters", []),
        )
