"""Vector-index configuration (port of ``VectorIndexConfig`` and
``FlatIndexConfig`` from ``weaviate_tpu/schema/config.py``).

The defaults and checks of the ported fields are the JAX package's. The
quantizer, the rerank module and the index types other than ``flat`` come
with their slices: a config naming one is kept, and the flat factory or
``validate`` refuses it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

# index types with an implementation in the port
AVAILABLE_INDEX_TYPES = ("flat",)


@dataclass
class VectorIndexConfig:
    """Common knobs for every vector index."""

    index_type: str = "flat"
    distance: str = "cosine"  # l2-squared | dot | cosine | manhattan | hamming
    # quantizer config (enabled quantizers arrive with the quantizer slice)
    quantizer: Optional[Any] = None
    # fused device rerank module (arrives with the rerank slice)
    rerank: Optional[Any] = None
    precision: str = "bf16"  # matmul precision: bf16 | fp32
    initial_capacity: int = 1024
    search_chunk_size: int = 131072
    # Flat-scan selection: -1 = unset (follows the runtime-config default);
    # 0 = pinned exact; in (0, 1) = approximate selection allowed with this
    # recall target, which routes l2/bf16 scans with k <= 64 to the fused
    # kernel (ops/fused_flat.py).
    flat_approx_recall: float = -1.0

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
        if self.rerank is not None:
            raise ValueError(
                f"rerank modules fuse into the hnsw and multivector search "
                f"programs only; index_type {self.index_type!r} does not "
                f"support them")


@dataclass
class FlatIndexConfig(VectorIndexConfig):
    """Brute-force index config: masked product + top-k over the corpus
    held in device memory."""

    index_type: str = "flat"
