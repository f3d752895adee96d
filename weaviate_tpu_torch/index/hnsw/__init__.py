"""HNSW index (port of ``weaviate_tpu/index/hnsw``)."""

from weaviate_tpu_torch.index.hnsw.graph import HostGraph
from weaviate_tpu_torch.index.hnsw.hnsw import HNSWIndex

__all__ = ["HNSWIndex", "HostGraph"]
