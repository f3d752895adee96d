"""Vector compression: quantizers and code stores (port of
``weaviate_tpu/compression``; PQ, RQ and k-means come with slice 4b)."""

from weaviate_tpu_torch.compression.quantizers import (
    BinaryQuantizer,
    ProductQuantizer,
    Quantizer,
    RotationalQuantizer,
    ScalarQuantizer,
    build_quantizer,
)
from weaviate_tpu_torch.compression.store import DeviceArraySet, HostVectorStore

__all__ = [
    "BinaryQuantizer",
    "DeviceArraySet",
    "HostVectorStore",
    "ProductQuantizer",
    "Quantizer",
    "RotationalQuantizer",
    "ScalarQuantizer",
    "build_quantizer",
]
