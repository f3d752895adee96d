"""Vector compression: quantizers, segmented k-means and code stores (port
of ``weaviate_tpu/compression``)."""

from weaviate_tpu_torch.compression.kmeans import assign_codes, segmented_kmeans
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
    "assign_codes",
    "build_quantizer",
    "segmented_kmeans",
]
