"""Device module tier: rerank hooks that run on the card beside the search
(port of ``weaviate_tpu/modules/device/``).

A rerank module scores a search's candidates against their token sets: in
the HNSW rerank tier after the fused walk (B2), and in the multivector
index after the FDE scan. On the card the whole stage (gather the token
planes, score, top-k) is one launch of the hand-written kernel B7a
(``ops/rerank.py``, ``csrc/rerank.cu``); on CPU tensors its plain version.
"""

from weaviate_tpu_torch.modules.device.base import (
    DeviceRerankModule,
    DeviceRerankerProvider,
    RerankRequest,
    build_device_reranker,
    device_reranker_catalog,
)
from weaviate_tpu_torch.modules.device.linear import LinearRerank
from weaviate_tpu_torch.modules.device.maxsim import MaxSimRerank
from weaviate_tpu_torch.modules.device.store import CandidateTokenStore

__all__ = [
    "DeviceRerankModule",
    "DeviceRerankerProvider",
    "RerankRequest",
    "build_device_reranker",
    "device_reranker_catalog",
    "MaxSimRerank",
    "LinearRerank",
    "CandidateTokenStore",
]
