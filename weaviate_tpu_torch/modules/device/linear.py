"""Cross-encoder-shaped linear rerank module (port of
``weaviate_tpu/modules/device/linear.py``): a weighted blend of late
interaction (MaxSim) and the mean-pooled dot product, with frozen scalar
weights (two differently weighted instances never share a batch)."""

from __future__ import annotations

import dataclasses
from typing import ClassVar

import numpy as np
import torch

from weaviate_tpu_torch.modules.device.base import (
    KIND_LINEAR,
    DeviceRerankModule,
)


@dataclasses.dataclass(frozen=True)
class LinearRerank(DeviceRerankModule):
    """score = w_max * MaxSim + w_mean * (mean_q . mean_d) + bias, the
    means over the valid tokens, their counts clamped to at least 1."""

    name: ClassVar[str] = "rerank-linear"

    w_max: float = 1.0
    w_mean: float = 0.25
    bias: float = 0.0

    def score(self, q_tokens, q_mask, cand_tokens, cand_mask):
        from weaviate_tpu_torch.modules.device.maxsim import batched_maxsim

        q_tokens = q_tokens.float()
        cand_tokens = cand_tokens.float()
        maxsim = batched_maxsim(q_tokens, q_mask, cand_tokens, cand_mask)
        qn = q_mask.sum(dim=1).clamp(min=1)[:, None]
        qm = torch.where(q_mask[..., None], q_tokens, 0.0).sum(dim=1) \
            / qn.float()                                            # [B, D]
        cn = cand_mask.sum(dim=2).clamp(min=1)[..., None]
        cm = torch.where(cand_mask[..., None], cand_tokens, 0.0).sum(dim=2) \
            / cn.float()                                            # [B, C, D]
        mean_dot = torch.einsum("bd,bcd->bc", qm, cm)
        return (torch.tensor(self.w_max, dtype=torch.float32) * maxsim
                + torch.tensor(self.w_mean, dtype=torch.float32) * mean_dot
                + torch.tensor(self.bias, dtype=torch.float32))

    def host_score(self, q_tokens, q_mask, cand_tokens, cand_mask
                   ) -> np.ndarray:
        from weaviate_tpu_torch.modules.device.maxsim import (
            batched_maxsim_host,
        )

        q_tokens = np.asarray(q_tokens, np.float32)
        cand_tokens = np.asarray(cand_tokens, np.float32)
        maxsim = batched_maxsim_host(q_tokens, q_mask, cand_tokens,
                                     cand_mask)
        qn = np.maximum(q_mask.sum(axis=1), 1)[:, None]
        qm = np.where(q_mask[..., None], q_tokens, 0.0).sum(axis=1) / qn
        cn = np.maximum(cand_mask.sum(axis=2), 1)[..., None]
        cm = np.where(cand_mask[..., None], cand_tokens, 0.0).sum(axis=2) / cn
        mean_dot = np.einsum("bd,bcd->bc", qm, cm)
        return (self.w_max * maxsim + self.w_mean * mean_dot
                + self.bias).astype(np.float32)

    def kernel_params(self) -> tuple[int, float, float, float]:
        return KIND_LINEAR, float(self.w_max), float(self.w_mean), \
            float(self.bias)
