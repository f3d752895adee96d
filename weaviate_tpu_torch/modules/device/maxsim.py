"""ColBERT-style MaxSim (late interaction) as a device rerank module (port
of ``weaviate_tpu/modules/device/maxsim.py``).

Sum over query tokens of the max dot product over document tokens, over a
batched candidate axis. ``batched_maxsim`` is the plain PyTorch version of
the score kernel B7a computes (``csrc/rerank.cu``).
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar

import numpy as np
import torch

from weaviate_tpu_torch.modules.device.base import (
    KIND_MAXSIM,
    DeviceRerankModule,
)


def batched_maxsim(q_tokens, q_mask, cand_tokens, cand_mask):
    """[B, C] masked MaxSim in float32 torch ops: masked document tokens
    are -inf before the max; a candidate with no live token adds 0 per
    query token; masked query tokens add 0."""
    sims = torch.einsum("bqd,bctd->bcqt", q_tokens.float(),
                        cand_tokens.float())
    sims = torch.where(cand_mask[:, :, None, :], sims, -torch.inf)
    best = sims.amax(dim=3) if sims.shape[3] else torch.full(
        sims.shape[:3], -torch.inf, device=sims.device)
    best = torch.where(torch.isfinite(best), best, 0.0)
    best = torch.where(q_mask[:, None, :], best, 0.0)
    return best.sum(dim=2)


def batched_maxsim_host(q_tokens, q_mask, cand_tokens, cand_mask
                        ) -> np.ndarray:
    """The numpy twin of :func:`batched_maxsim` (host tiers)."""
    sims = np.einsum("bqd,bctd->bcqt",
                     np.asarray(q_tokens, np.float32),
                     np.asarray(cand_tokens, np.float32))
    sims = np.where(cand_mask[:, :, None, :], sims, -np.inf)
    best = sims.max(axis=3)
    best = np.where(np.isfinite(best), best, 0.0)
    best = np.where(q_mask[:, None, :], best, 0.0)
    return best.sum(axis=2).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class MaxSimRerank(DeviceRerankModule):
    """score[b, c] = sum_q max_t q_tokens[b, q] . cand_tokens[b, c, t]."""

    name: ClassVar[str] = "rerank-maxsim"

    def score(self, q_tokens, q_mask, cand_tokens, cand_mask):
        return batched_maxsim(q_tokens, q_mask, cand_tokens, cand_mask)

    def host_score(self, q_tokens, q_mask, cand_tokens, cand_mask
                   ) -> np.ndarray:
        return batched_maxsim_host(q_tokens, q_mask, cand_tokens,
                                   cand_mask)

    def kernel_params(self) -> tuple[int, float, float, float]:
        return KIND_MAXSIM, 1.0, 0.0, 0.0
