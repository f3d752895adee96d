"""Top-k selection and merge helpers (port of ``weaviate_tpu/ops/topk.py``).

``lax.top_k`` puts the lower index first among equal values and
``torch.topk`` promises no order on ties, so every selection here is an
ascending ``torch.sort(..., stable=True)``: equal distances keep their input
order, which is the JAX tie rule. ``merge_across_shards`` comes with the
multi-GPU slice.
"""

from __future__ import annotations

from typing import Optional

import torch


def smallest_k(vals: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` smallest entries of the last axis in ascending order, ties
    by lower position first: ``(values, positions)``."""
    v, pos = torch.sort(vals, dim=-1, stable=True)
    return v[..., :k], pos[..., :k]


def merge_topk(
    vals_a: torch.Tensor,
    ids_a: torch.Tensor,
    vals_b: torch.Tensor,
    ids_b: torch.Tensor,
    k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge two per-query top-k candidate sets (lower value = better).

    vals_*: [B, ka] / [B, kb] distances; ids_*: matching int32 ids.
    Returns ([B, k], [B, k]).
    """
    vals = torch.cat([vals_a, vals_b], dim=1)
    ids = torch.cat([ids_a, ids_b], dim=1)
    v, sel = smallest_k(vals, k)
    return v, torch.gather(ids, 1, sel)


def merge_candidate_stack(
    vals: torch.Tensor, ids: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Final merge of per-chunk candidates stacked as [C, B, k'] (one [B, k']
    block per chunk): flattens to [B, C*k'] and selects once."""
    b = vals.shape[1]
    cand_v = vals.transpose(0, 1).reshape(b, -1)
    cand_i = ids.transpose(0, 1).reshape(b, -1)
    v, sel = smallest_k(cand_v, k)
    return v, torch.gather(cand_i, 1, sel)


def masked_topk(
    dists: torch.Tensor,
    k: int,
    mask: Optional[torch.Tensor] = None,
    mask_value: float = 1e30,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k smallest distances with an optional boolean keep-mask.

    dists: [B, N]; mask: [N] or [B, N] (True = eligible).
    Returns (dists [B, k], ids [B, k] int32) with ineligible slots id=-1.
    """
    if mask is not None:
        if mask.ndim == 1:
            mask = mask[None, :]
        dists = torch.where(mask, dists, mask_value)
    vals, ids = smallest_k(dists, k)
    ids = torch.where(vals >= mask_value, -1, ids.to(torch.int32))
    return vals, ids
