"""Batched distance computation (port of ``weaviate_tpu/ops/distance.py``).

Distance semantics are the JAX package's, lower is better:

- ``l2-squared``: sum((a-b)^2)
- ``dot``:        -dot(a, b)
- ``cosine``:     1 - dot(a, b) on pre-normalized vectors
- ``manhattan``:  sum(|a-b|)
- ``hamming``:    count of differing dimensions

``precision="bf16"`` rounds both operands to bfloat16 and sums their
products in float32 (JAX's ``preferred_element_type=jnp.float32``). It is
written as a float32 product of bf16-rounded values: a bf16 ``torch.matmul``
returns bf16 and would round the float32 sums away. ``precision="fp32"`` is
a float32 product; on the card it must not run in TF32, which is PyTorch's
default (``torch.backends.cuda.matmul.allow_tf32`` is False) and which a
caller computing an exact ground truth sets explicitly.
"""

from __future__ import annotations

from typing import Optional

import torch

from weaviate_tpu_torch.ops.topk import (
    merge_candidate_stack,
    merge_topk,
    smallest_k,
)

METRICS = ("l2-squared", "dot", "cosine", "manhattan", "hamming")

# Large-but-finite sentinel for masked-out candidates: far below float32 max,
# so arithmetic on sentinels cannot overflow to inf.
MASK_DISTANCE = 1e30


def normalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """L2-normalize along the last axis (cosine pre-processing). The squared
    norm is summed in float32 and rounded to ``v``'s dtype before the square
    root, as ``jnp.linalg.norm`` does for bfloat16 input."""
    vf = v.float()
    n = torch.sqrt(torch.sum(vf * vf, dim=-1, keepdim=True).to(v.dtype))
    return v / torch.clamp(n, min=eps)


def _operands(t: torch.Tensor, precision: str) -> torch.Tensor:
    """The float32 operand of a product at ``precision``: bf16-rounded for
    ``bf16``, so float32 products and sums of it equal a bf16 x bf16 ->
    float32 product up to summation order."""
    if precision == "bf16":
        t = t.to(torch.bfloat16)
    return t.float()


def _matmul(q: torch.Tensor, c: torch.Tensor, precision: str) -> torch.Tensor:
    """[B, D] x [N, D] -> [B, N] inner products, float32 out."""
    return _operands(q, precision) @ _operands(c, precision).T


def pairwise_distance(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    metric: str,
    corpus_sqnorms: Optional[torch.Tensor] = None,
    precision: str = "fp32",
) -> torch.Tensor:
    """All-pairs distances ``[B, N]`` between queries ``[B, D]`` and corpus
    ``[N, D]``. l2-squared expands to ||q||^2 - 2 q.c + ||c||^2 so the hot op
    is one matrix product; ``corpus_sqnorms`` ([N]) may be precomputed."""
    if metric not in METRICS:
        raise ValueError(f"unknown metric {metric!r}; want one of {METRICS}")
    if metric == "l2-squared":
        ip = _matmul(queries, corpus, precision)
        if corpus_sqnorms is None:
            cf = corpus.float()
            corpus_sqnorms = torch.sum(cf * cf, dim=-1)
        qf = queries.float()
        q_sq = torch.sum(qf * qf, dim=-1)
        d = q_sq[:, None] - 2.0 * ip + corpus_sqnorms.float()[None, :]
        return torch.clamp(d, min=0.0)
    if metric == "dot":
        return -_matmul(queries, corpus, precision)
    if metric == "cosine":
        # vectors are stored normalized, so cosine distance is 1 - ip
        return 1.0 - _matmul(queries, corpus, precision)
    # manhattan / hamming have no product form; cdist evaluates them
    # without materializing the [B, N, D] broadcast (p=0 counts the
    # dimensions that differ)
    p = 1.0 if metric == "manhattan" else 0.0
    return torch.cdist(queries.float(), corpus.float(), p=p)


def gather_distance(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    candidate_ids: torch.Tensor,
    metric: str,
    precision: str = "fp32",
) -> torch.Tensor:
    """Distances between each query ``[B, D]`` and its own candidate set
    ``candidate_ids`` ``[B, C]`` (indices into corpus ``[N, D]``) -> [B, C].
    The HNSW frontier-evaluation primitive."""
    cand = corpus[candidate_ids.long()]  # [B, C, D]
    q = queries[:, None, :]
    if metric == "l2-squared":
        diff = q.float() - cand.float()
        return torch.sum(diff * diff, dim=-1)
    if metric in ("dot", "cosine"):
        ip = torch.einsum("bqd,bcd->bc", _operands(q, precision),
                          _operands(cand, precision))
        return -ip if metric == "dot" else 1.0 - ip
    if metric == "manhattan":
        return torch.sum(torch.abs(q.float() - cand.float()), dim=-1)
    if metric == "hamming":
        return torch.sum((q != cand).float(), dim=-1)
    raise ValueError(f"unknown metric {metric!r}")


def vectors_pairwise(
    v: torch.Tensor,
    metric: str,
    precision: str = "fp32",
) -> torch.Tensor:
    """Pairwise distances within each gathered candidate set:
    [B, C, D] -> [B, C, C]."""
    vf = _operands(v, precision)
    ip = torch.einsum("bcd,bed->bce", vf, vf)
    if metric == "l2-squared":
        sq = torch.sum(v.float() ** 2, dim=-1)
        d = sq[:, :, None] - 2.0 * ip + sq[:, None, :]
        return torch.clamp(d, min=0.0)
    if metric == "dot":
        return -ip
    if metric == "cosine":
        return 1.0 - ip
    diff = v[:, :, None, :].float() - v[:, None, :, :].float()
    if metric == "manhattan":
        return torch.sum(torch.abs(diff), dim=-1)
    return torch.sum((diff != 0).float(), dim=-1)


def candidate_pairwise(
    corpus: torch.Tensor,
    candidate_ids: torch.Tensor,
    metric: str,
    precision: str = "fp32",
) -> torch.Tensor:
    """Pairwise distances within each candidate set: [B, C] ids ->
    [B, C, C] (the batched HNSW neighbor-selection heuristic's input)."""
    return vectors_pairwise(corpus[candidate_ids.long()], metric, precision)


def select_topk(
    d: torch.Tensor, k: int, approx_recall: float = 0.0
) -> tuple[torch.Tensor, torch.Tensor]:
    """Smallest-k selection over the last axis, ties by lower index.

    Always exact: ``approx_recall`` is accepted for signature parity with
    the JAX function, whose ``lax.approx_min_k`` is TPU-only and lowers to
    this exact selection everywhere else.
    """
    del approx_recall
    return smallest_k(d, k)


def flat_search(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    k: int,
    metric: str = "l2-squared",
    valid_mask: Optional[torch.Tensor] = None,
    allow_mask: Optional[torch.Tensor] = None,
    corpus_sqnorms: Optional[torch.Tensor] = None,
    chunk_size: int = 0,
    precision: str = "fp32",
    approx_recall: float = 0.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Brute-force top-k over a padded corpus.

    queries      [B, D] float
    corpus       [N, D] float (padded to capacity; see valid_mask)
    valid_mask   [N] bool — False for pad slots / tombstoned ids
    allow_mask   [N] bool — optional filter allowlist
    chunk_size   score the corpus in chunks of this many rows to bound the
                 [B, chunk] score matrix (0 = single shot); a tail shorter
                 than a chunk is scored and merged last.

    Each chunk yields [B, k] candidates; they are merged once at the end.
    Returns (distances [B, k] float32, ids [B, k] int32); masked/empty
    slots have distance MASK_DISTANCE and id -1.
    """
    n = corpus.shape[0]
    b = queries.shape[0]
    mask = valid_mask
    if allow_mask is not None:
        mask = allow_mask if mask is None else (mask & allow_mask)

    def score_block(start: int, stop: int):
        norms = corpus_sqnorms[start:stop] if corpus_sqnorms is not None else None
        d = pairwise_distance(queries, corpus[start:stop], metric,
                              corpus_sqnorms=norms, precision=precision)
        if mask is not None:
            d = torch.where(mask[start:stop][None, :], d, MASK_DISTANCE)
        kk = min(k, stop - start)
        vals, idx = select_topk(d, kk, approx_recall)
        ids = idx.to(torch.int32) + start
        if kk < k:
            pad = k - kk
            vals = torch.cat(
                [vals, vals.new_full((b, pad), MASK_DISTANCE)], dim=1)
            ids = torch.cat([ids, ids.new_full((b, pad), -1)], dim=1)
        return vals, ids

    if chunk_size <= 0 or chunk_size >= n:
        vals, ids = score_block(0, n)
    else:
        n_full = (n // chunk_size) * chunk_size
        blocks = [score_block(s, s + chunk_size)
                  for s in range(0, n_full, chunk_size)]
        vals, ids = merge_candidate_stack(
            torch.stack([v for v, _ in blocks]),
            torch.stack([i for _, i in blocks]), k)
        if n_full < n:
            v, idx = score_block(n_full, n)
            vals, ids = merge_topk(vals, ids, v, idx, k)

    ids = torch.where(vals >= MASK_DISTANCE, -1, ids)
    return vals, ids
