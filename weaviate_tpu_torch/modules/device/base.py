"""Device module SPI: rerank hooks that run beside the search on the card
(port of ``weaviate_tpu/modules/device/base.py``).

A ``DeviceRerankModule`` is a frozen (hashable) dataclass. Its identity
joins the dispatcher's batch-group key, so two requests share one batch
only when they rerank with the same module.

- ``name``: catalog id (``rerank-*``), a plain class attribute.
- ``score(q_tokens, q_mask, cand_tokens, cand_mask) -> [B, C]``: the plain
  PyTorch version, HIGHER is better. ``q_tokens [B, Tq, D]``, ``q_mask
  [B, Tq]`` bool, ``cand_tokens [B, C, T, D]``, ``cand_mask [B, C, T]``.
- ``host_score(...)``: the same arithmetic in numpy, for the host tiers
  (warm tenants, flat triage) and as the tests' reference ordering.
- ``kernel_params()``: what kernel B7a (``csrc/rerank.cu``) needs to
  compute ``score`` itself: the module's kind and its weights.
"""

from __future__ import annotations

from typing import ClassVar, Optional

import numpy as np

from weaviate_tpu_torch.modules.base import Module

# B7a's module kinds (``csrc/rerank.cu``)
KIND_MAXSIM = 0
KIND_LINEAR = 1


class DeviceRerankModule:
    """Protocol base (isinstance marker) for device rerank scorers."""

    name: ClassVar[str] = "rerank-device"

    def score(self, q_tokens, q_mask, cand_tokens, cand_mask):
        raise NotImplementedError

    def host_score(self, q_tokens, q_mask, cand_tokens, cand_mask
                   ) -> np.ndarray:
        raise NotImplementedError

    def kernel_params(self) -> tuple[int, float, float, float]:
        """(kind, w_max, w_mean, bias) for kernel B7a."""
        raise NotImplementedError

    def __call__(self, q_tokens, q_mask, cand_tokens, cand_mask):
        return self.score(q_tokens, q_mask, cand_tokens, cand_mask)


class DeviceRerankerProvider(Module):
    """Registry-visible wrapper (reference ``usecases/modules/modules.go``
    registers every module in one Provider catalog); ``build`` mints the
    frozen scorer instance. The registry itself comes with slice 9."""

    device_rerank = True  # capability marker

    def __init__(self, cls: type):
        self.name = cls.name
        self._cls = cls

    def module_type(self) -> str:
        return "device-rerank"

    def build(self, **params) -> DeviceRerankModule:
        return self._cls(**params)


def device_reranker_catalog() -> dict[str, type]:
    """name -> frozen module class for every device reranker."""
    from weaviate_tpu_torch.modules.device.linear import LinearRerank
    from weaviate_tpu_torch.modules.device.maxsim import MaxSimRerank

    return {
        MaxSimRerank.name: MaxSimRerank,
        LinearRerank.name: LinearRerank,
    }


def build_device_reranker(name: str, params: Optional[dict] = None
                          ) -> DeviceRerankModule:
    """Instantiate a frozen device reranker from the catalog. Unknown
    params raise (a typo'd weight silently defaulting would change
    ranking quality without a trace)."""
    catalog = device_reranker_catalog()
    cls = catalog.get(name)
    if cls is None:
        raise KeyError(
            f"device rerank module {name!r} not in catalog "
            f"{sorted(catalog)}")
    return cls(**(params or {}))


class RerankRequest:
    """Per-request rerank spec carried into the coalescing dispatcher. Two
    requests share one device batch only when their module instance AND
    padded query-token shape agree (``group_key``).

    ``query_tokens=None`` is *self* mode: each query row's own vector is
    its 1-token set. A ``[Tq, D]`` matrix is an explicit late-interaction
    token set shared by every row of this request; Tq pads to a power of
    two (``tq_pad``), the padding masked.
    """

    __slots__ = ("module", "query_tokens", "query_mask", "tq_pad")

    def __init__(self, module: DeviceRerankModule,
                 query_tokens: Optional[np.ndarray] = None):
        self.module = module
        if query_tokens is None:
            self.query_tokens = None
            self.query_mask = None
            self.tq_pad = 1
            return
        qt = np.atleast_2d(np.asarray(query_tokens, np.float32))
        tq = qt.shape[0]
        self.tq_pad = 1 << max(0, (tq - 1).bit_length())
        padded = np.zeros((self.tq_pad, qt.shape[1]), np.float32)
        padded[:tq] = qt
        mask = np.zeros((self.tq_pad,), bool)
        mask[:tq] = True
        self.query_tokens = padded
        self.query_mask = mask

    @property
    def group_key(self) -> tuple:
        """Dispatcher batch-group identity (hashable)."""
        dims = (None if self.query_tokens is None
                else self.query_tokens.shape[1])
        return (self.module, self.tq_pad, dims)

    def batch_for(self, queries: np.ndarray
                  ) -> tuple[DeviceRerankModule, np.ndarray, np.ndarray]:
        """-> (module, q_tokens [B, Tq, D], q_mask [B, Tq]) for one
        request's query rows (the dispatcher concatenates these across a
        coalesced group)."""
        q = np.atleast_2d(np.asarray(queries, np.float32))
        b = q.shape[0]
        if self.query_tokens is None:
            return (self.module, q[:, None, :].astype(np.float32),
                    np.ones((b, 1), bool))
        qt = np.broadcast_to(
            self.query_tokens[None], (b, *self.query_tokens.shape))
        qm = np.broadcast_to(self.query_mask[None], (b, self.tq_pad))
        return self.module, np.ascontiguousarray(qt), \
            np.ascontiguousarray(qm)
