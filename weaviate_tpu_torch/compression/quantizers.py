"""Quantizer family (port of the BQ and SQ half of
``weaviate_tpu/compression/quantizers.py``): fit, encode, and the device
search glue.

Reference: ``adapters/repos/db/vector/compressionhelpers/`` —
``binary_quantization.go:18``, ``scalar_quantization.go:28``. Each quantizer
produces named code planes stored in a ``DeviceArraySet`` and drives the
matching scan in ``ops/quantized.py``. ``fit`` and ``encode`` are the JAX
package's host numpy code, so codes and the SQ offset/step are bit-identical
to it; BQ's ``encode_device`` is the same encode in torch, for codes made on
the card (held to the host encode bit for bit by the tests). Distances are
asymmetric (float query x codes), as in the reference's ``l2_float_byte``
family. ``ProductQuantizer`` and ``RotationalQuantizer`` come with slice 4b
and raise.
"""

from __future__ import annotations

import abc
from typing import Optional

import numpy as np
import torch

from weaviate_tpu_torch.compression.store import DeviceArraySet
from weaviate_tpu_torch.ops import quantized as qops
from weaviate_tpu_torch.schema.config import (
    BQConfig,
    QuantizerConfig,
    SQConfig,
)


class Quantizer(abc.ABC):
    """Trainable vector compressor + its device search kernels."""

    kind: str = "none"
    #: minimum live vectors before fit() is attempted (BQ overrides to 0)
    min_training: int = 256

    def __init__(self, dims: int, metric: str):
        self.dims = dims
        self.metric = metric
        self.fitted = False

    @abc.abstractmethod
    def fit(self, sample: np.ndarray) -> None:
        """Train on a sample of live vectors (normalized already for cosine)."""

    @abc.abstractmethod
    def fields(self) -> dict[str, tuple[tuple[int, ...], np.dtype]]:
        """Device code-plane layout for DeviceArraySet."""

    @abc.abstractmethod
    def encode(self, vectors: np.ndarray) -> dict[str, np.ndarray]:
        """[n, D] float32 -> named code planes (one row per vector)."""

    def prep(self, queries: np.ndarray, device) -> torch.Tensor:
        """Host float32 queries -> the device query rep for search and
        gathers, computed once per query batch and reused across every
        frontier hop."""
        return torch.from_numpy(np.ascontiguousarray(
            np.atleast_2d(queries), np.float32)).to(device)

    @abc.abstractmethod
    def search(self, qrep, store: DeviceArraySet, k: int,
               mask: Optional[torch.Tensor], chunk: int):
        """Top-k over the code planes. ``qrep`` from prep(). Returns
        (dists, ids)."""

    @abc.abstractmethod
    def gather_distance(self, qrep, store: DeviceArraySet, candidate_ids):
        """Per-query candidate distances (the HNSW host walk in code space)."""

    def beam_scorer(self, store: DeviceArraySet):
        """(scorer, operands) for the fused device walk
        (``ops/device_beam.py``)."""
        return None

    # -- persistence ------------------------------------------------------
    def state_dict(self) -> dict:
        return {"kind": self.kind, "dims": self.dims, "metric": self.metric,
                "fitted": self.fitted}

    def load_state_dict(self, d: dict) -> None:
        self.fitted = bool(d.get("fitted", False))


class BinaryQuantizer(Quantizer):
    """Sign-bit compression; hamming distance (``binary_quantization.go:18``).

    32x smaller than float32. No training. Corpus bits stay packed in device
    memory (uint32 words held as int32)."""

    kind = "bq"
    min_training = 0

    def __init__(self, dims: int, metric: str, config: Optional[BQConfig] = None):
        super().__init__(dims, metric)
        self.config = config or BQConfig()
        self.words = (dims + 31) // 32
        self.fitted = True

    def fit(self, sample: np.ndarray) -> None:
        pass

    def fields(self):
        return {
            "packed": ((self.words,), np.uint32),
            "popcount": ((), np.float32),
        }

    def encode(self, vectors: np.ndarray) -> dict[str, np.ndarray]:
        bits = (np.asarray(vectors, np.float32) > 0).astype(np.uint32)
        return {
            "packed": qops.pack_bits_host(bits),
            "popcount": bits.sum(axis=1).astype(np.float32),
        }

    def encode_device(self, vectors: torch.Tensor) -> dict[str, torch.Tensor]:
        """``encode`` of a float32 tensor, in torch on its device: the packed
        words as int32 bits and the popcounts."""
        bits = (vectors.float() > 0).to(torch.int64)
        n = bits.shape[0]
        padded = bits.new_zeros((n, self.words * 32))
        padded[:, :self.dims] = bits
        shifts = torch.arange(32, device=bits.device, dtype=torch.int64)
        words = (padded.view(n, self.words, 32) << shifts).sum(-1)
        words = torch.where(words >= (1 << 31), words - (1 << 32), words)
        return {"packed": words.to(torch.int32),
                "popcount": bits.sum(1).to(torch.float32)}

    def prep(self, queries: np.ndarray, device) -> torch.Tensor:
        bits = (np.atleast_2d(np.asarray(queries, np.float32)) > 0).astype(
            np.uint32)
        return torch.from_numpy(
            qops.pack_bits_host(bits).view(np.int32)).to(device)

    def search(self, qrep, store, k, mask, chunk):
        return qops.bq_search(qrep, store["packed"], store["popcount"], mask,
                              self.dims, k, chunk)

    def gather_distance(self, qrep, store, candidate_ids):
        return qops.bq_gather_distance(qrep, store["packed"], candidate_ids,
                                       store["popcount"], self.dims)

    def beam_scorer(self, store):
        from weaviate_tpu_torch.ops.device_beam import BQScorer

        return BQScorer(self.dims), (store["packed"], store["popcount"])


class ScalarQuantizer(Quantizer):
    """Global-affine byte codes (``scalar_quantization.go:28``): 4x smaller.

    Codes c = round((x - a) / s) clipped to [0, 255]; a/s come from robust
    percentiles of the training sample."""

    kind = "sq"

    def __init__(self, dims: int, metric: str, config: Optional[SQConfig] = None):
        super().__init__(dims, metric)
        self.config = config or SQConfig()
        self.a = 0.0
        self.s = 1.0

    def fit(self, sample: np.ndarray) -> None:
        lo = float(np.percentile(sample, 0.1))
        hi = float(np.percentile(sample, 99.9))
        if hi <= lo:
            hi = lo + 1e-6
        self.a = lo
        self.s = (hi - lo) / 255.0
        self.fitted = True

    def fields(self):
        return {
            "codes": ((self.dims,), np.uint8),
            "dec_sqnorm": ((), np.float32),
        }

    def encode(self, vectors: np.ndarray) -> dict[str, np.ndarray]:
        v = np.asarray(vectors, np.float32)
        c = np.clip(np.rint((v - self.a) / self.s), 0, 255).astype(np.uint8)
        dec = self.a + self.s * c.astype(np.float32)
        return {"codes": c, "dec_sqnorm": np.sum(dec * dec, axis=1)}

    def search(self, qrep, store, k, mask, chunk):
        return qops.sq_search(qrep, store["codes"], store["dec_sqnorm"],
                              self.a, self.s, mask, self.metric, k, chunk)

    def gather_distance(self, qrep, store, candidate_ids):
        return qops.sq_gather_distance(qrep, store["codes"], candidate_ids,
                                       store["dec_sqnorm"], self.a, self.s,
                                       self.metric)

    def beam_scorer(self, store):
        from weaviate_tpu_torch.ops.device_beam import SQScorer

        return SQScorer(self.metric), (
            store["codes"], store["dec_sqnorm"], self.a, self.s)

    def state_dict(self) -> dict:
        return {**super().state_dict(), "a": self.a, "s": self.s}

    def load_state_dict(self, d: dict) -> None:
        super().load_state_dict(d)
        self.a = float(d["a"])
        self.s = float(d["s"])


class ProductQuantizer:
    """Segment codebooks (``product_quantization.go:155``): slice 4b."""

    kind = "pq"

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "product quantizer: not ported yet (ROADMAP queue A, slice 4b)")


class RotationalQuantizer:
    """Rotation + per-vector affine codes (``rotational_quantization.go:25``):
    slice 4b."""

    kind = "rq"

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "rotational quantizer: not ported yet (ROADMAP queue A, "
            "slice 4b)")


def build_quantizer(
    cfg: Optional[QuantizerConfig], dims: int, metric: str
) -> Optional[Quantizer]:
    """Factory (reference ``compressionhelpers/compression.go:40``), with
    the JAX package's metric checks."""
    if cfg is None or not cfg.enabled:
        return None
    if metric == "hamming" and cfg.kind != "bq":
        raise ValueError("hamming metric only supports bq compression")
    if cfg.kind in ("sq", "pq", "rq") and metric not in (
        "l2-squared", "dot", "cosine"
    ):
        # the affine/decode kernels have no manhattan formulation; scoring it
        # as cosine would silently pick the wrong candidates
        raise ValueError(f"{cfg.kind} compression does not support {metric!r}")
    if cfg.kind == "bq":
        return BinaryQuantizer(dims, metric, cfg)
    if cfg.kind == "sq":
        return ScalarQuantizer(dims, metric, cfg)
    if cfg.kind == "pq":
        return ProductQuantizer(dims, metric, cfg)
    if cfg.kind == "rq":
        return RotationalQuantizer(dims, metric, cfg)
    raise ValueError(f"unknown quantizer kind {cfg.kind!r}")
