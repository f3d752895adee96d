"""Quantizer family: BQ / SQ / PQ / RQ — fit, encode, and the device search
glue (port of ``weaviate_tpu/compression/quantizers.py``).

Reference: ``adapters/repos/db/vector/compressionhelpers/`` —
``binary_quantization.go:18``, ``scalar_quantization.go:28``,
``product_quantization.go:155``, ``rotational_quantization.go:25``,
``binary_rotational_quantization.go:30`` (RQ bits=1 here). Each quantizer
produces named code planes stored in a ``DeviceArraySet`` and drives the
matching scan in ``ops/quantized.py``. BQ, SQ and RQ ``fit``/``encode`` are
the JAX package's host numpy code, so codes, the SQ offset/step and RQ's
rotation, offsets, steps and norms are bit-identical to it; BQ's
``encode_device`` is the same encode in torch, for codes made on the card
(held to the host encode bit for bit by the tests). PQ trains its codebooks
and assigns codes with torch ops on the index's device (JAX runs them on
its device), so a code can differ from JAX's only where two centroids lie
within float32 rounding of the nearest. Distances are asymmetric (float
query x codes), as in the reference's ``l2_float_byte`` family.
"""

from __future__ import annotations

import abc
from typing import Optional

import numpy as np
import torch

from weaviate_tpu_torch.compression.kmeans import assign_codes, segmented_kmeans
from weaviate_tpu_torch.compression.store import DeviceArraySet
from weaviate_tpu_torch.ops import quantized as qops
from weaviate_tpu_torch.schema.config import (
    BQConfig,
    PQConfig,
    QuantizerConfig,
    RQConfig,
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


class ProductQuantizer(Quantizer):
    """Segment codebooks (``product_quantization.go:155``): D/M bytes per
    vector.

    M segments x (at most) 256 centroids trained by segmented k-means
    (``compression/kmeans.py``) on ``device``, the index's device: the fit
    and the nearest-centroid assignment of ``encode`` run there (float32
    products, TF32 off as PyTorch's default leaves it); the decoded squared
    norms are summed on the host, as JAX sums them. A search decodes the codes through a bfloat16 copy of the
    codebooks (made once per fit and device) and multiplies
    (``ops/quantized.py pq_search``, kernel Q3 on the card): the products
    are bf16(q) x bf16(centroid) with float32 sums, as JAX's ``_bf16_ip``
    rounds the decoded rows, so the copy changes no distance."""

    kind = "pq"

    def __init__(self, dims: int, metric: str,
                 config: Optional[PQConfig] = None, device=None):
        super().__init__(dims, metric)
        self.config = config or PQConfig()
        m = self.config.segments or max(1, dims // 4)
        if dims % m != 0:
            # shrink to the largest divisor of dims <= m (reference validates
            # segments | dims at config time; auto mode must always work)
            while dims % m != 0:
                m -= 1
        self.m = m
        self.dsub = dims // m
        self.centroids = min(self.config.centroids, 256)
        self.codebooks: Optional[np.ndarray] = None  # [M, C, dsub] float32
        self.device = device
        # device copies keyed by device: (source codebooks, float32, bf16)
        self._cb_dev: dict = {}

    def _device(self) -> torch.device:
        from weaviate_tpu_torch.index.store import resolve_device

        return resolve_device(self.device)

    def _segments(self, vectors: np.ndarray) -> np.ndarray:
        v = np.asarray(vectors, np.float32)
        return v.reshape(v.shape[0], self.m, self.dsub).transpose(1, 0, 2)

    def fit(self, sample: np.ndarray) -> None:
        self.codebooks = segmented_kmeans(
            self._segments(sample), self.centroids, iters=10,
            device=self._device())
        self.fitted = True

    def fields(self):
        return {
            "codes": ((self.m,), np.uint8),
            "dec_sqnorm": ((), np.float32),
        }

    def encode(self, vectors: np.ndarray) -> dict[str, np.ndarray]:
        dev = self._device()
        codes = assign_codes(self._segments(vectors),
                             self.device_codebooks(dev, False), device=dev).T
        codes = np.ascontiguousarray(codes)  # [n, M]
        dec = self.decode(codes)
        return {"codes": codes, "dec_sqnorm": np.sum(dec * dec, axis=1)}

    def decode(self, codes: np.ndarray) -> np.ndarray:
        """[n, M] uint8 -> [n, D] float32 reconstruction."""
        out = self.codebooks[np.arange(self.m)[None, :], codes.astype(np.int64)]
        return out.reshape(codes.shape[0], self.dims)

    def device_codebooks(self, device, bf16: bool = True) -> torch.Tensor:
        """The codebooks on ``device``, uploaded once per fit, not once per
        call (the walks and scans read them every search batch): the
        bfloat16 copy the scans decode through, or the float32 one."""
        dev = torch.device(device)
        held = self._cb_dev.get(dev)
        if held is None or held[0] is not self.codebooks:
            f32 = torch.from_numpy(np.ascontiguousarray(
                self.codebooks, np.float32)).to(dev)
            held = (self.codebooks, f32, f32.to(torch.bfloat16))
            self._cb_dev[dev] = held
        return held[2] if bf16 else held[1]

    def search(self, qrep, store, k, mask, chunk):
        return qops.pq_search(
            qrep, store["codes"], self.device_codebooks(store["codes"].device),
            store["dec_sqnorm"], mask, self.metric, k, min(chunk, 32768))

    def gather_distance(self, qrep, store, candidate_ids):
        return qops.pq_gather_distance(
            qrep, store["codes"], self.device_codebooks(store["codes"].device),
            candidate_ids, store["dec_sqnorm"], self.metric)

    def beam_scorer(self, store):
        from weaviate_tpu_torch.ops.device_beam import PQScorer

        return PQScorer(self.metric), (
            store["codes"], self.device_codebooks(store["codes"].device),
            store["dec_sqnorm"])

    def state_dict(self) -> dict:
        return {
            **super().state_dict(), "m": self.m, "centroids": self.centroids,
            "codebooks": None if self.codebooks is None
            else self.codebooks.astype(np.float32).tobytes(),
        }

    def load_state_dict(self, d: dict) -> None:
        super().load_state_dict(d)
        self.m = int(d["m"])
        self.dsub = self.dims // self.m
        self.centroids = int(d["centroids"])
        if d.get("codebooks") is not None:
            self.codebooks = np.frombuffer(
                d["codebooks"], np.float32
            ).reshape(self.m, self.centroids, self.dsub).copy()


class RotationalQuantizer(Quantizer):
    """Random rotation + per-vector affine byte codes (LVQ-style;
    ``rotational_quantization.go:25``). bits=1 gives the BRQ variant
    (``binary_rotational_quantization.go:30``): rotation + sign bits, scored
    by the BQ scan and walk over ``rdims`` bits.

    The rotation spreads per-dimension variance so a per-vector [min, max]
    affine grid loses little; as in JAX it is a dense orthogonal matrix
    (a seeded QR, sign-fixed), padded to ``rdims``, a multiple of 64. The
    QR, the rotations and the encode are the JAX package's host numpy
    code, so codes, ``lower``, ``step`` and the decoded norms are
    bit-identical to it."""

    kind = "rq"

    def __init__(self, dims: int, metric: str,
                 config: Optional[RQConfig] = None):
        super().__init__(dims, metric)
        self.config = config or RQConfig()
        self.bits = self.config.bits
        # pad rotated space to a multiple of 64 for whole product tiles
        self.rdims = ((dims + 63) // 64) * 64
        self.rotation: Optional[np.ndarray] = None  # [rdims, rdims]
        self._bq = (
            BinaryQuantizer(self.rdims, "hamming") if self.bits == 1 else None
        )

    def fit(self, sample: np.ndarray) -> None:
        rng = np.random.default_rng(0x5EED)
        g = rng.standard_normal((self.rdims, self.rdims)).astype(np.float32)
        q, r = np.linalg.qr(g)
        # sign-fix so the decomposition is unique/deterministic
        self.rotation = (q * np.sign(np.diag(r))[None, :]).astype(np.float32)
        self.fitted = True

    def rotate(self, v: np.ndarray) -> np.ndarray:
        v = np.asarray(v, np.float32)
        if v.shape[-1] < self.rdims:
            v = np.pad(v, ((0, 0), (0, self.rdims - v.shape[-1])))
        return v @ self.rotation

    def fields(self):
        if self.bits == 1:
            return self._bq.fields()
        return {
            "codes": ((self.rdims,), np.uint8),
            "lower": ((), np.float32),
            "step": ((), np.float32),
            "dec_sqnorm": ((), np.float32),
        }

    def encode(self, vectors: np.ndarray) -> dict[str, np.ndarray]:
        r = self.rotate(vectors)
        if self.bits == 1:
            return self._bq.encode(r)
        lo = r.min(axis=1)
        hi = r.max(axis=1)
        step = np.maximum(hi - lo, 1e-12) / 255.0
        c = np.clip(
            np.rint((r - lo[:, None]) / step[:, None]), 0, 255
        ).astype(np.uint8)
        dec = lo[:, None] + step[:, None] * c.astype(np.float32)
        return {
            "codes": c, "lower": lo, "step": step,
            "dec_sqnorm": np.sum(dec * dec, axis=1),
        }

    def prep(self, queries: np.ndarray, device) -> torch.Tensor:
        q_rot = self.rotate(np.atleast_2d(queries))
        if self.bits == 1:
            return self._bq.prep(q_rot, device)
        return torch.from_numpy(np.ascontiguousarray(q_rot)).to(device)

    def search(self, qrep, store, k, mask, chunk):
        if self.bits == 1:
            return self._bq.search(qrep, store, k, mask, chunk)
        return qops.rq_search(
            qrep, store["codes"], store["lower"], store["step"],
            store["dec_sqnorm"], mask, self.metric, k, chunk)

    def gather_distance(self, qrep, store, candidate_ids):
        if self.bits == 1:
            return self._bq.gather_distance(qrep, store, candidate_ids)
        return qops.rq_gather_distance(
            qrep, store["codes"], candidate_ids, store["lower"],
            store["step"], store["dec_sqnorm"], self.metric)

    def beam_scorer(self, store):
        if self.bits == 1:
            return self._bq.beam_scorer(store)
        from weaviate_tpu_torch.ops.device_beam import RQScorer

        return RQScorer(self.metric), (
            store["codes"], store["lower"], store["step"],
            store["dec_sqnorm"])

    def state_dict(self) -> dict:
        return {
            **super().state_dict(), "bits": self.bits, "rdims": self.rdims,
            "rotation": None if self.rotation is None
            else self.rotation.tobytes(),
        }

    def load_state_dict(self, d: dict) -> None:
        super().load_state_dict(d)
        self.bits = int(d["bits"])
        self.rdims = int(d["rdims"])
        self._bq = (BinaryQuantizer(self.rdims, "hamming")
                    if self.bits == 1 else None)
        if d.get("rotation") is not None:
            self.rotation = np.frombuffer(d["rotation"], np.float32).reshape(
                self.rdims, self.rdims
            ).copy()


def build_quantizer(
    cfg: Optional[QuantizerConfig], dims: int, metric: str, device=None
) -> Optional[Quantizer]:
    """Factory (reference ``compressionhelpers/compression.go:40``), with
    the JAX package's metric checks. ``device`` is where a product
    quantizer fits and encodes (the index's device)."""
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
        return ProductQuantizer(dims, metric, cfg, device=device)
    if cfg.kind == "rq":
        return RotationalQuantizer(dims, metric, cfg)
    raise ValueError(f"unknown quantizer kind {cfg.kind!r}")
