"""Multi-vector (ColBERT-style) index: MUVERA FDE + exact MaxSim rerank
(port of ``weaviate_tpu/index/multivector.py``).

Reference: ``adapters/repos/db/vector/multivector/muvera.go:26`` (fixed
dimensional encoding) + ``hnsw/search.go:927`` (late-interaction rescore).

- ``MuveraEncoder`` encodes a token set into one fixed-dimensional vector
  (FDE): SimHash buckets from the signs of Gaussian projections, a mean
  (documents; empty buckets take the hamming-nearest token) or a sum
  (queries) per bucket, then a +-1 projection a repetition. Its random
  matrices are the JAX package's: ``jax.random`` under threefry2x32 in its
  partitionable mode, reimplemented here in numpy (``_threefry2x32``,
  ``_normal``, ``_rademacher``), so the projection matrix is equal bit for
  bit and the Gaussians agree to float32 rounding (XLA's ``erf_inv``
  polynomial, evaluated in numpy).
- The FDE corpus lives in a ``FlatIndex`` (dot metric) on the card; the
  token sets live in a ``CandidateTokenStore`` (``modules/device/``).
- A search is the flat scan over the FDEs and then the rerank stage over
  its candidates (``ops/device_beam.py fused_flat_rerank``): on the card
  the candidate ids never leave it, the stage one launch of kernel B7a.
  A demoted index (the warm tier) serves from the host planes.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from weaviate_tpu_torch.index.base import SearchResult, VectorIndex
from weaviate_tpu_torch.index.flat import FlatIndex
from weaviate_tpu_torch.schema.config import (
    FlatIndexConfig,
    MultiVectorIndexConfig,
)

MUVERA_SEED = 0x532C_A510

# ---------------------------------------------------------------------------
# jax.random's threefry2x32 draws, in numpy (the partitionable mode)
# ---------------------------------------------------------------------------

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _threefry2x32(key, x0: np.ndarray, x1: np.ndarray):
    """The threefry2x32 block cipher (20 rounds) of the counters (x0, x1)
    under ``key`` (two uint32): -> two uint32 arrays."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x0 = (np.asarray(x0, np.uint32) + ks[0]).astype(np.uint32)
    x1 = (np.asarray(x1, np.uint32) + ks[1]).astype(np.uint32)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1).astype(np.uint32)
            x1 = ((x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))).astype(
                np.uint32)
            x1 = x0 ^ x1
        x0 = (x0 + ks[(i + 1) % 3]).astype(np.uint32)
        x1 = (x1 + ks[(i + 2) % 3] + np.uint32(i + 1)).astype(np.uint32)
    return x0, x1


def _counters(n: int):
    """The 64-bit iota 0..n-1 as (hi, lo) uint32 words."""
    idx = np.arange(n, dtype=np.uint64)
    return ((idx >> np.uint64(32)).astype(np.uint32),
            (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def _prng_key(seed: int) -> tuple[int, int]:
    """``jax.random.PRNGKey(seed)`` for a seed below 2**32."""
    return (seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF


def _split(key, num: int = 2) -> list[tuple[int, int]]:
    """``jax.random.split`` (partitionable): key i = threefry(key, i)."""
    b0, b1 = _threefry2x32(key, *_counters(num))
    return [(int(b0[i]), int(b1[i])) for i in range(num)]


def _random_bits(key, shape) -> np.ndarray:
    """32 random bits per element (partitionable): the xor of the two
    words threefry gives the element's flat index."""
    n = int(np.prod(shape))
    b0, b1 = _threefry2x32(key, *_counters(n))
    return (b0 ^ b1).reshape(shape)


def _uniform(key, shape, minval: float = 0.0, maxval: float = 1.0
             ) -> np.ndarray:
    """``jax.random.uniform`` in float32: 23 random mantissa bits in
    [1, 2), less 1, scaled, at least ``minval``."""
    bits = _random_bits(key, shape)
    fl = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32)
    fl = fl - np.float32(1.0)
    lo, hi = np.float32(minval), np.float32(maxval)
    return np.maximum(lo, fl * (hi - lo) + lo).astype(np.float32)


# XLA's single-precision erf_inv (M. Giles, "Approximating the erfinv
# function"): a degree-8 polynomial in w = -log1p(-x^2), one set of
# coefficients below w = 5 and one above
_ERF_INV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                -4.39150654e-06, 0.00021858087, -0.00125372503,
                -0.00417768164, 0.246640727, 1.50140941)
_ERF_INV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
                -0.00367342844, 0.00573950773, -0.0076224613,
                0.00943887047, 1.00167406, 2.83297682)


def _erf_inv(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, np.float32)
    w = -np.log1p(-x * x)
    lt = w < np.float32(5.0)
    w = np.where(lt, w - np.float32(2.5),
                 np.sqrt(w) - np.float32(3.0)).astype(np.float32)
    lo = np.asarray(_ERF_INV_LT5, np.float32)
    hi = np.asarray(_ERF_INV_GE5, np.float32)
    p = np.where(lt, lo[0], hi[0]).astype(np.float32)
    for i in range(1, 9):
        p = (np.where(lt, lo[i], hi[i]) + p * w).astype(np.float32)
    out = (p * x).astype(np.float32)
    return np.where(np.abs(x) == 1, x * np.float32(np.finfo(np.float32).max),
                    out).astype(np.float32)


def _normal(key, shape) -> np.ndarray:
    """``jax.random.normal`` in float32: sqrt(2) erf_inv(u), u uniform on
    (-1, 1)."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0), dtype=np.float32)
    u = _uniform(key, shape, float(lo), 1.0)
    return (np.float32(np.sqrt(2)) * _erf_inv(u)).astype(np.float32)


def _rademacher(key, shape) -> np.ndarray:
    """``jax.random.rademacher``: 2 * (uniform < 0.5) - 1, as int32."""
    return (2 * (_uniform(key, shape) < np.float32(0.5)).astype(np.int32)
            - 1).astype(np.int32)


# ---------------------------------------------------------------------------
# the encoder
# ---------------------------------------------------------------------------


class MuveraEncoder:
    """Fixed-dimensional encoding of a token-vector set (MUVERA).

    fde_dim = repetitions * 2^ksim * dproj. Doc and query encodings differ
    as in the paper: documents average and fill empty buckets, queries sum.
    """

    def __init__(self, dims: int, ksim: int = 4, dproj: int = 16,
                 repetitions: int = 10):
        self.dims = dims
        self.ksim = ksim
        self.dproj = min(dproj, dims)
        self.repetitions = repetitions
        self.buckets = 1 << ksim
        kg, kp = _split(_prng_key(MUVERA_SEED))
        self.gaussians = _normal(kg, (repetitions, ksim, dims))
        self.proj = _rademacher(kp, (repetitions, dims, self.dproj)).astype(
            np.float32) / np.sqrt(self.dproj)
        self.fde_dim = repetitions * self.buckets * self.dproj
        self._bit_weights = (1 << np.arange(ksim)).astype(np.int32)
        # the popcount of every bucket index (the hamming fill)
        self._popcount = np.asarray(
            [bin(i).count("1") for i in range(self.buckets)], np.int32)

    def _bucket_ids(self, tokens: np.ndarray) -> np.ndarray:
        """[R, T] bucket ids from sign bits of the gaussian projections."""
        dots = np.einsum("rkd,td->rkt", self.gaussians, tokens)
        bits = (dots < 0).astype(np.int32)
        return np.einsum("rkt,k->rt", bits, self._bit_weights)

    def _encode(self, token_sets: list, doc: bool) -> np.ndarray:
        """FDEs of a batch of token sets, [n, fde_dim] float64: the JAX
        encoder's values, computed for the whole batch at once.

        - The bucket ids: one einsum over every set's tokens (each dot
          product as the JAX encoder sums it).
        - The per-bucket sums add each bucket's tokens in token order, as
          ``np.add.at`` does: the entries are grouped by their rank inside
          their bucket, and rank j's tokens are added to their (distinct)
          buckets in one vectorized step, j = 0, 1, ...
        - The hamming fill (documents) looks the popcount of each bucket
          index up in a table.
        - The +-1 projection is a float64 matmul a repetition (the JAX
          encoder's einsum promotes to float64 too).
        """
        sets = [np.atleast_2d(np.asarray(t, np.float32)) for t in token_sets]
        n = len(sets)
        r_, b_, d = self.repetitions, self.buckets, self.dims
        lens = np.asarray([len(t) for t in sets], np.int64)
        offs = np.concatenate([[0], np.cumsum(lens)])
        cat = np.concatenate(sets)
        ids = self._bucket_ids(cat)                           # [R, sum T]
        doc_of = np.repeat(np.arange(n), lens)
        slot = ((doc_of * r_)[None, :] + np.arange(r_)[:, None]) * b_ + ids
        flat = slot.reshape(-1)
        src = np.tile(np.arange(len(cat)), r_)
        order = np.argsort(flat, kind="stable")
        fs = flat[order]
        counts = np.bincount(flat, minlength=n * r_ * b_)
        starts = np.cumsum(counts) - counts
        rank = np.arange(len(fs)) - starts[fs]
        by_rank = np.argsort(rank, kind="stable")
        out = np.zeros((n * r_ * b_, d), np.float32)
        pos = 0
        for c in np.bincount(rank):
            sel = by_rank[pos:pos + c]
            pos += c
            out[fs[sel]] += cat[src[order[sel]]]
        if doc:
            nz = counts > 0
            out[nz] /= counts[nz].astype(np.float32)[:, None]
            for e in np.flatnonzero(~nz.reshape(n, -1).all(axis=1)):
                empty = np.flatnonzero(~nz.reshape(n, r_, b_)[e].reshape(-1))
                er, eb = empty // b_, empty % b_
                di = ids[:, offs[e]:offs[e + 1]]                  # [R, T]
                ham = self._popcount[eb[:, None] ^ di[er]]        # [E, T]
                out[e * r_ * b_ + empty] = cat[offs[e] + np.argmin(ham, 1)]
        out = out.reshape(n, r_, b_, d).transpose(1, 0, 2, 3).reshape(
            r_, n * b_, d)
        proj = np.matmul(out.astype(np.float64), self.proj)      # [R, nB, P]
        return proj.reshape(r_, n, b_, self.dproj).transpose(
            1, 0, 2, 3).reshape(n, -1)

    def encode_doc(self, tokens: np.ndarray) -> np.ndarray:
        """[T, D] -> [fde_dim]. Per bucket: MEAN of assigned tokens; empty
        buckets take the hamming-nearest token (MUVERA fill)."""
        return self._encode([tokens], doc=True)[0]

    def encode_docs(self, token_sets: list) -> np.ndarray:
        """``encode_doc`` of each set, [n, fde_dim], in one batch."""
        return self._encode(token_sets, doc=True)

    def encode_query(self, tokens: np.ndarray) -> np.ndarray:
        """[Tq, D] -> [fde_dim]. SUM per bucket, no fill (paper asymmetry)."""
        return self._encode([tokens], doc=False)[0]


def maxsim_scores(query: np.ndarray, cand_tokens: np.ndarray,
                  cand_mask: np.ndarray, mesh=None) -> np.ndarray:
    """Exact late interaction (Chamfer/MaxSim) on the host: query [Tq, D];
    cand_tokens [C, Tmax, D] zero-padded; cand_mask [C, Tmax] -> [C] scores
    = sum over query tokens of the max over document tokens of the dot
    product (``batched_maxsim_host`` of one query). The mesh form
    (candidates sharded across cards) comes with slice 11."""
    if mesh is not None:
        raise NotImplementedError(
            "mesh-sharded MaxSim: not ported yet (ROADMAP queue A, slice 11)")
    from weaviate_tpu_torch.modules.device.maxsim import batched_maxsim_host

    q = np.asarray(query, np.float32)
    return batched_maxsim_host(
        q[None], np.ones((1, q.shape[0]), bool),
        np.asarray(cand_tokens, np.float32)[None],
        np.asarray(cand_mask, bool)[None])[0]


class MultiVectorIndex(VectorIndex):
    """FDE candidate index + token store + exact MaxSim rerank tier."""

    multi_vector = True

    def __init__(self, dims: int,
                 config: Optional[MultiVectorIndexConfig] = None,
                 device=None):
        self.config = config or MultiVectorIndexConfig()
        self.dims = dims
        self.metric = "dot"  # FDE similarity is inner product
        self.encoder = MuveraEncoder(
            dims, ksim=self.config.ksim, dproj=self.config.dproj,
            repetitions=self.config.repetitions)
        inner_cfg = FlatIndexConfig(
            distance="dot",
            initial_capacity=self.config.initial_capacity,
            precision=self.config.precision,
            flat_approx_recall=self.config.flat_approx_recall,
        )
        self.inner = FlatIndex(self.encoder.fde_dim, inner_cfg, device=device)
        self.device = self.inner.store.device
        # the rerank tier: the exact MaxSim rescore IS a rerank module
        # here, after the FDE scan on the card (fused_flat_rerank);
        # config.rerank swaps the module. The token store's host planes are
        # the one host copy of the token sets (the warm tier and the
        # checkpoint read them).
        from weaviate_tpu_torch.modules.device import (
            CandidateTokenStore,
            build_device_reranker,
        )

        rr_cfg = getattr(self.config, "rerank", None)
        self._rerank_explicit = rr_cfg is not None and rr_cfg.enabled
        if self._rerank_explicit:
            self._rerank_module = build_device_reranker(
                rr_cfg.module, rr_cfg.params)
            tmax = rr_cfg.max_tokens
        else:
            self._rerank_module = build_device_reranker("rerank-maxsim")
            tmax = 8
        self._token_store = CandidateTokenStore(
            dims, max_tokens=tmax, cap_fn=lambda: self.inner.store.capacity,
            initial_capacity=self.config.initial_capacity,
            device=self.device)

    # -- writes -------------------------------------------------------------
    def add_batch_multi(self, doc_ids: np.ndarray,
                        token_sets: list[np.ndarray]) -> None:
        if len(doc_ids) == 0:
            return
        token_sets = [np.atleast_2d(np.asarray(t, np.float32))
                      for t in token_sets]
        # tokens BEFORE the candidate index: a racing search that sees the
        # new id in the FDE corpus must find its rerank tokens
        self._token_store.put(np.asarray(doc_ids, np.int64), token_sets)
        self.inner.add_batch(np.asarray(doc_ids, np.int64),
                             self.encoder.encode_docs(token_sets))

    def _host_token_set(self, doc_id: int) -> Optional[np.ndarray]:
        """The exact (unpadded) token set of one doc from the host planes,
        or None when absent or deleted."""
        toks, mask = self._token_store.host_planes()
        if doc_id >= toks.shape[0]:
            return None
        m = mask[doc_id]
        if not m.any():
            return None
        return toks[doc_id][m]

    def add_batch(self, doc_ids: np.ndarray, vectors: np.ndarray) -> None:
        """Single-vector adds are degenerate token sets of size 1."""
        self.add_batch_multi(doc_ids, [v[None, :] if v.ndim == 1 else v
                                       for v in vectors])

    def delete(self, doc_ids: np.ndarray) -> None:
        self.inner.delete(doc_ids)
        self._token_store.delete(np.asarray(doc_ids).reshape(-1))

    # -- search ---------------------------------------------------------------
    def search_multi(self, query_tokens: np.ndarray, k: int,
                     allow_list: Optional[np.ndarray] = None) -> SearchResult:
        """query_tokens [Tq, D] -> top-k by the rerank module (exact MaxSim
        by default) over the FDE candidates (``rescore_limit`` wide, or
        4k). A store on its device runs the scan and the rerank stage
        there (B7a on the card); a demoted one serves from the host
        planes."""
        query_tokens = np.atleast_2d(np.asarray(query_tokens, np.float32))
        if query_tokens.shape[-1] != self.dims:
            raise ValueError(
                f"query token dims {query_tokens.shape[-1]} != {self.dims}")
        fde = self.encoder.encode_query(query_tokens)[None, :]
        cand_k = max(k, self.config.rescore_limit or 4 * k)
        cand_k = min(cand_k, max(1, self.inner.count()))
        if self.inner.store.device_resident:
            return self._search_multi_fused(query_tokens, fde, cand_k, k,
                                            allow_list)
        if self._rerank_explicit:
            from weaviate_tpu_torch.monitoring.metrics import RERANK_FALLBACK

            RERANK_FALLBACK.inc(module=self._rerank_module.name,
                                reason="warm_tier")
        res = self.inner.search(fde, cand_k, allow_list)
        cand = res.ids[0]
        cand = cand[cand >= 0]
        if len(cand) == 0:
            return SearchResult(ids=np.full((1, k), -1, np.int64),
                                dists=np.full((1, k), np.inf, np.float32))
        # a candidate may have been deleted between the FDE search and here
        sets = []
        kept = []
        for d in cand:
            t = self._host_token_set(int(d))
            if t is not None:
                sets.append(t)
                kept.append(int(d))
        cand = np.asarray(kept, np.int64)
        if len(cand) == 0:
            return SearchResult(ids=np.full((1, k), -1, np.int64),
                                dists=np.full((1, k), np.inf, np.float32))
        tmax = max(s.shape[0] for s in sets)
        toks = np.zeros((len(sets), tmax, self.dims), np.float32)
        mask = np.zeros((len(sets), tmax), bool)
        for i, s in enumerate(sets):
            toks[i, : s.shape[0]] = s
            mask[i, : s.shape[0]] = True
        qm = np.ones((1, query_tokens.shape[0]), bool)
        scores = self._rerank_module.host_score(
            query_tokens[None], qm, toks[None], mask[None])[0]
        order = np.argsort(-scores, kind="stable")[:k]
        ids = np.full((1, k), -1, np.int64)
        d = np.full((1, k), np.inf, np.float32)
        ids[0, : len(order)] = cand[order]
        # presented as a distance: negated MaxSim (lower = better)
        d[0, : len(order)] = -scores[order]
        return SearchResult(ids=ids, dists=d)

    def _search_multi_fused(self, query_tokens: np.ndarray,
                            fde: np.ndarray, cand_k: int, k: int,
                            allow_list: Optional[np.ndarray]
                            ) -> SearchResult:
        """The FDE scan, then the rerank stage over its candidates
        (``ops/device_beam.fused_flat_rerank``); on the card the candidate
        ids stay there and the stage is one B7a launch. A failed launch
        raises."""
        from weaviate_tpu_torch.monitoring import tracing
        from weaviate_tpu_torch.monitoring.metrics import (
            RERANK_CANDIDATES,
            RERANK_REQUESTS,
        )
        from weaviate_tpu_torch.ops.device_beam import fused_flat_rerank

        name = self._rerank_module.name
        corpus, valid, _sqnorms = self.inner.store.snapshot()
        cap = int(corpus.shape[0])
        toks, tmask = self._token_store.sync(min_rows=cap)
        tq = query_tokens.shape[0]
        tq_pad = 1 << max(0, (tq - 1).bit_length())
        qt = np.zeros((1, tq_pad, self.dims), np.float32)
        qt[0, :tq] = query_tokens
        qm = np.zeros((1, tq_pad), bool)
        qm[0, :tq] = True
        allow = None
        if allow_list is not None:
            al = np.asarray(allow_list, bool)
            if len(al) < cap:
                al = np.pad(al, (0, cap - len(al)))
            allow = al[:cap]
        # power-of-two widths, as the JAX index buckets its programs
        fetch = 1 << max(3, (int(cand_k) - 1).bit_length())
        out_k = min(1 << max(3, (int(k) - 1).bit_length()), fetch)
        ids_t, d_t = fused_flat_rerank(
            self._rerank_module, fde.astype(np.float32), corpus, valid, qt,
            qm, toks, tmask, fetch=fetch, k=out_k, allow=allow, metric="dot",
            precision=self.config.precision)
        ids = ids_t.cpu().numpy()[0].astype(np.int64)
        d = d_t.cpu().numpy()[0].astype(np.float32)
        RERANK_REQUESTS.inc(module=name, tier="fused")
        RERANK_CANDIDATES.observe(float(fetch), module=name)
        tracing.add_event("rerank.score", module=name,
                          candidates=int(fetch), rows=1)
        out_ids = np.full((1, k), -1, np.int64)
        out_d = np.full((1, k), np.inf, np.float32)
        n_out = min(k, len(ids))
        out_ids[0, :n_out] = ids[:n_out]
        out_d[0, :n_out] = d[:n_out]
        out_ids[0][~np.isfinite(out_d[0])] = -1
        return SearchResult(ids=out_ids, dists=out_d)

    def search(self, queries: np.ndarray, k: int,
               allow_list: Optional[np.ndarray] = None,
               est_selectivity: Optional[float] = None) -> SearchResult:
        """[B, D] single-vector queries (each a 1-token set), each through
        ``search_multi``. ``est_selectivity`` is accepted for signature
        parity."""
        queries = np.atleast_2d(np.asarray(queries, np.float32))
        outs = [self.search_multi(q[None, :], k, allow_list) for q in queries]
        return SearchResult(
            ids=np.concatenate([o.ids for o in outs]),
            dists=np.concatenate([o.dists for o in outs]),
        )

    def search_by_distance(self, queries, max_distance, allow_list=None,
                           limit: int = 1024):
        res = self.search(queries, min(limit, max(1, self.count())),
                          allow_list)
        keep = res.dists <= max_distance
        return SearchResult(ids=np.where(keep, res.ids, -1),
                            dists=np.where(keep, res.dists, np.inf))

    # -- checkpoint (the JAX index's files) ---------------------------------
    def save_vectors(self, path: str, meta: Optional[dict] = None) -> bool:
        """The FDE corpus through the inner store and one token file
        (``<path>.tokens``, msgpack) from the token store's host planes."""
        import msgpack

        self.inner.store.save(path, meta)
        toks, mask = self._token_store.host_planes()
        live = np.flatnonzero(mask.any(axis=1))
        tmp = path + ".tokens.tmp"
        with open(tmp, "wb") as f:
            f.write(msgpack.packb({
                "version": 1,
                "docs": [
                    {"d": int(d),
                     "shape": [int(mask[d].sum()), self.dims],
                     "data": toks[d][mask[d]].tobytes()}
                    for d in live
                ],
            }, use_bin_type=True))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path + ".tokens")
        return True

    def load_vectors(self, path: str) -> Optional[dict]:
        import msgpack

        meta = self.inner.store.load(path)
        if meta is None:
            return None
        tok_path = path + ".tokens"
        if not os.path.exists(tok_path):
            return None  # half a checkpoint is no checkpoint
        try:
            with open(tok_path, "rb") as f:
                d = msgpack.unpackb(f.read(), raw=False)
            if d.get("version") != 1:
                return None
            ids = [rec["d"] for rec in d["docs"]]
            sets = [
                np.frombuffer(rec["data"], np.float32)
                .reshape(rec["shape"]).copy()
                for rec in d["docs"]
            ]
        except (OSError, ValueError, KeyError, TypeError, AttributeError):
            # a torn or corrupt token file: rebuild from the objects
            return None
        if ids:
            self._token_store.put(np.asarray(ids, np.int64), sets)
        return meta

    # -- bookkeeping ---------------------------------------------------------
    def count(self) -> int:
        return self.inner.count()

    @property
    def capacity(self) -> int:
        return self.inner.capacity

    def contains(self, doc_id: int) -> bool:
        return self.inner.contains(doc_id)

    # -- tiered residency: the FDE corpus is the inner FlatIndex, whose warm
    # tier serves demoted searches exactly; the token planes follow it
    @property
    def device_resident(self) -> bool:
        return self.inner.device_resident

    def hbm_bytes(self) -> int:
        return self.inner.hbm_bytes() + self._token_store.nbytes

    def host_tier_bytes(self) -> int:
        return self.inner.host_tier_bytes() + self._token_store.host_bytes

    def demote_device(self) -> int:
        return self.inner.demote_device() + self._token_store.drop_device()

    def promote_device(self) -> int:
        gained = self.inner.promote_device()
        if gained:
            toks, tmask = self._token_store.sync()
            gained += sum(a.numel() * a.element_size() for a in (toks, tmask))
        return gained

    def stats(self) -> dict:
        return {
            "type": "multivector",
            "count": self.count(),
            "fde_dim": self.encoder.fde_dim,
            "token_dims": self.dims,
            "rerank_module": self._rerank_module.name,
            "rerank_hbm_bytes": self._token_store.nbytes,
        }
