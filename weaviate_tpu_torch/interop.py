"""State carried across from the JAX package.

There are no weights: the state is the database on disk. For a database
this is how state crosses: a ``DB`` directory written by either package
opens in the other (``DB(root, device=...)`` here, the JAX package's
``DB(root)`` there) and answers the same searches. Every file in it is
JSON, msgpack or raw little-endian bytes in one shared format, never a
pickle: ``schema.json``; per shard the LSM store (WAL records and segments,
``storage/``), the delta log, ``counter.bin`` and ``meta.bin``, the
inverted snapshot (``inverted/snapshot.py``) and one vector checkpoint a
target (``DeviceVectorStore.save``/``load``). A shard opened from a clean
close loads the snapshot and checkpoints; one opened after a crash
replays its delta log past them; a checkpoint whose ``seq`` does not match
is rebuilt from the object store. ``tests/test_torch_db.py`` holds this in
both directions.

Below the database, a vector checkpoint file alone is read by either
package, and ``store_from_numpy`` builds a port store from the JAX store's
arrays handed over as numpy, so one state can feed both packages.

Quantized state crosses the same way. A quantized HNSW index's directory
(``graph.npz`` and ``quantizer.msgpack``, the quantizer's ``state_dict``)
opens in either package; its codes are rebuilt from the objects.
``quantizer_from_state`` turns a JAX quantizer's ``state_dict()`` (BQ, SQ,
PQ's codebooks, RQ's rotation) into the port's quantizer, and ``array_set_from_numpy`` builds a port
``DeviceArraySet`` from a JAX set's code planes, valid mask, watermark and
live count as numpy.

The rerank tier and the multivector index (slice 7a) cross the same way.
An HNSW target with a rerank module checkpoints its token planes beside its
vector checkpoint (``<path>.rrtok.npz``: ``tokens`` [cap, T, D] float32 and
``mask`` [cap, T]); a multivector target checkpoints its FDE corpus as a
vector checkpoint and its token sets in ``<path>.tokens`` (msgpack, one
record a live document). The rerank module's name and parameters live in
``schema.json`` (``RerankModuleConfig``). ``MuveraEncoder``'s random
matrices are not carried: the port draws the same ones from the same seed
(``index/multivector.py``). ``token_store_from_numpy`` builds a port token
store from a JAX store's ``host_planes()``.

An HFresh target (slice 7b) checkpoints its centroids and postings in the
``hfresh`` entry of its vector checkpoint's meta (float32 and int64 bytes)
and opens in either package; ``hfresh_from_numpy`` builds a port
``HFreshIndex`` from a JAX index's centroids, postings and store arrays.
The segment-resident inverted tier is the shard's bucket files and its
snapshot header: it crosses by opening the directory.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from weaviate_tpu_torch.compression import DeviceArraySet, Quantizer
from weaviate_tpu_torch.compression.store import to_tensor
from weaviate_tpu_torch.index.store import _PAGE, DeviceVectorStore


def _corpus_tensor(corpus: np.ndarray) -> torch.Tensor:
    """A CPU tensor of ``corpus``, bfloat16 arrays (numpy's ``bfloat16``
    extension dtype, two bytes a value) included."""
    if corpus.dtype.name == "bfloat16":
        raw = np.ascontiguousarray(corpus).view(np.int16)
        return torch.from_numpy(raw.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(corpus, copy=True))


def store_from_numpy(corpus: np.ndarray, valid: np.ndarray,
                     sqnorms: np.ndarray, watermark: int, live: int,
                     normalized: bool, device=None) -> DeviceVectorStore:
    """A port store holding exactly the given state: ``corpus`` [cap, D],
    ``valid`` [cap] bool and ``sqnorms`` [cap] float32 (a JAX store's
    ``snapshot()`` as numpy), with its ``watermark`` and ``live`` count.
    ``cap`` must be a page multiple, as every store's capacity is."""
    cap, dims = corpus.shape
    if cap % _PAGE or valid.shape != (cap,) or sqnorms.shape != (cap,):
        raise ValueError(
            f"expected corpus [k*{_PAGE}, D] with valid/sqnorms [cap], got "
            f"{corpus.shape}, {valid.shape}, {sqnorms.shape}")
    c = _corpus_tensor(corpus)
    store = DeviceVectorStore(dims, capacity=cap, dtype=c.dtype,
                              normalized=normalized, device=device)
    dev = store.device
    store._state = (
        c.to(dev),
        torch.from_numpy(np.asarray(valid, bool).copy()).to(dev),
        torch.from_numpy(np.asarray(sqnorms, np.float32).copy()).to(dev),
    )
    store._host_valid = np.asarray(valid, bool).copy()
    store._watermark = int(watermark)
    store._live = int(live)
    return store


def quantizer_from_state(state: dict, config=None,
                         device=None) -> Quantizer:
    """The port's quantizer holding a quantizer's ``state_dict()`` (the
    JAX package's or the port's: kind, dims, metric, fitted and the
    quantizer's own fields: SQ's offset and step, PQ's segments, centroid
    count and codebooks, RQ's bits, padded width and rotation).
    ``config`` is its ``QuantizerConfig`` (defaults of the kind when None);
    ``device`` is where a product quantizer encodes (the card unless
    named)."""
    from weaviate_tpu_torch.compression import build_quantizer
    from weaviate_tpu_torch.schema.config import quantizer_from_dict

    cfg = config or quantizer_from_dict(
        {"kind": state["kind"], "enabled": True})
    if cfg is None:
        raise ValueError(f"unknown quantizer kind {state.get('kind')!r}")
    q = build_quantizer(cfg, int(state["dims"]), state["metric"],
                        device=device)
    q.load_state_dict(state)
    return q


def array_set_from_numpy(fields: dict, planes: dict, valid: np.ndarray,
                         watermark: int, live: int,
                         device: Optional[str] = None) -> DeviceArraySet:
    """A port ``DeviceArraySet`` holding exactly the given state: ``planes``
    name -> [cap, ...] numpy arrays in the ``fields`` dtypes (a JAX set's
    ``snapshot()`` planes as numpy), ``valid`` [cap] bool, its
    ``watermark`` and ``live`` count. ``cap`` must be a page multiple."""
    cap = valid.shape[0]
    if cap % _PAGE or set(planes) != set(fields) or any(
            p.shape[0] != cap for p in planes.values()):
        raise ValueError(
            f"expected planes {sorted(fields)} of [k*{_PAGE}, ...] rows "
            f"with valid [cap], got {sorted(planes)}, {valid.shape}")
    out = DeviceArraySet(fields, capacity=cap, device=device)
    out._state = ({name: to_tensor(planes[name], fields[name][1]).to(
                       out.device) for name in fields},
                  torch.from_numpy(np.asarray(valid, bool).copy()).to(
                      out.device))
    out._host_valid = np.asarray(valid, bool).copy()
    out._watermark = int(watermark)
    out._live = int(live)
    return out


def token_store_from_numpy(tokens: np.ndarray, mask: np.ndarray,
                           device=None):
    """A port ``CandidateTokenStore`` holding exactly the given planes:
    ``tokens`` [cap, T, D] float32 and ``mask`` [cap, T] bool (a JAX
    store's ``host_planes()``); T must be a power of two, as every store's
    is."""
    from weaviate_tpu_torch.modules.device import CandidateTokenStore

    cap, t, d = tokens.shape
    if mask.shape != (cap, t) or t & (t - 1):
        raise ValueError(f"expected tokens [cap, 2^j, D] and mask [cap, "
                         f"2^j], got {tokens.shape}, {mask.shape}")
    store = CandidateTokenStore(d, max_tokens=t, initial_capacity=cap,
                                device=device)
    store._tokens = np.array(tokens, np.float32, copy=True)
    store._mask = np.array(mask, bool, copy=True)
    return store


def hfresh_from_numpy(centroids: np.ndarray, postings: list,
                      corpus: np.ndarray, valid: np.ndarray, config=None,
                      device=None):
    """A port ``HFreshIndex`` holding exactly the given state: ``centroids``
    [C, D] float32, ``postings`` C int64 arrays of doc ids, and the store's
    ``corpus`` [cap, D] and ``valid`` [cap] (a JAX index's ``_centroids``,
    ``_postings`` and ``store.snapshot()`` as numpy); ``config`` its
    ``HFreshIndexConfig``. The store's squared norms are recomputed, its
    live count is the valid rows' and its watermark the last valid row's
    plus one."""
    from weaviate_tpu_torch.index.hfresh import HFreshIndex
    from weaviate_tpu_torch.schema.config import HFreshIndexConfig

    config = config or HFreshIndexConfig()
    corpus = np.asarray(corpus, np.float32)
    valid = np.asarray(valid, bool)
    cap, dims = corpus.shape
    live = np.flatnonzero(valid)
    idx = HFreshIndex(dims, config, device=device)
    idx.store = store_from_numpy(
        corpus, valid, (corpus * corpus).sum(1, dtype=np.float32),
        int(live[-1]) + 1 if len(live) else 0, len(live),
        config.distance == "cosine", device=device)
    idx._centroids = np.array(centroids, np.float32, copy=True).reshape(
        -1, dims)
    idx._postings = [np.array(p, np.int64, copy=True) for p in postings]
    idx._version += 1
    if len(idx._postings) != len(idx._centroids):
        raise ValueError(f"{len(idx._postings)} postings for "
                         f"{len(idx._centroids)} centroids")
    idx._doc_posting = {int(d): row for row, ids in enumerate(idx._postings)
                        for d in ids}
    return idx
