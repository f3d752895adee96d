"""State carried across from the JAX package.

There are no weights: the state is the vector store. A checkpoint file is
read by either package (``DeviceVectorStore.save``/``load`` share one
format); ``store_from_numpy`` builds a port store from the JAX store's
arrays handed over as numpy, so one state can feed both packages.
"""

from __future__ import annotations

import numpy as np
import torch

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
