"""Inverted-index factory (port of ``make_inverted_index`` from
``weaviate_tpu/inverted/segmented.py``).

The port has the RAM-columnar ``InvertedIndex`` only. The segment-resident
``SegmentedInvertedIndex`` (``storage="segment"``, and the upgrade that
``storage="auto"`` makes past its cutoff) comes with ROADMAP queue A
slice 6b; until then asking for it raises ``NotImplementedError``, and so
does a shard whose snapshot says it reached the segment tier.
"""

from __future__ import annotations

from weaviate_tpu_torch.inverted.index import InvertedIndex
from weaviate_tpu_torch.schema.config import CollectionConfig

_UNPORTED = ("segment-resident inverted index (SegmentedInvertedIndex, "
             "inverted storage 'segment' and 'auto'): not ported yet "
             "(ROADMAP queue A, slice 6b)")


def make_inverted_index(config: CollectionConfig, store=None,
                        snapshot_path=None):
    """Factory: RAM-columnar vs segment-resident, per collection config.

    ``storage="auto"`` starts RAM and upgrades at runtime in the JAX
    package; the port cannot upgrade, so it refuses "auto" up front
    rather than failing in a background migration later. A snapshot
    header that says ``segmented`` means the shard was written by a JAX
    package that had upgraded it."""
    storage = getattr(config.inverted_config, "storage", "ram")
    if store is None:
        return InvertedIndex(config, store)
    if storage in ("segment", "auto"):
        raise NotImplementedError(_UNPORTED)
    if snapshot_path is not None:
        from weaviate_tpu_torch.inverted.snapshot import read_header

        hdr = read_header(snapshot_path)
        if hdr is not None and hdr.get("mode") == "segmented":
            raise NotImplementedError(_UNPORTED)
    return InvertedIndex(config, store)
