"""Segment-resident inverted index: filters + postings served from LSM buckets
(port of ``weaviate_tpu/inverted/segmented.py``; host code, the bucket
layouts the JAX package's, so either package opens the other's shard).

Reference: ``adapters/repos/db/inverted/searcher.go`` answers filters by
reading roaring bitmaps straight out of LSM segments (``lsmkv/roaringset/``,
``roaringsetrange/``) and BM25 by streaming postings blocks from the
``inverted`` strategy (``lsmkv/strategies.go:21-27``) — a shard's filterable
state never has to fit in RAM. The RAM-columnar engine (``columnar.py``)
remains the default for small shards; this class is the scale tier, selected
with ``InvertedIndexConfig(storage="segment")``.

What stays in RAM (all bounded or doc-bit-sized):
- the live bitmap + watermark (1 bit/doc — 1.25 MB per 10M docs)
- geo columns (geo props are rare and small; haversine wants raw coords)
- per-prop aggregate length totals for avgdl (two ints per text prop)
- bucket memtables (capped at ``memtable_max_entries`` each) and segment
  sparse indexes/bloom filters (O(keys/SPARSE))

Everything else lives in buckets under the shard's LSM store:
- ``inv_<prop>``   (roaringset)      value-token -> doc bitmap, plus
                                     presence/multi rows for IsNull/NotEqual
- ``range_<prop>`` (roaringsetrange) bit-sliced index for scalar numerics
- ``post_<prop>``  (inverted)        term -> (docid -> tf, doclen) postings
- ``propvals``     (replace)         docid -> filterable values (the value
                                     store for aggregations/ref-filters and
                                     for docid-only crash-replay deletes)

Query results are bit-for-bit identical to the RAM path (shared test matrix
in ``tests/test_segmented_inverted.py`` asserts it).
"""

from __future__ import annotations

import math
import struct
from collections import defaultdict
from contextlib import contextmanager
from typing import Any, Iterator, Optional

import msgpack
import numpy as np

from weaviate_tpu_torch.inverted.analyzer import term_frequencies, tokenize
from weaviate_tpu_torch.inverted.filters import Filter
from weaviate_tpu_torch.inverted.index import InvertedIndex
from weaviate_tpu_torch.schema.config import CollectionConfig, DataType
from weaviate_tpu_torch.storage.bitmaps import RangeBucket, RangeBitmap

_DOCID = struct.Struct(">q")

# key layout inside an inv_<prop> roaringset bucket: meta rows sort first
# (\x00 prefix), then numeric tokens (order-preserving big-endian), then
# text/bool tokens
_K_PRESENT = b"\x00p"
_K_MULTI = b"\x00m"
_K_SKETCHES = b"sketches"  # sole row of the sketch_meta bucket
_NUM_PREFIX = b"n"
_TOK_PREFIX = b"t"

_SCALAR_NUM = (DataType.INT, DataType.NUMBER)


def _num_key(value: float) -> bytes:
    """Order-preserving numeric token: big-endian of the float64 sign-fold
    encoding, so byte order == numeric order for vocabulary range scans."""
    return _NUM_PREFIX + struct.pack(">Q", RangeBitmap.encode(float(value)))


def _num_from_key(key: bytes) -> int:
    return struct.unpack(">Q", key[1:])[0]


def _tok_key(value) -> Optional[bytes]:
    if isinstance(value, bool):
        return _TOK_PREFIX + (b"\x01" if value else b"\x00")
    if isinstance(value, str):
        return _TOK_PREFIX + value.encode("utf-8")
    return None


class _PropValuesView:
    """Read-only mapping view of one property's values, backed by the
    ``propvals`` bucket — dict-compatible surface for the aggregation and
    ref-filter consumers (``collection.py``)."""

    def __init__(self, inv: "SegmentedInvertedIndex", prop: str):
        self._inv = inv
        self._prop = prop

    def get(self, doc_id: int, default=None):
        rec = self._inv._propvals_get(doc_id)
        if rec is None:
            return default
        return rec.get("v", {}).get(self._prop, default)

    def __getitem__(self, doc_id: int):
        v = self.get(doc_id)
        if v is None:
            raise KeyError(doc_id)
        return v

    def items(self) -> Iterator[tuple[int, Any]]:
        prop = self._prop
        for key, raw in self._inv.propvals.items():
            if raw is None:
                continue
            rec = msgpack.unpackb(raw, raw=False, strict_map_key=False)
            v = rec.get("v", {}).get(prop)
            if v is not None:
                yield _DOCID.unpack(key)[0], v

    def values(self) -> Iterator[Any]:
        for _, v in self.items():
            yield v

    def keys(self) -> Iterator[int]:
        for d, _ in self.items():
            yield d

    def __iter__(self):
        return self.keys()

    def __len__(self) -> int:
        return sum(1 for _ in self.items())

    def __bool__(self) -> bool:
        for _ in self.items():
            return True
        return False


class _ValuesFacade:
    """prop -> _PropValuesView, mimicking the RAM index's ``values`` dict."""

    def __init__(self, inv: "SegmentedInvertedIndex"):
        self._inv = inv

    def get(self, prop: str, default=None) -> _PropValuesView:
        return _PropValuesView(self._inv, prop)

    def __getitem__(self, prop: str) -> _PropValuesView:
        return _PropValuesView(self._inv, prop)

    def keys(self):
        return [p.name for p in self._inv.config.properties
                if self._inv._filterable(p.name)]


class SegmentedInvertedIndex(InvertedIndex):
    """LSM-bucket-resident drop-in for ``InvertedIndex`` (see module doc)."""

    segmented = True

    def __init__(self, config: CollectionConfig, store=None):
        if store is None:
            raise ValueError("segmented inverted index requires an LSM store")
        super().__init__(config, store)
        # The inherited native engine (if it loaded) becomes a BOUNDED
        # term cache over the postings buckets: query terms stream in from
        # segments on first use, BlockMax-WAND serves repeats, and an LRU
        # byte budget + write invalidation keep residency bounded — the
        # reference's blockmax-over-StrategyInverted architecture
        # (bm25_searcher_block.go), RAM demoted to a bounded cache.
        # WEAVIATE_TPU_WAND_CACHE_MB=0 disables it
        # (pure dense streaming).
        import os as _os

        self._wand = self.native
        self.native = None  # the base-class write path must not feed it
        # fleet-tunable budget: runtime override wins over env over 64 MB
        from weaviate_tpu_torch.utils.runtime_config import WAND_CACHE_MB

        mb = WAND_CACHE_MB.get()
        if mb < 0:
            mb = float(_os.environ.get("WEAVIATE_TPU_WAND_CACHE_MB", "64"))
        self._wand_budget = int(mb * (1 << 20))
        if self._wand_budget <= 0:
            self._wand = None
        # (prop, term) -> (approx bytes, df at load), LRU order. _wand_lock
        # guards the dict AND every native-engine mutation/search as one
        # critical section: cache bookkeeping must be atomic with the C++
        # list state (a load registered after a racing invalidation would
        # pin a stale list forever), and a query's terms must survive
        # until ITS search runs. The native engine serializes all C calls
        # on its own lock anyway, so this adds no real concurrency loss.
        from collections import OrderedDict as _OD
        import threading as _threading

        self._wand_terms: "_OD[tuple[str, str], tuple[int, int]]" = _OD()
        self._wand_bytes = 0
        self._wand_lock = _threading.RLock()
        self.values = _ValuesFacade(self)
        self.propvals = store.bucket("propvals", "replace")
        # selectivity sketches persist as segment metadata: one row,
        # rewritten at every batched-writes flush (the segment-flush
        # moment for every other bucket family). The shard snapshot also
        # carries them; this row covers boots that rebuild from buckets
        # without a snapshot.
        self._sketch_bk = store.bucket("sketch_meta", "replace")
        raw = self._sketch_bk.get(_K_SKETCHES)
        if raw is not None:
            try:
                from weaviate_tpu_torch.inverted.sketches import SketchRegistry

                self.sketches = SketchRegistry.from_dict(
                    msgpack.unpackb(raw, raw=False, strict_map_key=False))
            except Exception:
                # estimates only: a torn row degrades, never fails
                import logging

                logging.getLogger("weaviate_tpu_torch.inverted").warning(
                    "discarding unreadable selectivity sketches "
                    "(rebuilt from future flushes)", exc_info=True)
        self._term_bk: dict[str, Any] = {}
        self._post_bk: dict[str, Any] = {}
        # avgdl state: totals + doc counts per searchable prop (persisted in
        # the shard snapshot; reference prop-length tracker keeps the same
        # aggregates, ``inverted/tracker/``)
        self.lens_counts: dict[str, int] = defaultdict(int)
        self._pending = None  # batch accumulators inside batched_writes()
        # set by reindex before its buckets are dropped: queries racing the
        # rebuild get a clean retriable ShardClosed instead of silently
        # recreating empty buckets and returning wrong empty results
        self._closed = False
        # small LRU over propvals decodes: grouped aggregations hit the same
        # doc once per property
        self._pv_cache: dict[int, dict] = {}
        # cached live mask for the WAND allow path: materializing a
        # doc-space bool array per query costs more than the WAND search
        # itself at 1M docs — writes/deletes invalidate
        self._live_cache: Optional[tuple[int, np.ndarray]] = None

    # -- buckets -----------------------------------------------------------
    def _terms(self, prop: str):
        bk = self._term_bk.get(prop)
        if bk is None:
            bk = self._term_bk[prop] = self.store.bucket(
                f"inv_{prop}", "roaringset")
        return bk

    def _posts(self, prop: str):
        bk = self._post_bk.get(prop)
        if bk is None:
            bk = self._post_bk[prop] = self.store.bucket(
                f"post_{prop}", "inverted")
        return bk

    def _range_indexed(self, prop: str) -> bool:
        # always-on for scalar numerics in segmented mode (the RAM path
        # gates on the per-prop index_range_filters flag)
        p = self._prop_schema(prop)
        return p is not None and p.data_type in _SCALAR_NUM

    # -- bounded WAND term cache ------------------------------------------
    def _wand_ensure_locked(self, prop: str, term: str,
                            pinned: set) -> Optional[int]:
        """Load one (prop, term) posting list from its bucket into the
        native engine if absent; returns its df (None = term not indexed).
        Evicts LRU terms past the byte budget, never evicting ``pinned``
        keys (the CURRENT query's terms — WAND needs all of them resident
        at once, so the budget is soft against one query's own postings).
        MUST be called with _wand_lock held — load/register/evict have to
        be atomic against invalidation and other queries' evictions."""
        key = (prop, term)
        if key in self._wand_terms:
            # LIVE df from the engine, not the df stored at load: the
            # engine purges tombstoned docs from its lists on its compact
            # cycle, so docid-only deletes stop drifting idf away from
            # what a fresh bucket reload would compute (drift is
            # bounded by the compact cadence)
            df = self._wand.posting_len(prop, term)
            if df > 0:
                self._wand_terms.move_to_end(key)
                return df
            # list vanished underneath the cache entry — reload below
            eb, _ = self._wand_terms.pop(key)
            self._wand_bytes -= eb
        ids, tfs, dls = self._posts(prop).postings_get(term.encode("utf-8"))
        if not len(ids):
            return None
        nbytes = len(ids) * 16
        self._wand.add_term(prop, term, ids, tfs, dls)
        self._wand_terms[key] = (nbytes, len(ids))
        self._wand_bytes += nbytes
        # live fleet override applies at eviction time (hot-reload)
        from weaviate_tpu_torch.utils.runtime_config import WAND_CACHE_MB

        ov = WAND_CACHE_MB.get()
        budget = int(ov * (1 << 20)) if ov >= 0 else self._wand_budget
        victims = [k for k in self._wand_terms
                   if k not in pinned and k != key]
        for vk in victims:
            if self._wand_bytes <= budget:
                break
            eb, _df = self._wand_terms.pop(vk)
            self._wand.drop_term(*vk)
            self._wand_bytes -= eb
        return len(ids)

    def _wand_invalidate(self, prop: str, term: str) -> None:
        """A write touched this term's bucket rows: the cached native list
        is stale — drop it (next query reloads the merged view). Pop and
        drop under ONE lock hold, else a racing reload lands between them
        and the fresh list gets erased while still marked cached."""
        if self._wand is None:
            return
        key = (prop, term)
        with self._wand_lock:
            ent = self._wand_terms.pop(key, None)
            if ent is None:
                return
            self._wand_bytes -= ent[0]
            self._wand.drop_term(prop, term)

    def _check_open(self) -> None:
        if self._closed:
            from weaviate_tpu_torch.storage.store import ShardClosed

            raise ShardClosed(
                "segmented inverted index superseded by reindex; retry")

    def _propvals_get(self, doc_id: int) -> Optional[dict]:
        self._check_open()
        rec = self._pv_cache.get(doc_id)
        if rec is not None:
            return rec
        raw = self.propvals.get(_DOCID.pack(doc_id))
        if raw is None:
            return None
        rec = msgpack.unpackb(raw, raw=False, strict_map_key=False)
        if len(self._pv_cache) >= 4096:
            self._pv_cache.clear()
        self._pv_cache[doc_id] = rec
        return rec

    # -- write path --------------------------------------------------------
    @contextmanager
    def batched_writes(self):
        """Accumulate bucket mutations across a put_batch and flush them
        grouped: one roaring_add per (prop, token), one postings_put per
        (prop, term), one range put_many per prop — instead of per-object
        WAL records.

        Effects are PER-OBJECT ATOMIC: ``_add_object_pending`` stages each
        object locally and merges into the batch only on that object's
        clean completion, and the flush (which runs even when the batch
        body raises — ``Shard.put_batch`` has already durably written the
        completed objects' id/object rows, so dropping their index rows
        would leave live, id-retrievable objects invisible to search)
        applies exactly the complete objects. The object that RAISED
        contributes nothing — no counters, no bucket rows — so an aborted
        batch cannot leave index state behind for half-processed objects;
        its durable rows are healed by the delta-log
        replay on restart, like any crash between object and index
        writes."""
        if self._pending is not None:  # re-entrant: outer flush wins
            yield
            return
        self._pending = {
            "present": defaultdict(list),   # prop -> [doc_id]
            "multi": defaultdict(list),
            "tok": defaultdict(lambda: defaultdict(list)),  # prop->key->[id]
            "range": defaultdict(lambda: ([], [])),         # prop->(ids,vals)
            "post": defaultdict(lambda: defaultdict(lambda: ([], [], []))),
            "docs": [],                     # (doc_id, pv_vals, pv_lens, geo)
            "doc_count": 0,
            "len_totals": defaultdict(int),
            "lens_counts": defaultdict(int),
        }
        try:
            yield
        finally:
            pending, self._pending = self._pending, None
            for prop, ids in pending["present"].items():
                self._terms(prop).roaring_add(_K_PRESENT, ids)
            for prop, ids in pending["multi"].items():
                self._terms(prop).roaring_add(_K_MULTI, ids)
            for prop, by_key in pending["tok"].items():
                bk = self._terms(prop)
                for key, ids in by_key.items():
                    bk.roaring_add(key, ids)
            for prop, (ids, vals) in pending["range"].items():
                RangeBucket(self.store.bucket(
                    f"range_{prop}", "roaringsetrange")).put_many(ids, vals)
            for prop, by_term in pending["post"].items():
                bk = self._posts(prop)
                for term, (ids, tfs, dls) in by_term.items():
                    bk.postings_put(term.encode("utf-8"), ids, tfs, dls)
                    self._wand_invalidate(prop, term)
            # per-doc rows AFTER bucket rows: the propvals row is the
            # "doc is indexed" replay marker, so a crash between the two
            # re-applies idempotent bucket writes instead of skipping them
            for doc_id, pv_vals, pv_lens, geo_props in pending["docs"]:
                self.columnar.add(doc_id, geo_props)
                self.propvals.put(
                    _DOCID.pack(doc_id),
                    msgpack.packb({"v": pv_vals, "l": pv_lens},
                                  use_bin_type=True))
                self._pv_cache.pop(doc_id, None)
            if pending["docs"]:
                self._live_cache = None
            self.doc_count += pending["doc_count"]
            for prop, t in pending["len_totals"].items():
                self.len_totals[prop] += t
            for prop, c in pending["lens_counts"].items():
                self.lens_counts[prop] += c
            if pending["docs"]:
                # segment metadata: sketches ride every flush so a boot
                # without a snapshot still has planner statistics
                self._sketch_bk.put(
                    _K_SKETCHES,
                    msgpack.packb(self.sketches.to_dict(),
                                  use_bin_type=True))

    # keep the base-class name working for callers that only batch ranges
    batched_range_writes = batched_writes

    def add_object(self, obj) -> None:
        if self._pending is None:
            with self.batched_writes():
                self._add_object_pending(obj)
        else:
            self._add_object_pending(obj)

    def _add_object_pending(self, obj) -> None:
        # stage locally, merge on clean completion: an exception anywhere
        # in this method (bad geo dict, mixed-type list, tokenizer error)
        # must contribute NOTHING to the batch — per-object atomicity
        doc_id = obj.doc_id
        present: list[str] = []
        multi: list[str] = []
        toks: list[tuple[str, bytes]] = []
        ranges: list[tuple[str, float]] = []
        posts: list[tuple[str, str, int, int]] = []  # prop, term, tf, dl
        pv_vals: dict[str, Any] = {}
        pv_lens: dict[str, int] = {}
        geo_props: dict[str, Any] = {}
        for prop, val in obj.properties.items():
            if val is None:
                continue
            vals = val if isinstance(val, list) else [val]
            if self._filterable(prop):
                pv_vals[prop] = val
                present.append(prop)
                if len(vals) > 1:
                    multi.append(prop)
                ranged = self._range_indexed(prop) and len(vals) == 1
                geos = []
                for v in vals:
                    tok = _tok_key(v)
                    if tok is not None:
                        toks.append((prop, tok))
                    elif isinstance(v, (int, float)):
                        if ranged:
                            ranges.append((prop, float(v)))
                        else:
                            toks.append((prop, _num_key(v)))
                    elif (isinstance(v, dict) and "latitude" in v
                          and "longitude" in v):
                        geos.append(v)
                if geos:
                    geo_props[prop] = geos if len(geos) > 1 else geos[0]
            if isinstance(val, str) or (
                isinstance(val, list) and val and isinstance(val[0], str)
            ):
                if self._searchable(prop) or self._prop_schema(prop) is None:
                    texts = val if isinstance(val, list) else [val]
                    scheme = self._tokenization(prop)
                    total = 0
                    combined: dict[str, int] = {}
                    for t in texts:
                        tf = term_frequencies(t, scheme, self.stopwords)
                        total += sum(tf.values())
                        for term, n in tf.items():
                            combined[term] = combined.get(term, 0) + n
                    for term, n in combined.items():
                        posts.append((prop, term, n, total))
                    pv_lens[prop] = total
        # -- the object completed: merge its staging into the batch -------
        pend = self._pending
        pend["doc_count"] += 1
        for prop, v in pv_vals.items():
            self.sketches.add(prop, v)
        for prop in present:
            pend["present"][prop].append(doc_id)
        for prop in multi:
            pend["multi"][prop].append(doc_id)
        for prop, tok in toks:
            pend["tok"][prop][tok].append(doc_id)
        for prop, v in ranges:
            ids, rvals = pend["range"][prop]
            ids.append(doc_id)
            rvals.append(v)
        for prop, term, n, total in posts:
            ids, tfs, dls = pend["post"][prop][term]
            ids.append(doc_id)
            tfs.append(n)
            dls.append(total)
        for prop, total in pv_lens.items():
            pend["len_totals"][prop] += total
            pend["lens_counts"][prop] += 1
        # deferred with everything else: the live columnar bit + the
        # propvals row (ALWAYS written, even empty — its presence is the
        # "doc is indexed" marker that makes docid-level replay
        # idempotent) land at flush
        pend["docs"].append((doc_id, pv_vals, pv_lens, geo_props))

    def delete_object(self, obj) -> None:
        self._delete_known(obj.doc_id, obj.properties)

    def delete_docid(self, doc_id: int) -> None:
        """Docid-only delete (crash replay): the ``propvals`` record stands
        in for the lost object bytes, so filter/range rows clean up fully;
        postings of searchable-but-unfilterable props stay as stale rows the
        live mask screens (same stance as the RAM path). A doc with NO
        propvals row was never indexed here (every add writes one), so the
        delete is a pure no-op — counters must not drift on double replay."""
        rec = self._propvals_get(doc_id)
        if rec is None:
            self.columnar.delete(doc_id)
            self._live_cache = None
            if self._wand is not None:
                self._wand.remove_doc(doc_id)
            return
        for prop, total in rec.get("l", {}).items():
            self.len_totals[prop] -= total
            self.lens_counts[prop] = max(0, self.lens_counts[prop] - 1)
        self._delete_known(doc_id, rec.get("v", {}), adjust_lens=False)

    def _delete_known(self, doc_id: int, properties: dict,
                      adjust_lens: bool = True) -> None:
        self.doc_count = max(0, self.doc_count - 1)
        self.columnar.delete(doc_id)
        self._live_cache = None
        if self._wand is not None:
            # tombstone cached lists whose terms this delete can't name
            # (stale bucket rows are screened by the live mask anyway; the
            # engine-side tombstone keeps its block maxima honest)
            self._wand.remove_doc(doc_id)
        ids = np.asarray([doc_id], np.uint64)
        for prop, val in properties.items():
            if val is None:
                continue
            vals = val if isinstance(val, list) else [val]
            if self._filterable(prop):
                self.sketches.remove(prop)
                bk = self._terms(prop)
                bk.roaring_remove(_K_PRESENT, ids)
                if len(vals) > 1:
                    bk.roaring_remove(_K_MULTI, ids)
                if self._range_indexed(prop) and len(vals) == 1 \
                        and isinstance(vals[0], (int, float)) \
                        and not isinstance(vals[0], bool):
                    RangeBucket(self.store.bucket(
                        f"range_{prop}", "roaringsetrange")
                    ).delete_many([doc_id])
                else:
                    for v in vals:
                        tok = _tok_key(v)
                        if tok is None and isinstance(v, (int, float)):
                            tok = _num_key(v)
                        if tok is not None:
                            bk.roaring_remove(tok, ids)
            if isinstance(val, str) or (
                isinstance(val, list) and val and isinstance(val[0], str)
            ):
                if self._searchable(prop) or self._prop_schema(prop) is None:
                    texts = val if isinstance(val, list) else [val]
                    scheme = self._tokenization(prop)
                    total = 0
                    terms = set()
                    for t in texts:
                        tf = term_frequencies(t, scheme, self.stopwords)
                        total += sum(tf.values())
                        terms.update(tf)
                    bk = self._posts(prop)
                    for term in terms:
                        bk.postings_remove(term.encode("utf-8"), [doc_id])
                        self._wand_invalidate(prop, term)
                    if adjust_lens:
                        self.len_totals[prop] -= total
                        self.lens_counts[prop] = max(
                            0, self.lens_counts[prop] - 1)
        self.propvals.delete(_DOCID.pack(doc_id))
        self._pv_cache.pop(doc_id, None)

    # -- BM25 --------------------------------------------------------------
    def _token_doc_ids(self, prop: str, token: str):
        ids, _, _ = self._posts(prop).postings_get(token.encode("utf-8"))
        return ids if len(ids) else None

    def bm25_device_search(self, query: str, k: int, **kw):
        """The segment tier keeps postings in LSM buckets, not the RAM
        dicts the device assembly reads — declining here routes filtered
        hybrid legs to the WAND/stream path (callers latch the fallback
        in ``weaviate_tpu_hybrid_fallback_total``)."""
        return None

    def bm25_search(self, query: str, k: int,
                    properties: Optional[list[str]] = None,
                    allow_list: Optional[np.ndarray] = None,
                    doc_space: int = 0,
                    operator: str = "Or",
                    minimum_match: int = 0) -> tuple[np.ndarray, np.ndarray]:
        """BM25F over bucket-resident postings. Hot path: BlockMax-WAND on
        the bounded native term cache (loaded per-term from segments, LRU
        by byte budget, invalidated on write). Fallback (cache disabled or
        native toolchain absent): dense accumulation over per-term streams
        — doc lengths ride in the posting payloads either way, so nothing
        doc-aligned is gathered from RAM."""
        self._check_open()
        if properties is None or not properties:
            properties = [p.name for p in self.config.properties
                          if self._searchable(p.name)]
        props: list[tuple[str, float]] = []
        for p in properties:
            if "^" in p:
                name, boost = p.split("^", 1)
                props.append((name, float(boost)))
            else:
                props.append((p, 1.0))

        n_docs = max(1, self.doc_count)
        space = max(doc_space, self.columnar._watermark, 1)

        all_tokens, min_match = self._min_match_groups(
            query, props, operator, minimum_match)

        # BlockMax-WAND over the bounded term cache (reference
        # bm25_searcher_block.go). The live mask always rides as the allow
        # list so stale bucket rows of docid-only deletes are screened
        # exactly like the dense path screens them.
        if self._wand is not None:
            # tokenize once per property; pinned = this query's terms
            by_prop = {prop: [t for t in tokenize(
                query, self._tokenization(prop)) if t not in self.stopwords]
                for prop, _ in props}
            pinned = {(prop, t) for prop, ts in by_prop.items() for t in ts}
            # ensure + search as ONE critical section: another query's
            # eviction (or a write invalidation) must not drop this
            # query's terms between its ensure loop and its search
            cached = self._live_cache
            if cached is None or cached[0] != space:
                cached = (space, self.columnar.live_mask(space))
                self._live_cache = cached
            allow = cached[1]
            if allow_list is not None:
                al = np.asarray(allow_list, bool)
                if al.shape[0] < space:
                    al = np.pad(al, (0, space - al.shape[0]))
                allow = allow & al[:space]
            with self._wand_lock:
                query_terms = []
                groups = []
                for prop, boost in props:
                    cnt = self.lens_counts.get(prop, 0)
                    avg_len = max(
                        (self.len_totals[prop] / cnt) if cnt else 1.0, 1e-9)
                    for term in set(by_prop[prop]):
                        df = self._wand_ensure_locked(prop, term, pinned)
                        if not df:
                            continue
                        idf = math.log(
                            1.0 + (n_docs - df + 0.5) / (df + 0.5))
                        query_terms.append(
                            (prop, term, boost * idf, avg_len))
                        groups.append(all_tokens[term])
                return self._wand.search(query_terms, k, allow=allow,
                                         groups=groups,
                                         min_match=min_match)

        scores = np.zeros(space, np.float32)
        touched = np.zeros(space, bool)

        for prop, boost in props:
            cnt = self.lens_counts.get(prop, 0)
            avg_len = (self.len_totals[prop] / cnt) if cnt else 1.0
            avg_len = max(avg_len, 1e-9)
            bk = self._posts(prop)
            terms = [t for t in tokenize(query, self._tokenization(prop))
                     if t not in self.stopwords]
            for term in set(terms):
                ids, tfs_u, dls = bk.postings_get(term.encode("utf-8"))
                if not len(ids):
                    continue
                sel = ids < space
                ids, tfs_u, dls = ids[sel], tfs_u[sel], dls[sel]
                if not len(ids):
                    continue
                df = len(ids)
                idf = math.log(1.0 + (n_docs - df + 0.5) / (df + 0.5))
                tfs = tfs_u.astype(np.float32)
                denom = tfs + self.k1 * (
                    1 - self.b + self.b * dls.astype(np.float32) / avg_len)
                scores[ids] += boost * (
                    idf * tfs * (self.k1 + 1) / np.maximum(denom, 1e-9))
                touched[ids] = True

        if min_match > 1:
            touched &= self._min_match_mask(all_tokens, props, space,
                                            min_match)
        touched &= self.columnar.live_mask(space)
        if allow_list is not None:
            al = np.asarray(allow_list, bool)
            if al.shape[0] < space:
                al = np.pad(al, (0, space - al.shape[0]))
            touched &= al[:space]
        cand = np.nonzero(touched)[0]
        if len(cand) == 0:
            return np.empty(0, np.int64), np.empty(0, np.float32)
        order = np.argsort(-scores[cand], kind="stable")[:k]
        sel = cand[order]
        return sel.astype(np.int64), scores[sel]

    # -- filters -----------------------------------------------------------
    def _eval(self, flt: Filter, space: int) -> np.ndarray:
        self._check_open()
        op = flt.operator
        if op == "And":
            m = self._eval(flt.operands[0], space)
            for o in flt.operands[1:]:
                m = m & self._eval(o, space)
            return m
        if op == "Or":
            m = self._eval(flt.operands[0], space)
            for o in flt.operands[1:]:
                m = m | self._eval(o, space)
            return m
        if op == "Not":
            return ~self._eval(flt.operands[0], space)

        if flt.path is not None and len(flt.path) >= 3:
            head = self._prop_schema(flt.path[0])
            if head is not None and (
                    head.data_type == DataType.REFERENCE
                    or head.target_collection):
                if self.ref_resolver is None:
                    raise ValueError(
                        "reference filters need a collection-attached index")
                return self.ref_resolver(self, flt, space)

        mask = self._eval_leaf(op, flt.path[-1], flt.value, space)
        if mask is None:
            raise ValueError(f"unhandled operator {op!r}")
        return mask

    def _present_mask(self, prop: str, space: int) -> np.ndarray:
        return (self._terms(prop).roaring_get(_K_PRESENT).mask(space)
                & self.columnar.live_mask(space))

    def _multi_mask(self, prop: str, space: int) -> np.ndarray:
        return (self._terms(prop).roaring_get(_K_MULTI).mask(space)
                & self.columnar.live_mask(space))

    def _equal_mask(self, prop: str, fv: Any, space: int) -> np.ndarray:
        live = self.columnar.live_mask(space)
        if isinstance(fv, (int, float)) and not isinstance(fv, bool):
            m = np.zeros(space, bool)
            if self._range_indexed(prop):
                m |= RangeBucket(self.store.bucket(
                    f"range_{prop}", "roaringsetrange")
                ).query("==", float(fv)).mask(space)
            # multi-valued / schemaless numerics live as numeric tokens
            m |= self._terms(prop).roaring_get(_num_key(fv)).mask(space)
            return m & live
        tok = _tok_key(fv)
        if tok is None:
            return np.zeros(space, bool)
        return self._terms(prop).roaring_get(tok).mask(space) & live

    def _num_range_mask(self, prop: str, op: str, fv: float,
                        space: int) -> np.ndarray:
        """Numeric ordering: bit-sliced query on the range bucket, plus a
        vocabulary scan over numeric tokens (multi-valued/schemaless docs)."""
        live = self.columnar.live_mask(space)
        m = np.zeros(space, bool)
        if self._range_indexed(prop):
            m |= RangeBucket(self.store.bucket(
                f"range_{prop}", "roaringsetrange")
            ).query(op, float(fv)).mask(space)
        bk = self._terms(prop)
        enc_ref = RangeBitmap.encode(float(fv))
        import operator as _op

        cmp = {">": _op.gt, ">=": _op.ge, "<": _op.lt, "<=": _op.le}[op]
        for key in bk.keys():
            if not key.startswith(_NUM_PREFIX) or len(key) != 9:
                continue
            if cmp(_num_from_key(key), enc_ref):
                m |= bk.roaring_get(key).mask(space)
        return m & live

    def _eval_leaf(self, op: str, prop: str, fv: Any,
                   space: int) -> Optional[np.ndarray]:
        live = self.columnar.live_mask(space)
        if op == "IsNull":
            has = self._present_mask(prop, space)
            return (live & ~has) if fv else has
        if op == "Equal":
            return self._equal_mask(prop, fv, space)
        if op == "NotEqual":
            # same semantics as the columnar engine: present with a
            # different value, or any multi-valued doc
            return ((self._present_mask(prop, space)
                     & ~self._equal_mask(prop, fv, space))
                    | self._multi_mask(prop, space))
        if op in ("GreaterThan", "GreaterThanEqual", "LessThan",
                  "LessThanEqual"):
            sym = {"GreaterThan": ">", "GreaterThanEqual": ">=",
                   "LessThan": "<", "LessThanEqual": "<="}[op]
            if isinstance(fv, (int, float)) and not isinstance(fv, bool):
                return self._num_range_mask(prop, sym, float(fv), space)
            # text/date ordering: scan the (sorted, streamed) vocabulary
            m = np.zeros(space, bool)
            bk = self._terms(prop)
            import operator as _op

            cmp = {">": _op.gt, ">=": _op.ge,
                   "<": _op.lt, "<=": _op.le}[sym]
            for key in bk.keys():
                if not key.startswith(_TOK_PREFIX):
                    continue
                try:
                    val = key[1:].decode("utf-8")
                except UnicodeDecodeError:
                    continue
                if isinstance(fv, str) and cmp(val, fv):
                    m |= bk.roaring_get(key).mask(space)
            return m & live
        if op == "Like":
            from weaviate_tpu_torch.inverted.filters import like_to_regex

            rx = like_to_regex(str(fv))
            m = np.zeros(space, bool)
            bk = self._terms(prop)
            for key in bk.keys():
                if not key.startswith(_TOK_PREFIX):
                    continue
                try:
                    val = key[1:].decode("utf-8")
                except UnicodeDecodeError:
                    continue
                if rx.match(val) is not None:
                    m |= bk.roaring_get(key).mask(space)
            return m & live
        if op == "ContainsAny":
            wanted = fv if isinstance(fv, list) else [fv]
            m = np.zeros(space, bool)
            for w in wanted:
                m |= self._equal_mask(prop, w, space)
            return m
        if op == "ContainsAll":
            wanted = fv if isinstance(fv, list) else [fv]
            if not wanted:
                return np.zeros(space, bool)
            m = self._equal_mask(prop, wanted[0], space)
            for w in wanted[1:]:
                m &= self._equal_mask(prop, w, space)
            return m
        if op == "WithinGeoRange":
            # geo coords stay columnar (RAM): haversine needs raw values
            return self.columnar.eval_leaf(op, prop, fv, space)
        return None

    # -- bucket-native aggregation access ---------------------------------
    # (reference ``aggregator/`` reads the same LSM structures with
    # allowlists: no O(N·props) propvals scan)

    def _int_typed(self, prop: str) -> bool:
        p = self._prop_schema(prop)
        return p is not None and p.data_type in (DataType.INT,
                                                 DataType.INT_ARRAY)

    def _num_caster(self, prop: str):
        """float -> the schema's value type (INT props wrote ints; 2^53
        exactness makes the round-trip lossless). The schema lookup is
        hoisted OUT of the per-value loop — a 1M-doc aggregation must not
        pay a property-schema scan per element."""
        if self._int_typed(prop):
            return lambda v: int(v) if float(v).is_integer() else float(v)
        return float

    def _num_back(self, v: float, prop: str):
        """Scalar convenience over ``_num_caster`` — ONE coercion policy."""
        return self._num_caster(prop)(v)

    def _tok_value(self, key: bytes, prop: str):
        """inv_ bucket key -> python value (None = not a value row).
        ``\\x00``/``\\x01`` token bytes are ambiguous between bool and the
        one-control-character strings — the prop's SCHEMA type
        disambiguates; only schemaless props fall back to the bool
        reading (their write path only produces these bytes for bools)."""
        if key.startswith(_TOK_PREFIX):
            raw = key[1:]
            if raw in (b"\x00", b"\x01"):
                p = self._prop_schema(prop)
                if p is None or p.data_type in (DataType.BOOL,
                                                DataType.BOOL_ARRAY):
                    return raw == b"\x01"
            try:
                return raw.decode("utf-8")
            except UnicodeDecodeError:
                return None
        if key.startswith(_NUM_PREFIX) and len(key) == 9:
            return self._num_back(RangeBitmap.decode_many(
                np.asarray([_num_from_key(key)], np.uint64))[0], prop)
        return None

    def _prop_token_rows(self, prop: str, space: int):
        """(value, dense mask) per token row of ``prop`` — the single
        vocabulary walk every aggregation shape builds on."""
        bk = self._terms(prop)
        for key in bk.keys():
            val = self._tok_value(key, prop)
            if val is None:
                continue
            yield val, bk.roaring_get(key).mask(space)

    def _range_values(self, prop: str, base: np.ndarray,
                      space: int) -> tuple[np.ndarray, np.ndarray]:
        """(doc ids, reconstructed values) for a scalar-numeric prop under
        ``base`` — one 64-probe bit-slice pass, vectorized decode."""
        rb = RangeBucket(self.store.bucket(
            f"range_{prop}", "roaringsetrange"))
        ids = np.nonzero(rb.present_mask(space) & base)[0]
        if not len(ids):
            return ids, np.empty(0, np.float64)
        return ids, rb.values_for(ids)

    def agg_prop_values(self, prop: str, base: np.ndarray,
                        space: int) -> list:
        """One property's values under ``base`` as a multiset
        reconstructed from the ``inv_``/``range_`` buckets — token rows
        contribute (value × popcount(bitmap ∩ base)), scalar numerics come
        back from the bit slices vectorized. O(prop vocabulary + matching
        docs), never a per-doc ``propvals`` decode; values only
        materialize as the flat list the shared aggregator consumes.
        Values arrive in key order, not doc order — the aggregator's
        deterministic tie-breaking makes the two indistinguishable."""
        self._check_open()
        out: list = []
        for val, m in self._prop_token_rows(prop, space):
            c = int((m & base).sum())
            if c:
                out.extend([val] * c)
        if self._range_indexed(prop):
            _, vals = self._range_values(prop, base, space)
            if len(vals):
                cast = self._num_caster(prop)
                out.extend(cast(v) for v in vals)
        return out

    def agg_group_table(self, group_by: str, props: list[str],
                        base: np.ndarray, space: int):
        """Grouped aggregation collection in ONE vocabulary pass per
        property: returns ({group: count}, {group: {prop: [values]}}).
        Every token row and every bit-slice is fetched exactly once —
        per-group work is dense-mask intersections, not LSM refetches
        (the naive per-(group, prop) walk would refold every
        roaring row G times)."""
        self._check_open()
        groups: list[tuple[Any, np.ndarray]] = []
        for gval, m in self._prop_token_rows(group_by, space):
            gm = m & base
            if gm.any():
                groups.append((gval, gm))
        if self._range_indexed(group_by):
            ids, vals = self._range_values(group_by, base, space)
            for v in np.unique(vals):
                gm = np.zeros(space, bool)
                gm[ids[vals == v]] = True
                groups.append((self._num_back(v, group_by), gm))
        counts = {g: int(gm.sum()) for g, gm in groups}
        rows: dict[Any, dict[str, list]] = {
            g: {p: [] for p in props} for g, _ in groups}
        for p in props:
            for val, m in self._prop_token_rows(p, space):
                mb = m & base
                if not mb.any():
                    continue
                for g, gm in groups:
                    c = int((mb & gm).sum())
                    if c:
                        rows[g][p].extend([val] * c)
            if self._range_indexed(p):
                ids, vals = self._range_values(p, base, space)
                if len(ids):
                    cast = self._num_caster(p)
                    for g, gm in groups:
                        sel = gm[ids]
                        if sel.any():
                            rows[g][p].extend(cast(v) for v in vals[sel])
        return counts, rows

    # -- misc --------------------------------------------------------------
    def stats(self) -> dict:
        with self._wand_lock:
            wand = {"terms": len(self._wand_terms),
                    "bytes": self._wand_bytes,
                    "budget": self._wand_budget} \
                if self._wand is not None else None
        return {
            "doc_count": self.doc_count,
            "storage": "segment",
            "wand_cache": wand,
            "searchable_props": sorted(
                p.name for p in self.config.properties
                if self._searchable(p.name)),
            "filterable_props": sorted(
                p.name for p in self.config.properties
                if self._filterable(p.name)),
            "selectivity_sketches": self.sketches.summary(),
        }


def make_inverted_index(config: CollectionConfig, store=None,
                        snapshot_path=None):
    """Factory: RAM-columnar vs segment-resident, per collection config.

    ``storage="auto"`` starts RAM and upgrades at runtime (shard-driven);
    on reopen the persisted snapshot header decides which engine the shard
    had reached, so an upgraded shard boots straight into the segment tier
    instead of rebuilding into RAM."""
    storage = getattr(config.inverted_config, "storage", "ram")
    if store is None:
        return InvertedIndex(config, store)
    if storage == "segment":
        return SegmentedInvertedIndex(config, store)
    if storage == "auto" and snapshot_path is not None:
        from weaviate_tpu_torch.inverted.snapshot import read_header

        hdr = read_header(snapshot_path)
        if hdr is not None and hdr.get("mode") == "segmented":
            return SegmentedInvertedIndex(config, store)
    return InvertedIndex(config, store)
