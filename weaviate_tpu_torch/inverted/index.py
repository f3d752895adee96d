"""Inverted index: BM25 keyword search + filterable property index.

Reference: ``adapters/repos/db/inverted`` — doc indexing (``objects.go``),
BM25/BM25F scoring (``bm25_searcher.go:46``), filter evaluation
(``searcher.go`` → AllowList bitmaps). The reference stores postings in LSMKV
map/roaringset buckets and scores with WAND/BlockMax-WAND; we hold postings as
numpy-friendly dicts, score with dense vectorized accumulation over the
candidate doc space (exact, not pruned), and rebuild from the object store on
startup (the store is the WAL).
"""

from __future__ import annotations

from collections import defaultdict
from contextlib import contextmanager
from typing import Any, Optional

import numpy as np

from weaviate_tpu_torch.inverted.analyzer import stopword_set, term_frequencies, tokenize
from weaviate_tpu_torch.inverted.filters import Filter, like_to_regex
from weaviate_tpu_torch.schema.config import CollectionConfig, DataType
from weaviate_tpu_torch.storage.objects import StorageObject

_TEXT_TYPES = (DataType.TEXT, DataType.TEXT_ARRAY)


def sparse_operands(rows_p, tf_p, dl_p, segs, keep, space, k):
    """B6a's operands in one host buffer of int32 words, the entries
    and the doc space padded to their pow2 buckets as in the JAX
    package: rows (-1 pad) | tf | dl, [P] each; the segment boundaries
    [G + 1] (one segment a (property, term) posting list); each
    segment's weight, avgdl and group [G] each; the allow mask [S]
    bytes. Returns (buffer, P, G, S)."""
    from weaviate_tpu_torch.ops.fusion import bucket

    n = sum(len(r) for r in rows_p)
    p_len = bucket(n)
    g = len(segs)
    s_len = bucket(space, floor=bucket(k))
    host = np.zeros(3 * p_len + 4 * g + 1 + s_len // 4, np.int32)
    flt = host.view(np.float32)
    host[:p_len] = -1
    np.concatenate(rows_p, out=host[:n], casting="unsafe")
    np.concatenate(tf_p, out=flt[p_len:p_len + n], casting="unsafe")
    np.concatenate(dl_p, out=flt[2 * p_len:2 * p_len + n],
                   casting="unsafe")
    o = 3 * p_len
    np.cumsum([len(r) for r in rows_p], out=host[o + 1:o + g + 1])
    w, avgdl, grp = zip(*segs)
    flt[o + g + 1:o + 2 * g + 1] = w
    flt[o + 2 * g + 1:o + 3 * g + 1] = avgdl
    host[o + 3 * g + 1:o + 4 * g + 1] = grp
    host[o + 4 * g + 1:].view(bool)[:space] = keep
    return host, p_len, g, s_len


class InvertedIndex:
    def __init__(self, config: CollectionConfig, store=None):
        self.config = config
        self.k1 = config.inverted_config.bm25_k1
        self.b = config.inverted_config.bm25_b
        self.stopwords = stopword_set(config.inverted_config.stopwords_preset)
        # native BlockMax-WAND engine (C++, reference
        # bm25_searcher_block.go); None -> dense numpy path only
        import os as _os

        self.native = None
        if _os.environ.get("WEAVIATE_TPU_NATIVE_BM25", "on") != "off":
            from weaviate_tpu_torch.inverted.native_bm25 import try_native_bm25

            self.native = try_native_bm25(self.k1, self.b)
        from weaviate_tpu_torch.inverted.postings import DocLengths, PostingList

        # postings[prop][term] -> PostingList (array base + overlay)
        self.postings: dict[str, dict[str, PostingList]] = defaultdict(
            lambda: defaultdict(PostingList)
        )
        # doc_lengths[prop] -> doc-aligned length column
        self.doc_lengths: dict[str, DocLengths] = defaultdict(DocLengths)
        # running totals so avgdl is O(1) at query time (not O(doc_count))
        self.len_totals: dict[str, int] = defaultdict(int)
        # filter values: prop -> {doc_id: value} (scalar or list); the value
        # store for aggregations + doc-value lookups
        self.values: dict[str, dict[int, Any]] = defaultdict(dict)
        # columnar filter engine: vectorized predicates -> allow masks
        # (reference inverted/searcher.go -> roaring AllowList)
        from weaviate_tpu_torch.inverted.columnar import ColumnarProps

        self.columnar = ColumnarProps()
        # per-property selectivity sketches (rows / NDV / min-max) feeding
        # the cost-based query planner; maintained inline with the write
        # path, persisted with the shard snapshot (+ segment flush in
        # segmented mode)
        from weaviate_tpu_torch.inverted.sketches import SketchRegistry

        self.sketches = SketchRegistry()
        self.doc_count = 0
        # cross-collection ref-filter hook, set by the owning Collection
        # (fn(inv, flt, space) -> mask); None = ref filters unsupported
        self.ref_resolver = None
        # persistent bit-sliced range indexes for props that opt in via
        # index_range_filters (reference roaringsetrange buckets); backed
        # by the shard's LSM store when one is attached
        self.store = store
        self._range_buckets: dict[str, Any] = {}
        self._range_pending = None  # set inside batched_range_writes()
        # prop -> count of range-eligible values (None = not yet computed)
        self._range_counts: dict[str, Optional[int]] = {}
        if store is not None:
            for p in config.properties:
                if p.index_range_filters:
                    self._range_bucket(p.name)

    def _range_bucket(self, prop: str):
        if self.store is None:
            return None
        rb = self._range_buckets.get(prop)
        if rb is None:
            from weaviate_tpu_torch.storage.bitmaps import RangeBucket

            rb = RangeBucket(self.store.bucket(
                f"range_{prop}", "roaringsetrange"))
            self._range_buckets[prop] = rb
        return rb

    @contextmanager
    def batched_range_writes(self):
        """Accumulate range-index puts across a write batch and flush them
        as ONE put_many per property (65 bucket ops per batch instead of
        per object)."""
        self._range_pending = defaultdict(lambda: ([], []))
        try:
            yield
        finally:
            pending, self._range_pending = self._range_pending, None
            for prop, (ids, vals) in pending.items():
                self._range_bucket(prop).put_many(ids, vals)

    # general batched-write entry (segmented mode batches every bucket
    # family; the RAM index only has range buckets to batch)
    batched_writes = batched_range_writes

    _RANGE_TYPES = (DataType.INT, DataType.NUMBER)

    def _range_indexed(self, prop: str) -> bool:
        # scalar numeric props only: array/text props fall through to the
        # columnar engine, which handles their value shapes
        p = self._prop_schema(prop)
        return (p is not None and p.index_range_filters
                and p.data_type in self._RANGE_TYPES
                and self.store is not None)

    @staticmethod
    def _range_eligible(v) -> bool:
        return isinstance(v, (int, float)) and not isinstance(v, bool)

    def _range_count(self, prop: str) -> int:
        """Count of range-ELIGIBLE values for the prop — not len(values):
        one ineligible value (bool in an INT prop) would otherwise make
        the backfill mismatch check O(n) on every query, forever."""
        c = self._range_counts.get(prop)
        if c is None:  # first use after snapshot load: one O(n) pass
            vals = self.values.get(prop, {})
            for _ in range(5):  # concurrent writers: retry torn iteration
                try:
                    c = sum(1 for v in list(vals.values())
                            if self._range_eligible(v))
                    break
                except RuntimeError:
                    continue
            else:
                return len(vals)  # give up this round; next query retries
            self._range_counts[prop] = c
        return c

    def _range_backfill(self, prop: str, rb) -> bool:
        """Docs written before the flag was enabled (or loaded from a
        snapshot that predates the bucket) backfill on first use, keyed
        off a count mismatch — O(1) when in sync. Returns False when the
        bucket could NOT be brought in sync (torn iteration under heavy
        writes): the caller must answer from the columnar path rather
        than silently drop rows."""
        present = rb.bucket.roaring_get(rb._key(0))
        if len(present) >= self._range_count(prop):
            return True
        vals = self.values.get(prop, {})
        # concurrent writers mutate the values dict; retry the snapshot on
        # a torn iteration (same torn-read stance as the graph reads)
        for _ in range(5):
            try:
                items = list(vals.items())
                break
            except RuntimeError:
                continue
        else:
            return False
        missing = [(d, v) for d, v in items
                   if self._range_eligible(v) and d not in present]
        if missing:
            rb.put_many([d for d, _ in missing], [v for _, v in missing])
        return True

    # -- schema helpers ---------------------------------------------------
    def _prop_schema(self, name: str):
        return self.config.property(name)

    def _searchable(self, name: str) -> bool:
        p = self._prop_schema(name)
        return p is not None and p.index_searchable and p.data_type in _TEXT_TYPES

    def _filterable(self, name: str) -> bool:
        p = self._prop_schema(name)
        # auto-schema-less props are filterable by default, like the reference
        return p is None or p.index_filterable

    def _tokenization(self, name: str) -> str:
        p = self._prop_schema(name)
        return p.tokenization.value if p is not None else "word"

    # -- write ------------------------------------------------------------
    def add_object(self, obj: StorageObject) -> None:
        doc_id = obj.doc_id
        self.doc_count += 1
        self.columnar.add(
            doc_id,
            {p: v for p, v in obj.properties.items()
             if v is not None and self._filterable(p)},
        )
        for prop, val in obj.properties.items():
            if val is None:
                continue
            if self._filterable(prop):
                self.values[prop][doc_id] = val
                self.sketches.add(prop, val)
            if self._range_indexed(prop) and self._range_eligible(val):
                if prop in self._range_counts and \
                        self._range_counts[prop] is not None:
                    self._range_counts[prop] += 1
                if self._range_pending is not None:
                    ids, vals = self._range_pending[prop]
                    ids.append(doc_id)
                    vals.append(val)
                else:
                    self._range_bucket(prop).put_many([doc_id], [val])
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
                    # one posting write per (term, doc): the doc id is
                    # fresh (put_batch bumps doc ids; updates tombstone
                    # the old id), so no membership probe is needed
                    pp = self.postings[prop]
                    for term, n in combined.items():
                        pp[term].add_new(doc_id, n)
                    prev = self.doc_lengths[prop].set(doc_id, total)
                    if prev is not None:
                        self.len_totals[prop] -= prev
                    self.len_totals[prop] += total
                    if self.native is not None and combined:
                        self.native.add_doc(doc_id, prop, combined, total)

    def delete_object(self, obj: StorageObject) -> None:
        doc_id = obj.doc_id
        self.doc_count = max(0, self.doc_count - 1)
        self.columnar.delete(doc_id)
        for rb in self._range_buckets.values():
            rb.delete_many([doc_id])
        if self.native is not None:
            self.native.remove_doc(doc_id)
        for prop, val in obj.properties.items():
            popped = self.values.get(prop, {}).pop(doc_id, None)
            if popped is not None:
                self.sketches.remove(prop)
            if self._range_eligible(popped) and \
                    self._range_counts.get(prop) is not None:
                self._range_counts[prop] -= 1
            lengths = self.doc_lengths.get(prop)
            if lengths is not None:
                prev = lengths.pop(doc_id, None)
                if prev is not None:
                    self.len_totals[prop] -= prev
            if isinstance(val, str) or (
                isinstance(val, list) and val and isinstance(val[0], str)
            ):
                texts = val if isinstance(val, list) else [val]
                scheme = self._tokenization(prop)
                for t in texts:
                    for term in set(tokenize(t, scheme)):
                        plist = self.postings.get(prop, {}).get(term)
                        if plist is not None:
                            plist.pop(doc_id, None)

    def delete_docid(self, doc_id: int) -> None:
        """Delete by doc id alone — the crash-replay path, where the object
        bytes are already gone from the store. Postings entries of the doc
        cannot be located without its terms; they stay as stale rows that the
        liveness mask screens out of every query (native engine tombstones,
        dense path intersects the columnar live bitmap)."""
        self.doc_count = max(0, self.doc_count - 1)
        self.columnar.delete(doc_id)
        for rb in self._range_buckets.values():
            rb.delete_many([doc_id])
        if self.native is not None:
            self.native.remove_doc(doc_id)
        for prop, vals in self.values.items():
            popped = vals.pop(doc_id, None)
            if popped is not None:
                self.sketches.remove(prop)
            if self._range_eligible(popped) and \
                    self._range_counts.get(prop) is not None:
                self._range_counts[prop] -= 1
        for prop, lengths in self.doc_lengths.items():
            prev = lengths.pop(doc_id, None)
            if prev is not None:
                self.len_totals[prop] -= prev

    # -- BM25 -------------------------------------------------------------
    def _min_match_groups(
        self, query: str, props: list[tuple[str, float]],
        operator: str, minimum_match: int,
    ) -> tuple[dict[str, int], int]:
        """Distinct-token group table + the min-match bound for the
        SearchOperatorOptions rule (reference ``bm25_searcher.go:251``):
        every token the query produces under ANY searched property's
        tokenization gets one group; And = all of them must match.
        Shared by the RAM and segment tiers so the rule cannot drift."""
        all_tokens: dict[str, int] = {}
        for prop, _ in props:
            for t in tokenize(query, self._tokenization(prop)):
                if t not in self.stopwords and t not in all_tokens:
                    all_tokens[t] = len(all_tokens)
        min_match = 1
        if operator.lower() == "and":
            min_match = max(1, len(all_tokens))
        elif minimum_match:
            min_match = max(1, int(minimum_match))
        return all_tokens, min_match

    def _min_match_mask(self, all_tokens: dict[str, int],
                        props: list[tuple[str, float]], space: int,
                        min_match: int) -> np.ndarray:
        """Per-doc distinct-token count >= min_match, with ONE reusable
        scratch mask — O(space) memory, not O(tokens x space). A token
        matching in several properties counts once."""
        count = np.zeros(space, np.uint16)
        scratch = np.zeros(space, bool)
        for token in all_tokens:
            scratch[:] = False
            for prop, _ in props:
                ids = self._token_doc_ids(prop, token)
                if ids is not None and len(ids):
                    scratch[ids[ids < space]] = True
            count += scratch
        return count >= min_match

    def _token_doc_ids(self, prop: str, token: str):
        """Doc ids holding ``token`` in ``prop`` (min-match accounting);
        the segment tier overrides this to read its postings buckets."""
        plist = self.postings.get(prop, {}).get(token)
        if plist is None or not len(plist):
            return None
        return plist.arrays()[0]

    def _parse_props(self, properties: Optional[list[str]]) \
            -> list[tuple[str, float]]:
        """Searched (prop, boost) pairs from the request's "prop^boost"
        strings; None/empty = every searchable property."""
        if properties is None or not properties:
            properties = [
                p.name for p in self.config.properties
                if self._searchable(p.name)
            ] or list(self.postings.keys())
        props: list[tuple[str, float]] = []
        for p in properties:
            if "^" in p:
                name, boost = p.split("^", 1)
                props.append((name, float(boost)))
            else:
                props.append((p, 1.0))
        return props

    def _weighted_query_terms(
        self, query: str, props: list[tuple[str, float]], n_docs: int,
        all_tokens: dict[str, int],
    ) -> list[tuple[str, str, float, float, int]]:
        """[(prop, term, weight=boost*idf, avgdl, distinct-token group)]
        for every (searched prop, present query term) pair — the shared
        query-plan assembly of the native WAND engine and the segmented
        device kernels (``ops/sparse.py``), so their weights can never
        drift from the dense python scorer's."""
        from weaviate_tpu_torch.inverted.native_bm25 import bm25_idf

        out: list[tuple[str, str, float, float, int]] = []
        for prop, boost in props:
            prop_postings = self.postings.get(prop)
            if not prop_postings:
                continue
            lengths = self.doc_lengths.get(prop, {})
            avg_len = (self.len_totals[prop] / len(lengths)) \
                if lengths else 1.0
            terms = [
                t for t in tokenize(query, self._tokenization(prop))
                if t not in self.stopwords
            ]
            for term in set(terms):
                plist = prop_postings.get(term)
                if not plist:
                    continue
                out.append((prop, term, boost * bm25_idf(n_docs, len(plist)),
                            max(avg_len, 1e-9), all_tokens[term]))
        return out

    def bm25_device_search(
        self,
        query: str,
        k: int,
        properties: Optional[list[str]] = None,
        allow_list: Optional[np.ndarray] = None,
        doc_space: int = 0,
        operator: str = "Or",
        minimum_match: int = 0,
        device=None,
    ) -> Optional[tuple[np.ndarray, np.ndarray]]:
        """Filtered BM25F scored on ``device`` (``ops/sparse.py``, the card
        unless the caller names another): the query terms' postings
        flatten into one segmented entry list, one launch of kernel B6a
        scores, masks and selects.

        Same contract as ``bm25_search`` ((doc_ids, scores) descending).
        A failed launch raises."""
        from weaviate_tpu_torch.index.store import resolve_device
        from weaviate_tpu_torch.ops import sparse as sops

        props = self._parse_props(properties)
        n_docs = max(1, self.doc_count)
        all_tokens, min_match = self._min_match_groups(
            query, props, operator, minimum_match)
        weighted = self._weighted_query_terms(query, props, n_docs,
                                              all_tokens)
        if not weighted:
            return np.empty(0, np.int64), np.empty(0, np.float32)

        rows_p, tf_p, dl_p, segs = [], [], [], []
        for prop, term, w, avgdl, grp in weighted:
            plist = self.postings[prop][term]
            ids, tfs = plist.arrays()
            if not len(ids):
                continue
            lengths = self.doc_lengths.get(prop)
            dls = (lengths.gather(ids) if lengths is not None
                   else np.zeros(len(ids), np.float32))
            rows_p.append(ids)
            tf_p.append(tfs)
            dl_p.append(dls)
            segs.append((w, avgdl, grp))
        if not rows_p:
            return np.empty(0, np.int64), np.empty(0, np.float32)
        space = max(doc_space, max(int(r[-1]) for r in rows_p) + 1)

        # eligibility = live docs ∧ the filter's allow mask
        keep = self.columnar.live_mask(space).copy()
        if allow_list is not None:
            al = np.asarray(allow_list, bool)
            if al.shape[0] < space:
                al = np.pad(al, (0, space - al.shape[0]))
            keep &= al[:space]

        vals, ids_out = self._device_sparse_single(
            rows_p, tf_p, dl_p, segs, keep, space, k, min_match,
            len(all_tokens), resolve_device(device))
        sops.count_dispatch()
        vals_np, ids_np = sops.page_to_host(vals, ids_out)
        live = ids_np >= 0
        return ids_np[live].astype(np.int64), vals_np[live]

    def _device_sparse_single(self, rows_p, tf_p, dl_p, segs, keep, space,
                              k, min_match, n_tokens, device):
        """Single-device dispatch: the operands (``sparse_operands``) in one
        upload, then one launch of B6a."""
        import torch

        from weaviate_tpu_torch.ops import sparse as sops
        from weaviate_tpu_torch.ops.fusion import bucket

        host, p, g, s_len = sparse_operands(rows_p, tf_p, dl_p, segs, keep,
                                            space, k)
        dev = torch.from_numpy(host).to(device)
        flt = dev.view(torch.float32)
        o = 3 * p
        rows, tf, dl = dev[:p], flt[p:2 * p], flt[2 * p:o]
        seg = dev[o:o + g + 1]
        seg_w = flt[o + g + 1:o + 2 * g + 1]
        seg_avgdl = flt[o + 2 * g + 1:o + 3 * g + 1]
        allow = dev[o + 4 * g + 1:].view(torch.bool)
        kk = min(k, s_len)
        if min_match > 1:
            return sops.sparse_score_topk_min_match(
                rows, tf, dl, seg, seg_w, seg_avgdl,
                dev[o + 3 * g + 1:o + 4 * g + 1], allow, kk, float(self.k1),
                float(self.b), bucket(max(1, n_tokens), floor=2),
                int(min_match))
        return sops.sparse_score_topk(rows, tf, dl, seg, seg_w, seg_avgdl,
                                      allow, kk, float(self.k1),
                                      float(self.b))

    def _device_sparse_mesh(self, *args, **kwargs):
        """The mesh form of the device scoring (entries partitioned by doc
        row-block along the mesh's shard axis): not ported yet."""
        raise NotImplementedError(
            "device BM25 scoring on a mesh (_device_sparse_mesh, "
            "parallel/sharded_search.py): not ported yet (ROADMAP queue A, "
            "slice 11)")

    def bm25_search(
        self,
        query: str,
        k: int,
        properties: Optional[list[str]] = None,
        allow_list: Optional[np.ndarray] = None,
        doc_space: int = 0,
        operator: str = "Or",
        minimum_match: int = 0,
    ) -> tuple[np.ndarray, np.ndarray]:
        """BM25F over the given (optionally boosted ``prop^2``) properties.

        ``operator``/``minimum_match`` are the reference's
        SearchOperatorOptions (``bm25_searcher.go:251``): And = a doc
        must match EVERY query token; Or with minimum_match = at least
        that many distinct tokens (a token matching in several
        properties counts once).

        Returns (doc_ids [<=k], scores [<=k]) sorted by descending score.
        """
        props = self._parse_props(properties)
        n_docs = max(1, self.doc_count)
        all_tokens, min_match = self._min_match_groups(
            query, props, operator, minimum_match)

        # native BlockMax-WAND hot path — filtered queries pass the allow
        # mask into the engine (WAND skipping stays active; reference WAND
        # consumes AllowLists the same way)
        if self.native is not None:
            weighted = self._weighted_query_terms(query, props, n_docs,
                                                  all_tokens)
            query_terms = [(p, t, w, a) for p, t, w, a, _ in weighted]
            groups = [g for _, _, _, _, g in weighted]
            return self.native.search(query_terms, k, allow=allow_list,
                                      groups=groups, min_match=min_match)

        space = max(
            doc_space,
            1 + max(
                (
                    int(pl.keys()[-1])
                    for prop, _ in props
                    for pl in self.postings.get(prop, {}).values()
                    if len(pl)
                ),
                default=0,
            ),
        )
        scores = np.zeros(space, np.float32)
        touched = np.zeros(space, bool)

        for prop, boost in props:
            prop_postings = self.postings.get(prop)
            if not prop_postings:
                continue
            lengths = self.doc_lengths.get(prop)
            avg_len = (
                self.len_totals[prop] / len(lengths)
                if lengths is not None and len(lengths)
                else 1.0
            )
            terms = [
                t
                for t in tokenize(query, self._tokenization(prop))
                if t not in self.stopwords
            ]
            for term in set(terms):
                plist = prop_postings.get(term)
                if plist is None or not len(plist):
                    continue
                from weaviate_tpu_torch.inverted.native_bm25 import bm25_idf

                idf = bm25_idf(n_docs, len(plist))
                ids, tfs_u = plist.arrays()
                tfs = tfs_u.astype(np.float32)
                dls = (
                    lengths.gather(ids)
                    if lengths is not None
                    else np.zeros(len(ids), np.float32)
                )
                denom = tfs + self.k1 * (1 - self.b + self.b * dls / max(avg_len, 1e-9))
                term_scores = idf * tfs * (self.k1 + 1) / np.maximum(denom, 1e-9)
                scores[ids] += boost * term_scores
                touched[ids] = True

        if min_match > 1:
            touched &= self._min_match_mask(all_tokens, props, space,
                                            min_match)

        # stale postings of crash-replay deletions are screened here (see
        # delete_docid); live docs are unaffected
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

    # -- filters ----------------------------------------------------------
    def allow_list(self, flt: Filter, doc_space: int) -> np.ndarray:
        """Evaluate a filter tree to a dense bool mask over doc ids."""
        flt.validate()
        return self._eval(flt, doc_space)

    def _eval(self, flt: Filter, space: int) -> np.ndarray:
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

        # ref filter: path [refProp, TargetClass, ...tail] joins through
        # the target collection (reference searcher.go ref recursion).
        # Disambiguated by SCHEMA, not naming convention: the head segment
        # must be a REFERENCE property (a nested prop path never is).
        if flt.path is not None and len(flt.path) >= 3:
            head = self._prop_schema(flt.path[0])
            if head is not None and (
                    head.data_type == DataType.REFERENCE
                    or head.target_collection):
                if self.ref_resolver is None:
                    raise ValueError(
                        "reference filters need a collection-attached index")
                return self.ref_resolver(self, flt, space)

        # range-indexed props answer comparisons from the persistent
        # bit-sliced index (reference roaringsetrange reader)
        _RANGE_OPS = {"GreaterThan": ">", "GreaterThanEqual": ">=",
                      "LessThan": "<", "LessThanEqual": "<=",
                      "Equal": "==", "NotEqual": "!="}
        if (flt.path and op in _RANGE_OPS
                and isinstance(flt.value, (int, float))
                and not isinstance(flt.value, bool)
                and self._range_indexed(flt.path[-1])):
            rb = self._range_bucket(flt.path[-1])
            if self._range_backfill(flt.path[-1], rb):
                bm = rb.query(_RANGE_OPS[op], flt.value)
                return bm.mask(space) & self.columnar.live_mask(space)
            # bucket not provably complete this round: the columnar path
            # below answers correctly (never silently drop rows)

        # leaf: vectorized columnar evaluation (reference searcher.go ->
        # AllowList; here numpy columns instead of roaring segments)
        mask = self.columnar.eval_leaf(op, flt.path[-1], flt.value, space)
        if mask is None:
            raise ValueError(f"unhandled operator {op!r}")
        return mask

    def estimate_selectivity(self, flt: Filter) -> float:
        """Sketch-based estimate of the fraction of live docs passing
        ``flt`` — O(filter tree), never touches postings or columns. The
        planner's only statistics input (docs/planner.md)."""
        from weaviate_tpu_torch.inverted.sketches import estimate_selectivity

        flt.validate()
        return estimate_selectivity(flt, self.sketches.props,
                                    self.doc_count)

    def stats(self) -> dict:
        return {
            "doc_count": self.doc_count,
            "searchable_props": sorted(self.postings.keys()),
            "filterable_props": sorted(self.values.keys()),
            "selectivity_sketches": self.sketches.summary(),
        }


