"""Drive the PyTorch/CUDA port's near-vector search paths on one card.

    python3 chip_smoke.py [--seed 0]

Phases, each printing one JSON line with its seconds; any failure exits
non-zero without the final line:

1. env     — card name and power limit, torch and CUDA versions, the time to
             build every kernel from ``weaviate_tpu_torch/csrc`` (one nvcc
             each, all at once) and the native host libraries from
             ``weaviate_tpu_torch/native``.
2. kernels — each kernel against its plain PyTorch version on the card over
             a grid: the fused flat scan (K1) over shapes, masks and edge
             cases; the fused HNSW walk (B2) over every metric, widths D of
             25/99/128/768, layer-0 widths M0 of 32/64, beams of 16 to 512,
             batches of 1 to 256, unfiltered and filtered (allow masks of
             1%/10%/50%, kept tracks of 8/32, two-hop budgets of 0-4), on
             graphs the port builds on the card, with its BQ scorer (equal
             to the plain walk; on two graphs at every beam of 16 to 512,
             unfiltered and filtered) and its SQ, PQ and RQ scorers
             (l2/dot/cosine, unfiltered and filtered) on each, then the
             code rows at the edges the kernel's staged paths branch on
             (``code_edge_walks``: the widest SQ walk admitted, PQ at
             config 3's 96 x 16 through its ADC table, PQ whose table does
             not fit through the chunked centroid gather);
             the BQ scan (Q1, equal to its plain version), the SQ scan
             (Q2), the PQ scan (Q3, segments of 8, 96 and D/4 and
             sub-widths of 3 and 6) and the RQ scan (Q4) over B of
             1/16/256, D of 25/768/1536, fetch of 10/200/320/1024, 1% and
             50% masked,
             fetch past the live rows, and the selection's edges (fetch =
             MAX_K, N below fetch and below one split, a wholly masked
             split, B of 53 and 257, 16-d bits, fetch 40 at 64-d); the
             merge alone, bit for bit, on made lists at its edges
             (``merge_edges``: every split full or empty, ties at the
             k-th across splits, k = 1, the largest k whose full lists it
             stages in shared memory and one more, unaligned lists, B of
             1 and 257, MAX_K); B6a, the sparse scatter + top-k, at
             phase ``hybrid``'s tenant size (8,192 docs) and at a full
             config-5 tenant (550,000 docs, bench_msmarco's postings made
             on the card) unfiltered, under 1% and 45% allow masks, with
             min-match 2 and at k 100, and B6b, the fusion, at config 5's
             (2 legs of 32, union 64, k 10), on its small path's widest
             (a slot repeated across its 32-position steps) and at unions
             in shared and in device memory, both algorithms: each against
             its plain version and the CPU plain version's bits, and two
             launches bit for bit.
3. main    — ``FlatIndex`` at full width: 1,000,000 seeded 768-d vectors,
             1% deleted, 256 queries, k = 10 through the fused-kernel route;
             recall@10 against the exact float32 ground truth, launch counts,
             kernel / plain / search / exact-path times, device memory.
4. warm    — demote the index to host RAM, search there, promote, search
             again: the answers agree.
5. db      — the user's entry point for the flat path, cut in depth to the
             first DB_ROWS of those vectors: ``DB`` ->
             ``Collection.put_batch`` as objects with an int and a text
             property, 1% deleted, then ``Collection.vector_search_batch``
             (B = 256, k = 10) through the fused kernel: recall@10, a
             filtered query, close and reopen with the same answers, ingest
             and reopen seconds, search p50/p99, the kernel's share of a
             search, device memory.
6. hnsw    — ``HNSWIndex`` at the GloVe-25 configuration of the JAX
             package's ``bench.py bench_glove``, cut in depth (cut 8):
             HNSW_ROWS seeded unit
             25-d rows, cosine, ef 64, ef_construction 96, M 16, the fused
             walk (B2) for search and layer-0 construction. Build rate,
             launches and B2's summed time in the build, recall@10 against
             the exact float32 answer, search p50/p99 and one launch per
             search, B2's time on the search's launch and on a construction
             launch beside its bound and its plain version (and µs a hop),
             the host walk on the same index, an ef sweep, a 1% delete,
             device memory.
7. hnsw_db — the same rows (the first HNSW_DB_ROWS) as objects through
             ``DB`` -> ``Collection`` with an HNSW index: search unfiltered,
             under a 1% filter (the planner's exact plan) and under the
             resident 45% filter ``bucket < 45`` (the filtered beam: one B2
             launch with the kept track), then close and reopen (graph.npz)
             and a crash and reopen (commit-log replay), each with the same
             uuids.
8. quant   — the quantized flat index through ``make_flat``: BQ at
             ``bench.py bench_bq``'s configuration (BQ_ROWS LAION-like
             768-d rows made on the card, cosine, rescore_limit 320), SQ
             at ``bench_msmarco``'s per-tenant index (550,000 rows,
             rescore_limit 200) and RQ in SQ's place on the same rows:
             recall@10 against the exact float32 answer, the search's
             kernels (Q1, Q2 or Q4, then the merge) beside their bound and
             their plain version, its launches (one scan, one merge), the
             scan alone and the merge alone against its plain version and
             ``torch.topk`` on the scan's lists (their fill, each list's
             taken entries before its padding), Q2 and Q4 beside
             ``torch.matmul`` of the
             product alone, search p50/p99, the rescore's share, device
             and host bytes; then HNSW + RQ over the tenant's first
             RQ_HNSW_ROWS rows (B2-RQ in its build and search).
9. hnsw_quant — ``HNSWIndex`` + BQ at ``bench_hnsw_quant``'s bq
             configuration (768-d, l2-squared, ef 96, M 16, rescore_limit
             80, the fused walk) at HNSW_QUANT_ROWS rows: the build rate,
             recall@10 of the device walk against the host walk on the
             same index, one B2 launch a search, B2-BQ beside its bound
             and its plain version.
10. quant_db — 100,000 of those rows as objects in an HNSW + SQ
             collection (cosine): unfiltered (B2-SQ), 1% (the exact plan:
             Q2) and the resident 45% filter (the filtered beam) searches,
             close and reopen (graph.npz + quantizer.msgpack, codes rebuilt
             from the objects), a crash and reopen, each with the same
             uuids; B2-SQ's widest ingest launch timed as a construction
             launch.
11. pq     — BASELINE.json config 3 (DBpedia-OpenAI 1M 1536-d, PQ with 96
             segments) as ``bench.py bench_pq`` runs it, not cut: 1,000,000
             clustered 1536-d rows made on the card, l2-squared,
             ``PQConfig(segments=96, rescore_limit=40)`` through
             ``make_flat``, added in steps of 200,000 (the k-means fit runs
             on the card): fit seconds and encode vectors/s, recall@10,
             Q3 and the merge (one launch each a search) beside the bound,
             the plain version and ``torch.matmul`` of the product alone,
             search p50/p99, the rescore's share, device and host bytes.
12. hnsw_pq — config 3 as a graph (``bench_hnsw_quant``'s pq
             configuration: ef 96, M 16, PQ 96 segments, rescore 40) at
             HNSW_PQ_ROWS rows: the build, recall@10 of the device walk
             and the host walk, one B2 launch a search, B2-PQ beside its
             bound and its plain version on the search's launch and on
             the build's widest launch (so in phases ``quant`` for B2-RQ
             and ``hnsw_quant`` for B2-BQ).
13. hybrid — BASELINE.json config 5 (MS-MARCO hybrid BM25 + vector, 16
             tenants) as ``bench.py bench_msmarco`` makes it, cut in depth
             to HYBRID_DOCS objects a tenant (cut 7): one multi-tenant
             collection through ``DB`` with text from the Zipf
             vocabulary, an int ``bucket`` and 768-d cosine vectors in an
             SQ flat index; HYBRID_REQUESTS hybrid requests a pass
             (alpha 0.5, k 10): unfiltered (WAND, Q2, B6b), under 1% and
             45% ``bucket`` filters (the device sparse leg, B6a),
             rankedFusion, ``bm25_search(device_scoring=True)`` (held to
             WAND's pages), one aggregate a tenant; p50/p99 and each leg's
             time a pass, B6a's and B6b's launches (above zero, asserted)
             and times on the main path's inputs, recall@10 against the
             exact hybrid ranking, device memory.
14. rerank — slice 7a through the user's entry points: a ``DB``
             collection with a multivector target (MV_DOCS documents of
             40-180 unit 128-d tokens, ColBERTv2's shapes; MUVERA at
             Weaviate's defaults: ksim 4, dprojections 16, repetitions 10,
             rescore 4k) searched by 256 queries of 32 tokens, k 10: the
             FDE scan, then B7a; recall@10 against the exact MaxSim over
             every document (on the card, in chunks), p50/p99, B7a's
             launches and time, ingest documents/s. The HNSW rerank tier
             at ``bench.py bench_rerank``'s configuration (RR_ROWS 128-d
             rows, 4 tokens a row, ef 96, M 16): recall@10 and NDCG@10
             against the exact MaxSim with and without rerank, one B2 and
             one B7a launch a search (asserted). The multi-target cell at
             ``bench_multitarget``'s 2t corpus (768-d and 256-d HNSW
             targets, MT_ROWS objects): 32 queries under each of the five
             combinations, recall@10 against the host oracle, p50, two B2
             launches and one B7b launch a search (asserted).
             Phase ``kernels`` holds B7a (``b7_rerank_grid``) and B7b
             (``b7_join_grid``) against their plain versions on the card.
15. hfresh — slice 7b: a ``DB`` collection with an HFresh target at its
             defaults (cosine; max posting 128, probe 8, 2 replicas) of
             HF_ROWS rows of config 4's generator (LAION-like unit 768-d
             rows, 4,096 centres, noise 0.45, made on the card; cut 10),
             256 queries (the first rows + 0.05 noise) through
             ``vector_search_batch``, k 10: one B9a launch a search
             (asserted above zero), ingest vectors/s and seconds by step,
             centroids, largest posting, cmax, recall@10 against the exact
             float32 answer over every row, p50/p99, B9a's device time,
             with its host part, and on the path (from the batch's posting
             operands to the call's end) beside ``b9a_bound_ms`` and its
             plain version, the device posting table's host ms (built once
             after the ingest), close and checkpointed reopen with the
             same uuids, device
             bytes. Then ``GeoIndex`` at GEO_POINTS points (past its
             2,000,000-point device cutoff): 64 ``within_range`` and
             ``knn`` queries at radii of 1-500 km held to numpy's float64
             haversine, ``_dists`` on the card against the host.
             Phase ``kernels`` holds B9a (``b9_posting_grid``) against its
             plain version: five metrics, D 768 and 99, columns within and
             past the keys' shared memory, k 10, 100 and past the columns,
             masked rows, dead rows and exact duplicates.
16. segment — slice 6b: config 5's text (SEG_DOCS docs of bench_msmarco's
             Zipf vocabulary, cut 11) and an int ``bucket`` in a
             ``storage="segment"`` collection and its ``"ram"`` twin, held
             to each other (BM25 pages bit for bit, the 1% and 45% allow
             lists, a hybrid request, an aggregate); a ``storage="auto"``
             collection whose cutoff the ingest crosses migrates and then
             answers as the twin does; after a close it reopens in the
             segment tier. Ingest docs/s and BM25 p50 on each tier, close s.

Then one ``{"kernels": [...]}`` line, the card's name and power limit, and
last ``{"ok": true, "device": {...}}``. Needs a CUDA card; exits non-zero
without one.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from weaviate_tpu_torch import _build, native
from weaviate_tpu_torch.compression import (
    BinaryQuantizer,
    ProductQuantizer,
    RotationalQuantizer,
    ScalarQuantizer,
    build_quantizer,
)
from weaviate_tpu_torch.compression.kmeans import _assign_chunked
from weaviate_tpu_torch.core.db import DB
from weaviate_tpu_torch.index import geo
from weaviate_tpu_torch.index import hfresh as hfresh_index
from weaviate_tpu_torch.index.flat import FlatIndex, exact_rescore, make_flat
from weaviate_tpu_torch.index.hnsw import HNSWIndex
from weaviate_tpu_torch.index.hnsw.graph import HostGraph
from weaviate_tpu_torch.inverted.filters import Where
from weaviate_tpu_torch.monitoring.metrics import (
    HYBRID_LEG_SECONDS,
    PLANNER_PLANS,
)
from weaviate_tpu_torch.modules.device import (
    LinearRerank,
    MaxSimRerank,
    RerankRequest,
)
from weaviate_tpu_torch.ops import (
    device_beam,
    fused_flat,
    fusion,
    hfresh,
    quantized,
    rerank,
    sparse,
)
from weaviate_tpu_torch.ops.distance import MASK_DISTANCE, flat_search, normalize
from weaviate_tpu_torch.query.fusion import relative_score_fusion
from weaviate_tpu_torch.query.multi_target import join_mode, weight_row
from weaviate_tpu_torch.query.planner import PLAN_BEAM, PLAN_EXACT
from weaviate_tpu_torch.schema.config import (
    BQConfig,
    CollectionConfig,
    DataType,
    FlatIndexConfig,
    HFreshIndexConfig,
    HNSWIndexConfig,
    InvertedIndexConfig,
    MultiTenancyConfig,
    MultiVectorIndexConfig,
    PQConfig,
    Property,
    RerankModuleConfig,
    RQConfig,
    SQConfig,
)
from weaviate_tpu_torch.storage.objects import StorageObject

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, bf16 and float32
# (outside the tensor cores) FLOP/s
HBM_BYTES_S = 3.35e12
BF16_FLOP_S = 989e12
FP32_FLOP_S = 67e12
INT8_OPS_S = 1979e12

# kernel vs plain: float32 sums of the same bf16 products in another order
ATOL, RTOL = 1e-2, 1e-4
MIN_ID_AGREEMENT = 0.999
# B2 with bf16 products: a pair of candidates within a bf16-rounded sum's
# error can swap, and the walk then diverges from there
MIN_ID_AGREEMENT_BF16 = 0.99
# Q2 at the selection's edges (Q_EDGES), whose fetch of up to MAX_K and
# 16-d codes reach deep into near ties. On an H100 (probe_quantized.py
# --agreement) sound Q2s read 0.99733 (the kernel) and 0.99858 (the
# product summed in float64); a Q2 that gives ties to the higher row reads
# 0.99299, which compare's tolerance lets through; queries rounded to one
# mantissa bit fewer, or cut to bf16, compare refuses
MIN_ID_AGREEMENT_Q2_EDGES = 0.995

ROWS, DIMS, BATCH, K = 1_000_000, 768, 256, 10
# the kernel variant the main path's shapes take
MAIN_VARIANT = "cluster"
INGEST_BATCH = 65536
# phase db: its depth (the first DB_ROWS of phase main's vectors; cut from
# 1M so the HNSW phases fit the time limit), objects per put_batch, the
# seeded text vocabulary, the filter
DB_ROWS = 3 * INGEST_BATCH
DB_BATCH = 10_000
VOCAB, TEXT_WORDS = 1000, 8
FILTER_BUCKET = 7


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> list[float]:
    """Per-call device times of ``fn`` in ms (CUDA events around each)."""
    for _ in range(warmup):
        fn()
    out = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return out


def pair_distance(queries, corpus, sqnorms, mask, ids):
    """Plain bf16-product L2 distance of each (query, id) pair [B, k]; masked
    rows give MASK_DISTANCE and id -1 gives inf."""
    safe = ids.clamp(min=0).long()
    qf = queries.float()
    qb = qf.to(torch.bfloat16).float()
    cb = corpus[safe].to(torch.bfloat16).float()             # [B, k, D]
    ip = torch.einsum("bd,bkd->bk", qb, cb)
    d = torch.clamp((qf * qf).sum(1, keepdim=True) - 2.0 * ip + sqnorms[safe],
                    min=0.0)
    d = torch.where(mask[safe], d, MASK_DISTANCE)
    return torch.where(ids < 0, float("inf"), d)


def compare(kv, ki, pv, pi, near):
    """Kernel (kv, ki) against plain (pv, pi), merged [B, k]. Distances
    within ATOL + RTOL*|plain|; sentinel slots -1 on both; where ids differ,
    the kernel's id must be a near tie: ``near(ids)`` (the plain distance of
    each returned id) within tolerance of the plain distance at that slot.
    Returns (max abs error, equal ids, compared ids)."""
    tol = ATOL + RTOL * pv.abs()
    live = pv < MASK_DISTANCE
    err = (kv - pv).abs()
    if bool((err > tol).any()):
        raise AssertionError(f"distances differ: max err {err.max().item()}")
    if not bool(((pi == -1) == ~live).all() and ((ki == -1) == ~live).all()):
        raise AssertionError("sentinel slots differ from id -1")
    diff = (ki != pi) & live
    if bool(diff.any()):
        dk = near(ki)
        bad = diff & ((dk - pv).abs() > tol)
        if bool(bad.any()):
            raise AssertionError(
                f"{int(bad.sum())} ids differ beyond a near tie")
    n_live = int(live.sum())
    return (err[live].max().item() if n_live else 0.0,
            n_live - int(diff.sum()), n_live)


def l2_bytes_model(variant: str, plan: dict, b: int, n: int, d: int,
                   esize: int, block: int) -> int:
    """Bytes the kernel should move from L2 into the SMs per call, estimated
    from its design (no profiler counts them on the card):
    each corpus block once per query tile (once per cluster of tiles), the
    norms and mask with it, and the float32 query tile once per CTA (ring)
    or once per row tile of the block (legacy, which restages it)."""
    qt, cluster = plan["query_tile"], plan["cluster"]
    tiles = -(-b // qt)
    ctas = tiles * (n // block)
    corpus = n * (d * esize + 5) * tiles // cluster
    per_cta = qt * d * 4
    if variant == "legacy":
        per_cta *= block // (128 if qt == 16 else 64)
    return corpus + ctas * per_cta


def phase_env() -> dict:
    t0 = time.perf_counter()
    # the native host libraries (g++) build beside the kernels (nvcc)
    host_err = []
    host = threading.Thread(target=lambda: host_err.extend(
        _native_build(lib) for lib in ("segment_merge", "bm25_wand")))
    host.start()
    logs = _build.build(fused_flat.KERNEL, device_beam.KERNEL,
                        quantized.KERNEL, sparse.KERNEL, rerank.KERNEL,
                        hfresh.KERNEL)
    host.join()
    errs = [e for e in host_err if e]
    if errs:
        raise RuntimeError("; ".join(errs))
    build_s = time.perf_counter() - t0
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "error" in line or "spill" in line:
                print(f"[nvcc {name}] {line.strip()}", file=sys.stderr)
    return {"card": card(), "torch": torch.__version__,
            "cuda": torch.version.cuda, "build_s": build_s}


def _native_build(lib: str) -> str:
    """Builds one native host library; "" when it loaded, else the error."""
    try:
        native.load(lib)
    except native.NativeUnavailable as e:
        return f"native {lib}: {e}"
    return ""


# kernel grid: B covers query tiles of 1 to 4 with ragged last tiles; D
# covers the resident-tile widths, and LEGACY_D is too wide for it
GRID_B = (1, 7, 64, 65, 100, 200, 256)
GRID_D = (64, 100, 768, 1024, 1536)
LEGACY_D = 6144
ODD_D = 99


def check_case(gen, block, n, fold, k, b, d, masked_block, bf16_too):
    """One kernel-vs-plain case: returns [(variant, max err, equal ids,
    compared ids)] for the float32 corpus and, with ``bf16_too``, its bf16
    copy."""
    dev = torch.device("cuda")
    corpus = torch.randn(n, d, generator=gen, device=dev)
    q = corpus[:b] + 0.1 * torch.randn(b, d, generator=gen, device=dev)
    q = q.contiguous()
    sq = (corpus * corpus).sum(1)
    mask = torch.rand(n, generator=gen, device=dev) > 0.3
    if masked_block:
        mask[:block] = False
    out = []
    for c in (corpus, corpus.to(torch.bfloat16)) if bf16_too else (corpus,):
        variant, _ = fused_flat.kernel_variant(q, c, k, block, fold)
        kv, ki = fused_flat.block_topk_cuda(q, c, sq, mask, k, block, fold)
        pv, pi = fused_flat.block_topk_reference(q, c, sq, mask, k, block,
                                                 fold)
        torch.cuda.synchronize()
        raw = (kv - pv).abs()
        if bool((raw > ATOL + RTOL * pv.abs()).any()):
            raise AssertionError(
                f"block outputs differ: {variant} block={block} fold={fold} "
                f"k={k} B={b} D={d} {c.dtype}: max {raw.max().item()}")
        mk = fused_flat.merge_blocks(kv, ki, block, k)
        mp = fused_flat.merge_blocks(pv, pi, block, k)
        e, s, t = compare(
            *mk, *mp, lambda ids, c=c: pair_distance(q, c, sq, mask, ids))
        out.append((variant, e, s, t))
    return out


def phase_kernels(seed: int) -> dict:
    """fused_flat kernel vs plain over blocks 128/2048, folds 1/2/16, k
    1/10/64, B in GRID_B, D in GRID_D (and LEGACY_D, ODD_D), float32 and bf16
    corpora, partial masks and masked blocks; every case of both variants
    must agree."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    dev = torch.device("cuda")
    cases, max_err, same, total, raised = 0, 0.0, 0, 0, 0
    by_variant: dict[str, int] = dict.fromkeys(fused_flat.VARIANTS, 0)
    grid = [(block, n, fold, k, b, d)
            for block, n in ((128, 384), (2048, 4096))
            for fold in (1, 2, 16) for k in (1, 10, 64)
            for b in GRID_B for d in GRID_D]
    grid += [(128, 384, fold, 10, b, LEGACY_D)
             for fold in (1, 16) for b in (7, 65)]
    # rows off 16-byte boundaries: the legacy kernel
    grid += [(2048, 4096, 16, 10, b, ODD_D) for b in (65, 256)]
    for block, n, fold, k, b, d in grid:
        if block // fold < k:
            q = torch.zeros(b, d, device=dev)
            c = torch.zeros(n, d, device=dev)
            try:
                fused_flat.block_topk_cuda(
                    q, c, c[:, 0].contiguous(),
                    torch.ones(n, dtype=torch.bool, device=dev), k, block,
                    fold)
            except ValueError:
                raised += 1
                continue
            raise AssertionError(
                f"k={k} > {block}/{fold} buckets did not raise")
        for variant, e, s, t in check_case(
                gen, block, n, fold, k, b, d, masked_block=bool(cases % 2),
                bf16_too=fold == 16 and b in (7, 100) or d == ODD_D):
            max_err = max(max_err, e)
            same += s
            total += t
            by_variant[variant] += 1
            cases += 1
    if not all(by_variant.values()):
        raise AssertionError(f"a variant went untested: {by_variant}")
    # a fully masked corpus gives only sentinels
    corpus = torch.randn(2048, 64, generator=gen, device=dev)
    none = torch.zeros(2048, dtype=torch.bool, device=dev)
    v, i = fused_flat.fused_flat_topk(corpus[:5].contiguous(), corpus,
                                      (corpus * corpus).sum(1), none, 5,
                                      chunk_size=512)
    if not bool((i == -1).all() and (v >= MASK_DISTANCE).all()):
        raise AssertionError("fully masked corpus returned live ids")
    agreement = same / max(1, total)
    if agreement < MIN_ID_AGREEMENT:
        raise AssertionError(f"id agreement {agreement} < {MIN_ID_AGREEMENT}")
    return {"cases": cases, "cases_by_variant": by_variant,
            "raised_as_expected": raised, "max_abs_err": max_err,
            "id_agreement": agreement,
            "tolerance": {"atol": ATOL, "rtol": RTOL},
            "b2": beam_kernel_grid(seed),
            "q1_q2": quant_kernel_grid(seed),
            "merge": merge_edges(seed),
            "b6a": b6_sparse_grid(seed),
            "b6b": b6_fusion_grid(seed),
            "b7a": b7_rerank_grid(seed),
            "b7b": b7_join_grid(seed),
            "b9a": b9_posting_grid(seed)}


# Q1/Q2 grid: batches, widths, fetch widths, masked shares (1% and 50%);
# every sixth case has fewer live rows than its fetch
Q_BS = (1, 16, 256)
Q_DIMS = (25, 768, 1536)
Q_FETCH = (10, 200, 320, 1024)
Q_MASKED = (0.01, 0.5)
Q_ROWS, Q_FEW_ROWS = 50_001, 300  # neither a multiple of a kernel tile
# and the edges of the epilogue selection: (name, B, N, D, fetch, masked);
# "split1" masks every row of the scan's second split
Q_EDGES = (
    ("max_k", 256, Q_ROWS, 768, quantized.MAX_K, 0.01),
    ("n_below_k", 16, 1_000, 768, 2_000, 0.01),
    ("n_below_a_split", 7, 50, 99, 20, 0.01),
    ("masked_split", 64, Q_ROWS, 768, 320, "split1"),
    ("b53", 53, Q_ROWS, 768, 320, 0.01),
    ("b257", 257, Q_ROWS, 768, 200, 0.01),
    ("ties_d16", 256, Q_ROWS, 16, 1024, 0.01),
    ("fetch40_d64", 256, Q_ROWS, 64, 40, 0.01),
)
# Q3's segments: cycled over the grid (8, 96 and D/4, each shrunk to a
# divisor of D as ProductQuantizer shrinks it: sub-dimensions of 192, 96,
# 16, 8, 5, 4 and 1), 16 on the edges ("fetch40_d64": 4 sub-dimensions),
# and Q3's own edges with their segments: sub-dimensions of 3 and 6, which
# the decode gathers a value and two values a copy
Q3_SEGMENTS = (8, 96, 0)
Q3_EDGES = (("dsub3", 256, Q_ROWS, 768, 200, 0.01, 256),
            ("dsub6", 64, Q_ROWS, 768, 100, 0.5, 128))


def sq_inputs(x: torch.Tensor, metric: str, fit_rows: int = 20_000):
    """An SQ quantizer fitted on ``x`` (unit rows for dot and cosine) and
    its device planes, encoded on the host as the index does."""
    sq = ScalarQuantizer(x.shape[1], metric)
    host = x.cpu().numpy()
    sq.fit(host[:fit_rows])
    enc = sq.encode(host)
    return sq, (torch.from_numpy(enc["codes"]).to(x.device),
                torch.from_numpy(enc["dec_sqnorm"]).to(x.device))


def pq_segments(d: int, m: int) -> int:
    """``m`` segments (0: D/4) shrunk to a divisor of ``d``, as
    ProductQuantizer takes them."""
    m = m or max(1, d // 4)
    while d % m:
        m -= 1
    return m


def pq_inputs(gen, x: torch.Tensor, m: int):
    """PQ planes of the rows ``x`` [n, d] made on the card: 256 centroids a
    segment drawn from the rows' own segments, each row's nearest codes,
    and the decoded rows' squared norms. -> (codes [n, m] uint8, codebooks
    [m, 256, d/m] bf16, dec_sqnorms [n])."""
    n, d = x.shape
    segs = x.view(n, m, d // m).transpose(0, 1).contiguous()
    picks = torch.randint(0, n, (256,), generator=gen, device=x.device)
    cb = segs[:, picks].to(torch.bfloat16).float()
    codes = _assign_chunked(segs, cb, max(256, (1 << 26) // (m * 256)))
    codes = codes.T.to(torch.uint8).contiguous()
    dec = quantized._pq_decode(codes, cb, d)
    return codes, cb.to(torch.bfloat16).contiguous(), (dec * dec).sum(1)


_ROTATIONS: dict = {}


def rq_inputs(x: torch.Tensor, q: torch.Tensor):
    """RQ planes of the rows ``x`` [n, d] and the rotated queries: the
    quantizer's seeded rotation (``RotationalQuantizer.fit``), the rows
    rotated and encoded on the card with its per-row affine rule. ->
    (q_rot, (codes, lower, step, dec_sqnorms))."""
    d = x.shape[1]
    if d not in _ROTATIONS:
        rq = RotationalQuantizer(d, "l2-squared")
        rq.fit(None)
        _ROTATIONS[d] = torch.from_numpy(rq.rotation).to(x.device)
    rot = _ROTATIONS[d]
    pad = rot.shape[0] - d
    r = torch.nn.functional.pad(x, (0, pad)) @ rot
    lo, hi = r.min(1).values, r.max(1).values
    st = torch.clamp(hi - lo, min=1e-12) / 255.0
    c = torch.clamp(torch.round((r - lo[:, None]) / st[:, None]), 0, 255)
    dec = lo[:, None] + st[:, None] * c
    return ((torch.nn.functional.pad(q, (0, pad)) @ rot).contiguous(),
            (c.to(torch.uint8).contiguous(), lo.contiguous(), st.contiguous(),
             (dec * dec).sum(1)))


def code_case(out: dict, tag: str, tally: str, kernel, plain, near) -> None:
    """A Q2/Q3/Q4 search against its plain version: ``compare``'s tolerance,
    its equal ids counted under ``tally``."""
    kd, ki = kernel()
    pd, pi = plain()
    torch.cuda.synchronize()
    e, same, total = compare(kd, ki, pd, pi, near)
    out[f"{tag}_cases"] += 1
    out[f"{tag}_max_abs_err"] = max(out[f"{tag}_max_abs_err"], e)
    out[f"{tally}_same"] += same
    out[f"{tally}_total"] += total


def masked_near(dist_fn, mask):
    """``near`` for ``compare``: the plain distance of each returned id,
    MASK_DISTANCE for a masked row, inf for id -1."""
    def near(ids):
        safe = ids.clamp(min=0)
        dist = torch.where(mask[safe.long()], dist_fn(safe), MASK_DISTANCE)
        return torch.where(ids < 0, float("inf"), dist)

    return near


def quant_case(gen, out: dict, b: int, n: int, d: int, fetch: int, masked,
               metric: str, tally: str = "q2", segments: int = 8) -> None:
    """One Q1-Q4 case on seeded rows: Q1 equal to its plain version in
    every id and distance, Q2, Q3 (``segments`` as ``pq_segments`` takes
    them) and Q4 as ``compare`` holds K1 (ATOL + RTOL * |plain|, ids equal
    outside near ties), their equal ids counted under ``tally`` with
    "q2" swapped for "q3" and "q4"."""
    dev = torch.device("cuda")
    x = torch.randn(n, d, generator=gen, device=dev)
    q = (x[torch.randint(0, n, (b,), generator=gen, device=dev)]
         + 0.1 * torch.randn(b, d, generator=gen, device=dev))
    if masked == "split1":
        mask = torch.rand(n, generator=gen, device=dev) >= 0.01
        for kind in ("bq", "sq"):  # the second split of either scan
            plan = quantized.device_plan(kind, b, n, fetch, dev)
            if plan.splits < 2:
                raise AssertionError(f"{kind} plan {plan} has one split")
            mask[plan.split_rows:2 * plan.split_rows] = False
    else:
        mask = torch.rand(n, generator=gen, device=dev) >= masked
    if int(mask.sum()) < fetch:
        out["fetch_over_live"] += 1
    # Q1: exact
    bq = BinaryQuantizer(d, "l2-squared")
    enc = bq.encode_device(x)
    qp = bq.encode_device(q)["packed"].contiguous()
    pd, pi = quantized._bq_search_plain(qp, enc["packed"], enc["popcount"],
                                        mask, d, fetch)
    kd, ki = quantized.bq_search_cuda(qp, enc["packed"], enc["popcount"],
                                      mask, d, fetch)
    torch.cuda.synchronize()
    if not (torch.equal(kd, pd) and torch.equal(ki, pi)):
        raise AssertionError(
            f"Q1 differs from its plain version: B={b} D={d} N={n} "
            f"fetch={fetch} masked={masked}")
    out["q1_cases"] += 1
    # Q2: within the tolerance, ids equal outside near ties
    if metric != "l2-squared":
        x, q = normalize(x), normalize(q)
    sq, (codes, dsq) = sq_inputs(x, metric)
    q = q.contiguous()
    code_case(out, "q2", tally, lambda: quantized.sq_search_cuda(
        q, codes, dsq, sq.a, sq.s, mask, metric, fetch),
        lambda: quantized._sq_search_plain(q, codes, dsq, sq.a, sq.s, mask,
                                           metric, fetch),
        masked_near(lambda ids: quantized.sq_gather_distance(
            q, codes, ids, dsq, sq.a, sq.s, metric), mask))
    # Q3 on the same rows and queries
    m = pq_segments(d, segments)
    pcodes, cb, pdsq = pq_inputs(gen, x, m)
    code_case(out, "q3", tally.replace("q2", "q3"),
              lambda: quantized.pq_search_cuda(q, pcodes, cb, pdsq, mask,
                                               metric, fetch),
              lambda: quantized._pq_search_plain(q, pcodes, cb, pdsq, mask,
                                                 metric, fetch),
              masked_near(lambda ids: quantized.pq_gather_distance(
                  q, pcodes, cb, ids, pdsq, metric), mask))
    out["seen"]["dsub"].add(d // m)
    del pcodes, cb, pdsq
    # Q4 on the same rows, rotated
    q_rot, (rcodes, lo, st, rdsq) = rq_inputs(x, q)
    code_case(out, "q4", tally.replace("q2", "q4"),
              lambda: quantized.rq_search_cuda(q_rot, rcodes, lo, st, rdsq,
                                               mask, metric, fetch),
              lambda: quantized._rq_search_plain(q_rot, rcodes, lo, st, rdsq,
                                                 mask, metric, fetch),
              masked_near(lambda ids: quantized.rq_gather_distance(
                  q_rot, rcodes, ids, lo, st, rdsq, metric), mask))


def quant_kernel_grid(seed: int) -> dict:
    """Q1-Q4 against their plain versions over Q_BS x Q_DIMS x Q_FETCH,
    the masked share alternating, the code scans cycling their three
    metrics and Q3 its segments, then the selection's edges (Q_EDGES, and
    Q3_EDGES): Q1 equal in every id and distance, Q2, Q3 and Q4 as
    ``compare`` holds K1. Their ids agree on MIN_ID_AGREEMENT of the grid's
    slots and on MIN_ID_AGREEMENT_Q2_EDGES of the edges' (the three share
    Q2's bf16 product), every differing id a near tie in both."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(seed + 11)
    out = {"q1_cases": 0, "fetch_over_live": 0,
           "q2_tolerance": {"atol": ATOL, "rtol": RTOL,
                            "min_id_agreement": MIN_ID_AGREEMENT,
                            "edges_min_id_agreement":
                                MIN_ID_AGREEMENT_Q2_EDGES},
           "seen": {"b": set(), "d": set(), "fetch": set(), "masked": set(),
                    "metric": set(), "edge": set(), "dsub": set()}}
    for tag in ("q2", "q3", "q4"):
        out.update({f"{tag}_cases": 0, f"{tag}_max_abs_err": 0.0,
                    f"{tag}_same": 0, f"{tag}_total": 0,
                    f"{tag}_edge_same": 0, f"{tag}_edge_total": 0})
    grid = [(b, d, f) for b in Q_BS for d in Q_DIMS for f in Q_FETCH]
    for i, (b, d, fetch) in enumerate(grid):
        n = Q_FEW_ROWS if i % 6 == 5 else Q_ROWS
        masked = Q_MASKED[i % 2]
        metric = quantized.SQ_METRICS[i % 3]
        quant_case(gen, out, b, n, d, fetch, masked, metric,
                   segments=Q3_SEGMENTS[(i // 4 + i // 12) % 3])
        for key, v in (("b", b), ("d", d), ("fetch", fetch),
                       ("masked", masked), ("metric", metric)):
            out["seen"][key].add(v)
    edges = [e + (16,) for e in Q_EDGES] + list(Q3_EDGES)
    for i, (name, b, n, d, fetch, masked, segments) in enumerate(edges):
        quant_case(gen, out, b, n, d, fetch, masked,
                   quantized.SQ_METRICS[i % 3], "q2_edge", segments=segments)
        out["seen"]["edge"].add(name)
    if (out["seen"]["b"] != set(Q_BS) or out["seen"]["d"] != set(Q_DIMS)
            or out["seen"]["fetch"] != set(Q_FETCH)
            or out["seen"]["masked"] != set(Q_MASKED)
            or out["seen"]["metric"] != set(quantized.SQ_METRICS)
            or out["seen"]["edge"] != {e[0] for e in edges}
            or not {3, 4, 6, 16}.issubset(out["seen"]["dsub"])
            or not out["fetch_over_live"]):
        raise AssertionError(f"the Q1-Q4 grid left a case out: {out}")
    for tag in ("q2", "q3", "q4"):
        grid_a = out[f"{tag}_same"] / max(1, out[f"{tag}_total"])
        edge_a = out[f"{tag}_edge_same"] / max(1, out[f"{tag}_edge_total"])
        out[f"{tag}_id_agreement"] = grid_a
        out[f"{tag}_edge_id_agreement"] = edge_a
        if grid_a < MIN_ID_AGREEMENT or edge_a < MIN_ID_AGREEMENT_Q2_EDGES:
            raise AssertionError(
                f"{tag.upper()} id agreement {grid_a} (grid), {edge_a} "
                "(edges)")
    out["seen"] = {k: sorted(map(str, v)) for k, v in out["seen"].items()}
    return out


# B2 grid: graphs the port builds on the card (rows, widths D, M = half of
# M0), the walks' metrics, beams and batches
B2_ROWS = 20_000
B2_DIMS = (25, 99, 128, 768)
B2_M = (16, 32)
B2_METRICS = (("l2-squared", "fp32"), ("dot", "fp32"), ("dot", "bf16"),
              ("cosine", "fp32"), ("cosine", "bf16"), ("manhattan", "fp32"),
              ("hamming", "fp32"))
B2_EFS = (16, 64, 128, 512)
B2_BS = (1, 8, 64, 256)
# the filtered walks of the grid: allowed fractions, kept tracks, two-hop
# budgets (the planner's 0-4), and beams at least as wide as the track
B2_SELECTIVITY = (0.01, 0.1, 0.5)
B2_KEEP = (8, 32)
B2_EXPAND = (0, 1, 2, 3, 4)
B2_FILTERED_EFS = (64, 128, 512)
B2_FILTERED_PER_GRAPH = 3
# the code walks' metrics (a BQ walk has no metric: hamming over sign bits)
B2_SQ_METRICS = ("l2-squared", "dot", "cosine")
B2_QUANT_KINDS = ("bq", "sq", "pq", "rq")
# B2-BQ at every beam pad, unfiltered and filtered (10% allowed, a kept
# track of up to 32, expand 1), on the graphs of these (D, M): M0 64 (the
# frontier past a warp) and the cell's 768-d at M0 32
B2_BQ_PADS = tuple((ef, f) for ef in (16, 64, 128, 512) for f in (0, 1))
B2_BQ_PAD_GRAPHS = ((25, 32), (768, 16))


def quant_walk_inputs(kind: str, metric: str, rows: torch.Tensor,
                      queries: torch.Tensor, segments: int = 0):
    """(scorer, operands, query rep) of a BQ, SQ, PQ or RQ walk over
    ``rows``: BQ packs the sign bits on the card; SQ and RQ fit and encode
    on the host, PQ trains and assigns on the card, as the index does
    (``segments`` its segments, 0 for D/4), with unit rows for dot and
    cosine."""
    d = rows.shape[1]
    dev = rows.device
    if kind == "bq":
        bq = BinaryQuantizer(d, "l2-squared")
        enc = bq.encode_device(rows)
        return (device_beam.BQScorer(d), (enc["packed"], enc["popcount"]),
                bq.encode_device(queries)["packed"].contiguous())
    if metric in ("dot", "cosine"):
        rows, queries = normalize(rows), normalize(queries)
    host = rows.cpu().numpy()
    if kind == "pq":
        pq = ProductQuantizer(d, metric, PQConfig(segments=segments),
                              device=dev)
        pq.fit(host[:20_000])
        enc = pq.encode(host)
        return device_beam.PQScorer(metric), (
            torch.from_numpy(enc["codes"]).to(dev), pq.device_codebooks(dev),
            torch.from_numpy(enc["dec_sqnorm"]).to(dev)), queries.contiguous()
    if kind == "rq":
        rq = RotationalQuantizer(d, metric)
        rq.fit(host[:20_000])
        enc = rq.encode(host)
        return device_beam.RQScorer(metric), tuple(
            torch.from_numpy(enc[f]).to(dev)
            for f in ("codes", "lower", "step", "dec_sqnorm")), rq.prep(
                queries.cpu().numpy(), dev).contiguous()
    sq = ScalarQuantizer(d, metric)
    sq.fit(host[:20_000])
    enc = sq.encode(host)
    operands = (torch.from_numpy(enc["codes"]).to(dev),
                torch.from_numpy(enc["dec_sqnorm"]).to(dev), sq.a, sq.s)
    return device_beam.SQScorer(metric), operands, queries.contiguous()


def b2_operands(metric: str, rows: torch.Tensor) -> torch.Tensor:
    """The corpus (or queries) a metric walks: unit rows for dot and cosine,
    coarse integer rows for hamming (so dimensions match often), raw rows
    otherwise."""
    if metric in ("dot", "cosine"):
        return normalize(rows).contiguous()
    if metric == "hamming":
        return torch.round(rows * 2.0).contiguous()
    return rows.contiguous()


def compare_walks(kernel, plain, agreement_min: float):
    """B2 against its plain version, [b, ef] ids and distances: the ids agree
    on at least ``agreement_min`` of the slots, and the distances of the
    slots whose ids agree are within ATOL + RTOL * |plain|. Returns (max abs
    error, equal slots, slots)."""
    (ki, kd), (pi, pd) = kernel, plain
    same = ki == pi
    agree = float(same.float().mean())
    if agree < agreement_min:
        raise AssertionError(f"B2 ids agree on {agree} < {agreement_min}")
    live = same & (pi >= 0)
    err = (kd - pd).abs()
    if bool((err[live] > ATOL + RTOL * pd.abs()[live]).any()):
        raise AssertionError(f"B2 distances differ: max {err[live].max()}")
    return (float(err[live].max()) if bool(live.any()) else 0.0,
            int(same.sum()), same.numel())


def check_kept(kernel, plain, allow, present, agreement_min):
    """The kept tracks of a filtered walk: ids and distances as
    ``compare_walks``; every kept id allowed and present."""
    out = compare_walks(kernel, plain, agreement_min)
    ids = kernel[0][kernel[0] >= 0].long()
    if not bool(allow[ids].all()) or not bool(present[ids].all()):
        raise AssertionError("B2 kept a disallowed or absent node")
    return out


# code rows at the edges of the kernel's staged paths: (name, row type,
# metric, rows, D, PQ segments, M0, batch, ef, (allowed, keep_k, expand))
CODE_EDGES = (
    # the widest SQ walk the wrapper admits: 4,096 codes a row, a frontier
    # of 640 and a kept track of 512, many staging chunks a hop
    ("sq_widest", "sq", "l2-squared", 2_048, 4096, 0, 128, 2, 512,
     (0.5, 512, 4)),
    # config 3's widths: 96 codes into 16-d centroids, the ADC table
    ("pq_96x16", "pq", "l2-squared", 4_096, 1536, 96, 32, 256, 128, None),
    ("pq_96x16_kept", "pq", "dot", 4_096, 1536, 96, 32, 64, 128,
     (0.45, 32, 1)),
    # 384 x 256 float32 is past a block's shared memory: no table, the
    # chunk's centroid pieces gathered
    ("pq_384x4_gather", "pq", "l2-squared", 4_096, 1536, 384, 32, 64, 64,
     (0.1, 8, 2)),
)


def code_edge_walks(seed: int) -> dict:
    """B2's code rows at ``CODE_EDGES`` against the plain walk, on seeded
    random graphs made on the card (every node present, no upper layers),
    the rows encoded by the port's quantizers, at MIN_ID_AGREEMENT_BF16 and
    ATOL/RTOL (beam and kept track)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 8)
    out = {}
    for name, kind, metric, n, d, segs, m0, b, ef, flt in CODE_EDGES:
        rows = torch.randn(n, d, device=dev, generator=gen)
        scorer, ops, q = quant_walk_inputs(
            kind, metric, rows,
            rows[:b] + 0.1 * torch.randn(b, d, device=dev, generator=gen),
            segs)
        adj = torch.randint(0, n, (n, m0), device=dev, generator=gen,
                            dtype=torch.int32)
        present = torch.ones(n, dtype=torch.bool, device=dev)
        eps = torch.randint(0, n, (b,), device=dev, generator=gen,
                            dtype=torch.int32)
        kw = {}
        if flt:
            kw = dict(allow=torch.rand(n, device=dev, generator=gen) < flt[0],
                      keep_k=flt[1], expand=flt[2])
        args = (scorer, q, ops, adj, present, eps,
                *device_beam._empty_upper(dev), ef, 4 * ef + 64)
        stats = torch.zeros((b, len(device_beam.STATS)), dtype=torch.int32,
                            device=dev)
        kernel = device_beam.fused_search_cuda(*args, **kw, stats=stats)
        plain = device_beam._fused_search(*args, **kw)
        torch.cuda.synchronize()
        err, same, total = compare_walks(kernel[:2], plain[:2],
                                         MIN_ID_AGREEMENT_BF16)
        if flt:
            ek, sk, tk = check_kept(kernel[2:], plain[2:], kw["allow"],
                                    present, MIN_ID_AGREEMENT_BF16)
            err, same, total = max(err, ek), same + sk, total + tk
        out[name] = {"rows": n, "dims": d, "segments": segs, "m0": m0,
                     "frontier": m0 * (1 + (flt[2] if flt else 0)),
                     "b": b, "ef": ef, "keep_k": flt[1] if flt else 0,
                     "max_abs_err": err, "id_agreement": same / total,
                     "steps_max": int(stats[:, 0].max()),
                     "scored_mean": float(stats[:, 1].float().mean())}
        del rows, ops, adj, kernel, plain
    torch.cuda.empty_cache()
    return out


def beam_kernel_grid(seed: int) -> dict:
    """B2 against its plain version on the card. One graph per (D, M) from
    the port's own build (``HNSWIndex`` with the fused walk, 2% deleted:
    tombstones stay traversable); every other graph also loses 1% of its
    nodes (absent: present False). Each graph walks every metric, cycling
    the beam, the batch, and with or without the upper layers; then three
    filtered walks (an allow mask of 1%, 10% or 50%, a kept track of 8 or
    32, a two-hop budget of 0-4), whose beam and kept track are both held
    against the plain version; one more walk per graph stops after 5
    expansions (max_steps binds), filtered on every other graph."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed + 5)
    cases, max_err, same, total, builds = 0, 0.0, 0, 0, 0.0
    seen = {"ef": set(), "b": set(), "metric": set(), "upper": set(),
            "absent": set(), "selectivity": set(), "keep_k": set(),
            "expand": set(), "max_steps_binds": 0}
    case = fcase = 0
    # the quantized walks draw from their own generator: the raw walks'
    # graphs and masks stay those of the stream above
    qrng = np.random.default_rng(seed + 6)
    crng = np.random.default_rng(seed + 7)  # PQ and RQ walks
    quant = {"bq_cases": 0, "bq_slots_equal": 0, "bq_pads": set()}
    for kind in B2_QUANT_KINDS[1:]:
        quant.update({f"{kind}_cases": 0, f"{kind}_max_abs_err": 0.0,
                      f"{kind}_same": 0, f"{kind}_total": 0,
                      f"{kind}_metrics": set(), f"{kind}_filtered": 0})
    for gi, (d, m) in enumerate((d, m) for d in B2_DIMS for m in B2_M):
        rows = rng.standard_normal((B2_ROWS, d), dtype=np.float32)
        t0 = time.perf_counter()
        idx = HNSWIndex(d, HNSWIndexConfig(
            distance="l2-squared", precision="fp32", max_connections=m,
            ef_construction=64, ef=64, device_beam=True, insert_batch=4096,
            initial_capacity=B2_ROWS))
        idx.add_batch(np.arange(B2_ROWS), rows)
        idx.delete(np.arange(0, B2_ROWS, 50))
        builds += time.perf_counter() - t0
        graph = idx.graph
        absent = gi % 2 == 1
        if absent:
            graph = HostGraph.from_arrays(idx.graph.to_arrays())
            gone = np.arange(7, B2_ROWS, 97)
            graph.levels[gone[gone != graph.entrypoint]] = -1
        mirror = device_beam.DeviceAdjacency(graph, dev)
        adj, present = mirror.sync()
        ua, us = mirror.sync_upper()
        if ua.shape[0] == 0:
            raise AssertionError("a grid graph has no upper layers")
        base = torch.from_numpy(rows).to(dev)
        noise = torch.from_numpy(
            rng.standard_normal((max(B2_BS), d), dtype=np.float32)).to(dev)
        walks = [(metric, prec, B2_EFS[(case + i) % 4],
                  B2_BS[((case + i) // 4) % 4], (case + i) % 2 == 0, None,
                  None)
                 for i, (metric, prec) in enumerate(B2_METRICS)]
        for i in range(fcase, fcase + B2_FILTERED_PER_GRAPH):
            metric, prec = B2_METRICS[i % len(B2_METRICS)]
            walks.append((metric, prec, B2_FILTERED_EFS[(i // 3) % 3],
                          B2_BS[(i // 2) % 4], i % 2 == 1, None,
                          (B2_SELECTIVITY[i % 3], B2_KEEP[i % 2],
                           B2_EXPAND[i % 5])))
        fcase += B2_FILTERED_PER_GRAPH
        walks.append(("l2-squared", "fp32", 64, 64, True, 5,
                      (0.1, 32, 2) if absent else None))
        for metric, prec, ef, b, upper, steps, flt in walks:
            corpus = b2_operands(metric, base)
            q = b2_operands(metric, base[:b] + 0.1 * noise[:b])
            eps = torch.full((b,), graph.entrypoint, dtype=torch.int32,
                             device=dev)
            up = (ua, us) if upper else device_beam._empty_upper(dev)
            max_steps = steps if steps else 4 * ef + 64
            scorer = device_beam.RawScorer(metric, prec)
            kw = {}
            if flt:
                sel, keep, expand = flt
                kw = dict(allow=torch.from_numpy(
                    rng.random(adj.shape[0]) < sel).to(dev), keep_k=keep,
                    expand=expand)
            kernel = device_beam.fused_search_cuda(
                scorer, q, (corpus,), adj, present, eps, *up, ef, max_steps,
                **kw)
            plain = device_beam._fused_search(
                scorer, q, (corpus,), adj, present, eps, *up, ef, max_steps,
                **kw)
            torch.cuda.synchronize()
            agreement = (MIN_ID_AGREEMENT_BF16 if prec == "bf16"
                         else MIN_ID_AGREEMENT)
            e, s_, t = compare_walks(kernel[:2], plain[:2], agreement)
            if flt:
                ek, sk, tk = check_kept(kernel[2:], plain[2:], kw["allow"],
                                        present, agreement)
                e, s_, t = max(e, ek), s_ + sk, t + tk
                seen["selectivity"].add(flt[0])
                seen["keep_k"].add(flt[1])
                seen["expand"].add(flt[2])
            if bool(((kernel[0] >= 0) & ~present[kernel[0].clamp(min=0).long()]
                     ).any()):
                raise AssertionError("B2 returned an absent node")
            if steps:
                full = device_beam.fused_search_cuda(
                    scorer, q, (corpus,), adj, present, eps, *up, ef,
                    4 * ef + 64, **kw)
                if torch.equal(full[0], kernel[0]):
                    raise AssertionError("max_steps did not bind")
                seen["max_steps_binds"] += 1
            max_err = max(max_err, e)
            same += s_
            total += t
            cases += 1
            if not flt:
                seen["ef"].add(ef)
                seen["b"].add(b)
            seen["metric"].add(f"{metric}/{prec}")
            seen["upper"].add(upper)
            seen["absent"].add(absent)
        # the quantized scorers on the same graph: BQ, SQ, PQ and RQ code
        # planes of its rows, filtered on every other graph; PQ with D/4
        # segments on even graphs, D/16 on odd ones
        for ki, kind in enumerate(B2_QUANT_KINDS):
            metric = B2_SQ_METRICS[(gi + ki // 2) % len(B2_SQ_METRICS)]
            b = B2_BS[(gi + ki) % len(B2_BS)]
            ef = B2_EFS[(gi + 2 * ki) % len(B2_EFS)]
            scorer, operands, q = quant_walk_inputs(
                kind, metric, base, base[:b] + 0.1 * noise[:b],
                0 if gi % 2 == 0 else max(1, d // 16))
            eps = torch.full((b,), graph.entrypoint, dtype=torch.int32,
                             device=dev)
            kw = {}
            if gi % 2:
                kw = dict(allow=torch.from_numpy(
                    (qrng if ki < 2 else crng).random(adj.shape[0]) < 0.1).to(
                        dev), keep_k=32, expand=1 + gi % 4)
            kernel = device_beam.fused_search_cuda(
                scorer, q, operands, adj, present, eps, ua, us, ef,
                4 * ef + 64, **kw)
            plain = device_beam._fused_search(
                scorer, q, operands, adj, present, eps, ua, us, ef,
                4 * ef + 64, **kw)
            torch.cuda.synchronize()
            if kind == "bq":
                # integer distances: the walk is the plain version's exactly
                for kt, pt in zip(kernel, plain):
                    if not torch.equal(kt, pt):
                        raise AssertionError("the BQ walk differs from its "
                                             "plain version")
                quant["bq_cases"] += 1
                quant["bq_slots_equal"] += sum(t.numel() for t in kernel[::2])
                continue
            e, s_, t = compare_walks(kernel[:2], plain[:2],
                                     MIN_ID_AGREEMENT_BF16)
            if kw:
                ek, sk, tk = check_kept(kernel[2:], plain[2:], kw["allow"],
                                        present, MIN_ID_AGREEMENT_BF16)
                e, s_, t = max(e, ek), s_ + sk, t + tk
                quant[f"{kind}_filtered"] += 1
            quant[f"{kind}_cases"] += 1
            quant[f"{kind}_max_abs_err"] = max(quant[f"{kind}_max_abs_err"],
                                               e)
            quant[f"{kind}_same"] += s_
            quant[f"{kind}_total"] += t
            quant[f"{kind}_metrics"].add(metric)
        if (d, m) in B2_BQ_PAD_GRAPHS:
            scorer, operands, q = quant_walk_inputs(
                "bq", "l2-squared", base, base[:64] + 0.1 * noise[:64])
            eps = torch.full((64,), graph.entrypoint, dtype=torch.int32,
                             device=dev)
            for ef, filtered in B2_BQ_PADS:
                kw = dict(allow=torch.from_numpy(
                    qrng.random(adj.shape[0]) < 0.1).to(dev),
                    keep_k=min(32, ef), expand=1) if filtered else {}
                kernel = device_beam.fused_search_cuda(
                    scorer, q, operands, adj, present, eps, ua, us, ef,
                    4 * ef + 64, **kw)
                plain = device_beam._fused_search(
                    scorer, q, operands, adj, present, eps, ua, us, ef,
                    4 * ef + 64, **kw)
                torch.cuda.synchronize()
                for kt, pt in zip(kernel, plain):
                    if not torch.equal(kt, pt):
                        raise AssertionError(
                            f"the BQ walk differs from its plain version at "
                            f"ef {ef}, filtered {bool(filtered)}, D {d}, M {m}")
                quant["bq_cases"] += 1
                quant["bq_slots_equal"] += sum(t.numel() for t in kernel[::2])
                quant["bq_pads"].add((ef, filtered))
        case += len(B2_METRICS)
        del idx, mirror, adj, present, ua, us, base, noise
        torch.cuda.empty_cache()
    if seen["ef"] != set(B2_EFS) or seen["b"] != set(B2_BS) \
            or len(seen["metric"]) != len(B2_METRICS) \
            or seen["upper"] != {True, False} \
            or seen["absent"] != {True, False} \
            or seen["selectivity"] != set(B2_SELECTIVITY) \
            or seen["keep_k"] != set(B2_KEEP) \
            or seen["expand"] != set(B2_EXPAND):
        raise AssertionError(f"the B2 grid left a case out: {seen}")
    # what the kernel does not take, it refuses before launching
    raised = 0
    z = torch.zeros((64, 8), device=dev)
    for over in (dict(ef=1024), dict(adjacency=torch.full(
            (64, 256), -1, dtype=torch.int32, device=dev)),
            dict(allow=torch.ones(64, dtype=torch.bool, device=dev),
                 keep_k=32)):
        args = dict(scorer=device_beam.RawScorer("l2-squared", "fp32"),
                    queries=z[:2], operands=(z,),
                    adjacency=torch.full((64, 8), -1, dtype=torch.int32,
                                         device=dev),
                    present=torch.ones(64, dtype=torch.bool, device=dev),
                    eps=torch.zeros(2, dtype=torch.int32, device=dev),
                    upper_adj=device_beam._empty_upper(dev)[0],
                    upper_slots=device_beam._empty_upper(dev)[1], ef=16,
                    max_steps=8)
        args.update(over)
        try:
            device_beam.fused_search_cuda(**args)
        except ValueError:
            raised += 1
    if raised != 3:
        raise AssertionError("B2 launched on arguments outside its contract")
    # the widest walk the wrapper admits, the kernel takes: its shared
    # memory (checked by the C side against the card's) fits a block
    dm, wm, em = device_beam.MAX_DIMS, device_beam.MAX_WIDTH, device_beam.MAX_EF
    wide = (device_beam.RawScorer("l2-squared", "fp32"),
            torch.randn((2, dm), device=dev),
            (torch.randn((64, dm), device=dev),),
            torch.cat([torch.rand((64, 64), device=dev).argsort(1)[:, :16],
                       torch.full((64, wm - 16), -1, device=dev)],
                      1).int().contiguous(),
            torch.ones(64, dtype=torch.bool, device=dev),
            torch.zeros(2, dtype=torch.int32, device=dev),
            *device_beam._empty_upper(dev), em, 4 * em + 64)
    wkw = dict(allow=torch.arange(64, device=dev) % 2 == 0, keep_k=em,
               expand=device_beam.MAX_FRONTIER // wm - 1)
    kernel = device_beam.fused_search_cuda(*wide, **wkw)
    plain = device_beam._fused_search(*wide, **wkw)
    torch.cuda.synchronize()
    e, s_, t = compare_walks(kernel[:2], plain[:2], MIN_ID_AGREEMENT)
    ek, sk, tk = check_kept(kernel[2:], plain[2:], wkw["allow"], wide[4],
                            MIN_ID_AGREEMENT)
    max_err, same, total = max(max_err, e, ek), same + s_ + sk, total + t + tk
    cases += 1
    if quant["bq_pads"] != set(B2_BQ_PADS):
        raise AssertionError(f"the BQ walks left a pad out: {quant}")
    quant["bq_pads"] = sorted(quant["bq_pads"])
    for kind in B2_QUANT_KINDS[1:]:
        if quant[f"{kind}_metrics"] != set(B2_SQ_METRICS) \
                or not quant[f"{kind}_filtered"]:
            raise AssertionError(f"the {kind} walks left a metric or the "
                                 f"filtered walk out: {quant}")
        quant[f"{kind}_id_agreement"] = (quant[f"{kind}_same"]
                                         / max(1, quant[f"{kind}_total"]))
        quant[f"{kind}_metrics"] = sorted(quant[f"{kind}_metrics"])
    return {"cases": cases,
            "quantized_walks": quant,
            "code_row_edges": code_edge_walks(seed),
            "filtered_cases": fcase + len(B2_DIMS) * len(B2_M) // 2,
            "graphs": len(B2_DIMS) * len(B2_M),
            "graph_rows": B2_ROWS, "graph_build_s": builds,
            "max_abs_err": max_err, "id_agreement": same / max(1, total),
            "max_steps_binds": seen["max_steps_binds"],
            "raised_as_expected": raised,
            "min_id_agreement": {"fp32": MIN_ID_AGREEMENT,
                                 "bf16": MIN_ID_AGREEMENT_BF16}}


def recall(ids, gt: np.ndarray) -> float:
    k = gt.shape[1]
    return float(np.mean([len(set(ids[r]) & set(gt[r])) / k
                          for r in range(len(gt))]))


def phase_main(seed: int, state: dict) -> dict:
    torch.cuda.reset_peak_memory_stats()
    idx = FlatIndex(DIMS, FlatIndexConfig(
        distance="l2-squared", precision="bf16", flat_approx_recall=0.99))
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    chunks = []
    for s in range(0, ROWS, INGEST_BATCH):
        n = min(INGEST_BATCH, ROWS - s)
        chunks.append(rng.standard_normal((n, DIMS), dtype=np.float32))
        idx.add_batch(np.arange(s, s + n), chunks[-1])
    head = chunks[0][:BATCH].copy()
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    deleted = rng.choice(ROWS, ROWS // 100, replace=False)
    idx.delete(deleted)
    queries = head + 0.1 * rng.standard_normal((BATCH, DIMS), dtype=np.float32)

    # exact float32 ground truth: TF32 off, so the product is full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    corpus, valid, sqn = idx.store.snapshot()
    qt = torch.from_numpy(queries).cuda()
    t0 = time.perf_counter()
    gt_d, gt_i = flat_search(qt, corpus, K, "l2-squared", valid_mask=valid,
                             corpus_sqnorms=sqn, chunk_size=131072,
                             precision="fp32")
    gt_i = gt_i.cpu().numpy()
    gt_s = time.perf_counter() - t0
    # the ground truth itself against float64 on 16 queries
    q64 = qt[:16].double()
    c64 = corpus.double()
    d64 = ((q64 * q64).sum(1, keepdim=True) - 2.0 * q64 @ c64.T
           + (c64 * c64).sum(1)[None, :])
    d64 = torch.where(valid[None, :], d64, float("inf"))
    del c64
    g64 = torch.gather(d64, 1, torch.from_numpy(gt_i[:16]).cuda().long())
    ref64 = torch.sort(d64, dim=1).values[:, :K]
    del d64
    if not bool(((g64 - ref64).abs() <= ATOL + RTOL * ref64.abs()).all()):
        raise AssertionError("float32 ground truth disagrees with float64")

    # the served path: FlatIndex.search through the fused kernel
    fused_flat.reset_launches()
    res = idx.search(queries, K)
    launches = fused_flat.fused_flat_topk.launches
    by_variant = dict(fused_flat.fused_flat_topk.launches_by_variant)
    if launches < 1:
        raise AssertionError("FlatIndex.search did not launch the kernel")
    if by_variant[MAIN_VARIANT] != launches:
        raise AssertionError(
            f"FlatIndex.search launched {by_variant}, not {MAIN_VARIANT}")
    rec = recall(res.ids, gt_i)
    if rec < 0.95:
        raise AssertionError(f"recall@10 {rec} < 0.95")
    if np.isin(res.ids, deleted).any():
        raise AssertionError("a deleted id came back")

    # exact path: bf16 exact selection, and float32 exact == ground truth
    exact_bf16 = idx.search(queries, K, approx_recall=0.0)
    rec_exact_bf16 = recall(exact_bf16.ids, gt_i)
    exact32 = FlatIndex(DIMS, FlatIndexConfig(
        distance="l2-squared", precision="fp32", flat_approx_recall=0.0))
    exact32.store = idx.store  # same corpus, float32 exact selection
    ex32 = exact32.search(queries, K)
    if not np.array_equal(ex32.ids, gt_i):
        raise AssertionError("float32 exact path differs from ground truth")

    # kernel vs plain at the main path's shapes (the FlatIndex call's args)
    live_rows = fused_flat.bucket_live(idx.store.live_count)
    args = (qt, corpus, sqn, valid, K)
    kw = {"chunk_size": min(idx.config.search_chunk_size, corpus.shape[0]),
          "live_rows": live_rows}
    block, fold = fused_flat.plan(corpus, K, kw["chunk_size"], live_rows)
    variant, plan = fused_flat.kernel_variant(qt, corpus, K, block, fold)
    kv, ki = fused_flat.fused_flat_topk(*args, **kw)
    pv, pi = fused_flat.fused_flat_topk_reference(*args, **kw)
    err, same, total = compare(
        kv, ki, pv, pi, lambda ids: pair_distance(qt, corpus, sqn, valid, ids))
    if not np.array_equal(ki.cpu().numpy(), res.ids):
        raise AssertionError("FlatIndex.search differs from the kernel call")

    kernel_ms = cuda_ms(lambda: fused_flat.fused_flat_topk(*args, **kw), 30, 3)
    blocks_ms = cuda_ms(lambda: fused_flat.block_topk_cuda(
        qt, corpus, sqn, valid, K, block, fold), 30, 3)
    plain_ms = cuda_ms(
        lambda: fused_flat.fused_flat_topk_reference(*args, **kw), 5, 1)
    search_s = []
    for _ in range(100):
        t0 = time.perf_counter()
        idx.search(queries, K)
        search_s.append(time.perf_counter() - t0)
    exact_s = []
    for _ in range(5):
        t0 = time.perf_counter()
        idx.search(queries, K, approx_recall=0.0)
        exact_s.append(time.perf_counter() - t0)
    n_rows, d = corpus.shape
    bytes_moved = (qt.numel() * 4 + corpus.numel() * corpus.element_size()
                   + n_rows * 4 + n_rows * 1 + BATCH * K * 8)
    flops = 2.0 * BATCH * n_rows * d
    bound_ms = max(bytes_moved / HBM_BYTES_S, flops / BF16_FLOP_S) * 1e3
    bound_by = "bytes" if bytes_moved / HBM_BYTES_S >= flops / BF16_FLOP_S \
        else "operations"
    state.update(idx=idx, exact32=exact32, queries=queries, res=res,
                 chunks=chunks, deleted=deleted)
    l2_bytes = l2_bytes_model(variant, plan, BATCH, n_rows, d,
                              corpus.element_size(), block)
    state["kernel"] = {
        "name": "fused_flat_l2_topk", "route": "cuda",
        "source": "weaviate_tpu_torch/csrc/fused_flat.cu",
        "replaces": "weaviate_tpu/ops/pallas_flat.py:104",
        "launches": launches, "max_abs_err": err,
        "ms": float(np.median(kernel_ms)),
        "plain_ms": float(np.median(plain_ms)),
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        "variant": variant,
        "share_of_bound": bound_ms / float(np.median(kernel_ms)),
    }
    return {
        "rows": ROWS, "capacity": n_rows, "dims": d, "batch": BATCH, "k": K,
        "live": idx.store.live_count, "block": block, "fold": fold,
        "ingest_s": ingest_s, "ground_truth_s": gt_s,
        "recall_at_10": rec, "recall_at_10_exact_bf16": rec_exact_bf16,
        "launches": launches, "launches_by_variant": by_variant,
        # an estimate from the design, not a measurement (see the model)
        "variant": variant, "plan": plan, "l2_bytes_model": l2_bytes,
        "kernel_vs_plain_max_abs_err": err,
        "kernel_vs_plain_id_agreement": same / max(1, total),
        "kernel_ms_median": float(np.median(kernel_ms)),
        "kernel_ms_p90": float(np.percentile(kernel_ms, 90)),
        "kernel_blocks_only_ms_median": float(np.median(blocks_ms)),
        "plain_ms_median": float(np.median(plain_ms)),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "bytes": bytes_moved, "flops": flops,
        "search_p50_ms": float(np.percentile(search_s, 50) * 1e3),
        "search_p99_ms": float(np.percentile(search_s, 99) * 1e3),
        "exact_flat_search_ms_median": float(np.median(exact_s) * 1e3),
        "peak_device_bytes": torch.cuda.max_memory_allocated(),
        "card": state["card"],
    }


def phase_warm(state: dict) -> dict:
    idx, exact32 = state["idx"], state["exact32"]
    queries = state["queries"]
    sub = queries[:32]
    freed = idx.demote_device()
    torch.cuda.empty_cache()
    host = exact32.search(sub, K)            # warm tier: host exact path
    charged = idx.promote_device()
    dev = exact32.search(sub, K)             # device float32 exact path
    hv, dv = torch.from_numpy(host.dists), torch.from_numpy(dev.dists)
    if bool(((hv - dv).abs() > ATOL + RTOL * dv.abs()).any()):
        raise AssertionError("warm-tier distances differ from the device's")
    agree = float(np.mean(host.ids == dev.ids))
    if agree < MIN_ID_AGREEMENT:
        raise AssertionError(f"warm-tier ids agree at {agree}")
    again = idx.search(queries, K)           # kernel route after promotion
    if not (np.array_equal(again.ids, state["res"].ids)
            and np.array_equal(again.dists, state["res"].dists)):
        raise AssertionError("kernel route changed across demote/promote")
    return {"freed_bytes": freed, "charged_bytes": charged,
            "host_vs_device_id_agreement": agree}


def _uuids(rng, n: int) -> list[str]:
    """``n`` seeded version-4 uuid strings."""
    raw = rng.bytes(16 * n).hex()
    out = []
    for i in range(0, 32 * n, 32):
        h = raw[i:i + 32]
        out.append(f"{h[:8]}-{h[8:12]}-4{h[13:16]}-8{h[17:20]}-{h[20:]}")
    return out


def db_search(col, queries, flt=None) -> list[list]:
    """Collection.vector_search_batch: rows of (object, distance)."""
    return col.vector_search_batch(queries, K, flt=flt)


def uuid_rows(rows) -> list[list[str]]:
    return [[o.uuid for o, _ in row] for row in rows]


def phase_db(seed: int, state: dict) -> dict:
    """The main path through the user's entry point, on the vectors phase
    main made: ``DB`` -> ``Collection.put_batch`` -> ``Shard`` ->
    ``FlatIndex`` -> the fused kernel, and back through
    ``Collection.vector_search_batch``."""
    rng = np.random.default_rng(seed + 1)
    uuids = _uuids(rng, DB_ROWS)
    uuid_arr = np.array(uuids)
    vocab = np.array(["".join(rng.choice(list("abcdefghijklmnopqrstuvwxyz"),
                                         int(rng.integers(3, 9))))
                      for _ in range(VOCAB)])
    words = rng.integers(0, VOCAB, (DB_ROWS, TEXT_WORDS))
    bucket = np.arange(DB_ROWS) % 100
    queries = state["queries"]
    deleted = state["deleted"][state["deleted"] < DB_ROWS]
    chunks = state.pop("chunks")[: DB_ROWS // INGEST_BATCH]

    # exact float32 ground truths on the index-level store: the first
    # DB_ROWS vectors with the same rows deleted, unfiltered and under the
    # filter bucket == FILTER_BUCKET
    corpus, valid, sqn = state["idx"].store.snapshot()
    qt = torch.from_numpy(queries).cuda()
    head = valid.clone()
    head[DB_ROWS:] = False
    allow = torch.zeros_like(valid)
    allow[:DB_ROWS] = torch.from_numpy(bucket == FILTER_BUCKET).cuda()
    gts = [flat_search(qt, corpus, K, "l2-squared", valid_mask=head,
                       allow_mask=a, corpus_sqnorms=sqn, chunk_size=131072,
                       precision="fp32")[1].cpu().numpy() for a in (None, allow)]
    gt, gt_f = gts
    # free the index-level phases' device memory before the DB's
    for key in ("idx", "exact32", "res"):
        state.pop(key)
    del corpus, valid, sqn, qt, allow, head
    torch.cuda.empty_cache()
    # the index-level answer on the same rows, for the DB's to agree with
    sub = FlatIndex(DIMS, FlatIndexConfig(
        distance="l2-squared", precision="bf16", flat_approx_recall=0.99))
    for i, c in enumerate(chunks):
        sub.add_batch(np.arange(i * INGEST_BATCH, (i + 1) * INGEST_BATCH), c)
    sub.delete(deleted)
    index_ids = sub.search(queries, K).ids
    del sub
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state["db_chunks"] = chunks

    root = tempfile.mkdtemp(prefix="chip_smoke_db_")
    try:
        return _drive_db(state, root, uuids, uuid_arr, vocab, words, bucket,
                         queries, deleted, gt, gt_f, index_ids)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _drive_db(state, root, uuids, uuid_arr, vocab, words, bucket, queries,
              deleted, gt, gt_f, index_ids) -> dict:
    flt = Where.eq("bucket", FILTER_BUCKET)
    db = DB(root)
    col = db.create_collection(CollectionConfig(
        name="Doc",
        properties=[Property("bucket", DataType.INT),
                    Property("text", DataType.TEXT)],
        vector_config=FlatIndexConfig(
            distance="l2-squared", precision="bf16",
            flat_approx_recall=0.99)))
    fused_flat.reset_launches()
    t0 = time.perf_counter()
    row, marks, next_mark = 0, [t0], DB_ROWS // 10
    for chunk in state.pop("db_chunks"):
        for s in range(0, len(chunk), DB_BATCH):
            part = chunk[s:s + DB_BATCH]
            col.put_batch([StorageObject(
                uuid=uuids[row + i], collection="Doc", vector=part[i],
                properties={"bucket": int(bucket[row + i]),
                            "text": " ".join(vocab[words[row + i]])})
                for i in range(len(part))])
            row += len(part)
            if row >= next_mark:
                marks.append(time.perf_counter())
                next_mark += DB_ROWS // 10
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    # objects/s over each tenth of the ingest
    rates = [DB_ROWS // 10 / (b - a) for a, b in zip(marks, marks[1:])]
    t0 = time.perf_counter()
    n_del = col.delete([uuids[i] for i in deleted])
    delete_s = time.perf_counter() - t0
    live = DB_ROWS - len(deleted)
    if n_del != len(deleted) or col.count() != live:
        raise AssertionError(f"deleted {n_del}, count {col.count()}")

    # the served path, launches counted from 0 for this path alone
    rows = db_search(col, queries)
    launches = fused_flat.fused_flat_topk.launches
    if launches < 1:
        raise AssertionError("vector_search_batch did not launch the kernel")
    got = uuid_rows(rows)
    rec = recall(got, uuid_arr[gt])
    if rec < 0.95:
        raise AssertionError(f"DB recall@10 {rec} < 0.95")
    if set(uuid_arr[deleted]) & {u for r in got for u in r}:
        raise AssertionError("a deleted object came back")
    agree = float(np.mean([a == b for r, ir in zip(got, uuid_arr[index_ids])
                           for a, b in zip(r, ir)]))
    if agree < MIN_ID_AGREEMENT:
        raise AssertionError(f"DB and index answers agree at {agree}")
    rows_f = db_search(col, queries, flt)
    got_f = uuid_rows(rows_f)
    if any(o.properties["bucket"] != FILTER_BUCKET
           for r in rows_f for o, _ in r):
        raise AssertionError("the filtered query returned a non-matching object")
    rec_f = recall(got_f, uuid_arr[gt_f])
    if rec_f < 0.95:
        raise AssertionError(f"filtered recall@10 {rec_f} < 0.95")

    # host time by layer: Collection -> Shard -> FlatIndex, and the
    # kernel's device time inside the Collection call (CUDA events)
    shard = next(iter(col._shards.values()))
    index = shard.vector_index()
    real = fused_flat.block_topk_cuda
    events = []

    def timed(*a, **kw):
        b, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        b.record()
        out = real(*a, **kw)
        e.record()
        events.append((b, e))
        return out

    def host_ms(fn, n=50):
        fn()
        out = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            out.append((time.perf_counter() - t0) * 1e3)
        return out

    index_ms = host_ms(lambda: index.search(queries, K))
    shard_ms = host_ms(lambda: shard.vector_search(queries, K))
    fused_flat.block_topk_cuda = timed
    try:
        search_ms = host_ms(lambda: db_search(col, queries))
    finally:
        fused_flat.block_topk_cuda = real
    torch.cuda.synchronize()
    kernel_ms = [b.elapsed_time(e) for b, e in events[1:]]
    filtered_ms = host_ms(lambda: db_search(col, queries, flt), 10)
    # the Collection's own share: reading the 2,560 result objects back
    # from the LSM store, and the filter's allow mask
    doc_ids = index.search(queries, K).ids.reshape(-1)
    fetch_ms = host_ms(lambda: shard.objects_by_docids(doc_ids), 10)
    allow_ms = host_ms(lambda: shard.allow_list(flt), 10)
    compaction_bytes = sum(b.compaction_bytes_written
                           for b in shard.store._buckets.values())
    segments = len(shard.objects._segments)
    peak = torch.cuda.max_memory_allocated()
    disk_bytes = sum(os.path.getsize(os.path.join(d, f))
                     for d, _, fs in os.walk(root) for f in fs)

    t0 = time.perf_counter()
    db.close()
    close_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    db = DB(root)
    col = db.get_collection("Doc")
    recovered = sorted({s.recovered_from for s in col._shards.values()})
    reopen_s = time.perf_counter() - t0
    if col.count() != live:
        raise AssertionError(f"reopened count {col.count()} != {live}")
    if uuid_rows(db_search(col, queries)) != got \
            or uuid_rows(db_search(col, queries, flt)) != got_f:
        raise AssertionError("the reopened DB answers differently")
    db.close()
    state["kernel"]["launches_db"] = launches
    return {
        "rows": DB_ROWS, "deleted": len(deleted), "live": live,
        "batch": BATCH, "k": K, "put_batch": DB_BATCH,
        "ingest_s": ingest_s, "objects_per_s": DB_ROWS / ingest_s,
        "objects_per_s_by_tenth": rates,
        "compaction_bytes_written": compaction_bytes,
        "object_segments": segments,
        "delete_s": delete_s, "close_s": close_s, "reopen_s": reopen_s,
        "recovered_from": recovered, "disk_bytes": disk_bytes,
        "recall_at_10": rec, "recall_at_10_filtered": rec_f,
        "id_agreement_with_index_path": agree, "launches": launches,
        "search_p50_ms": float(np.percentile(search_ms, 50)),
        "search_p99_ms": float(np.percentile(search_ms, 99)),
        "shard_search_p50_ms": float(np.percentile(shard_ms, 50)),
        "flat_index_search_p50_ms": float(np.percentile(index_ms, 50)),
        "filtered_search_p50_ms": float(np.percentile(filtered_ms, 50)),
        "fetch_2560_objects_p50_ms": float(np.percentile(fetch_ms, 50)),
        "filter_allow_list_p50_ms": float(np.percentile(allow_ms, 50)),
        "kernel_ms_median": float(np.median(kernel_ms)),
        "kernel_share_of_search": sum(kernel_ms) / sum(search_ms),
        "peak_device_bytes": peak,
        "card": state["card"],
    }


# phase hnsw: bench.py bench_glove's configuration and data (seed 7, unit
# iid normal 25-d rows, queries = the first 256 rows + 0.08 noise)
# cut 8: config 2's 1,200,000 rows cut to a fixed 262,144, to make room for
# phase rerank within the time limit (PERF.md section 4)
HNSW_ROWS, HNSW_DIMS, HNSW_SEED = 262_144, 25, 7
HNSW_EF, HNSW_EFC, HNSW_M, HNSW_INSERT = 64, 96, 16, 4096
HNSW_ADD_STEP = 100_000
EF_SWEEP = (64, 128, 256, 512)
HNSW_RECALL_TARGET = 0.95  # BASELINE.json: recall@10 >= 0.95
# phase hnsw_db: objects through the DB (the first rows of phase hnsw's)
HNSW_DB_ROWS = 100_000
HNSW_DB_EXTRA = 2_000  # added after the last snapshot: replayed from the log
# a resident filter the planner sends to the filtered beam: 45% of the
# objects, above flat_search_cutoff (40,000) and filter_flat_selectivity
# (0.35); expansion 1; cost 2,048 for the beam against 2,276 to over-fetch
BEAM_FILTER_BUCKETS = 45


def glove_data(n: int):
    """bench.py bench_glove's rows and queries, as float32 numpy."""
    rng = np.random.default_rng(HNSW_SEED)
    corpus = rng.standard_normal((n, HNSW_DIMS), dtype=np.float32)
    corpus /= np.linalg.norm(corpus, axis=1, keepdims=True) + 1e-12
    queries = corpus[:BATCH] + 0.08 * rng.standard_normal(
        (BATCH, HNSW_DIMS)).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True) + 1e-12
    return corpus, queries


def cosine_truth(corpus: torch.Tensor, valid: torch.Tensor,
                 queries: np.ndarray) -> np.ndarray:
    """Exact float32 cosine top-K ids (TF32 off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q = normalize(torch.from_numpy(queries).cuda())
    return flat_search(q, corpus, K, "cosine", valid_mask=valid,
                       chunk_size=262144, precision="fp32")[1].cpu().numpy()


def host_p(fn, n: int) -> list[float]:
    """Host ms of ``fn`` over n calls, after one warm-up."""
    fn()
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def _rows(a) -> int:
    """The query rows of a B2 launch's arguments."""
    return a[1].shape[0]


class KernelSpy:
    """Wraps the kernel wrapper ``module.name`` while installed (B2's by
    default): CUDA events around every call (``times()`` each, ``ms()``
    their sum), the arguments of the last call, and those of the widest
    (the latest of the largest ``width(args)``; none without ``width``). A
    wrapper that counts its launches on the module attribute of its own
    name keeps counting on the spy while it is installed, and the count
    goes back to the wrapper when the spy leaves."""

    def __init__(self, module=device_beam, name: str = "fused_search_cuda",
                 width=_rows):
        self.module, self.name, self.width = module, name, width
        self.events, self.last, self.widest = [], None, None

    def __enter__(self):
        self.real = getattr(self.module, self.name)

        def spy(*a, **kw):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = self.real(*a, **kw)
            e1.record()
            self.events.append((e0, e1))
            self.last = (a, kw)
            if self.width is not None and (
                    self.widest is None
                    or self.width(a) >= self.width(self.widest[0])):
                self.widest = (a, kw)
            return out

        if hasattr(self.real, "launches"):
            spy.launches = self.real.launches
        setattr(self.module, self.name, spy)
        return self

    def __exit__(self, *exc):
        if hasattr(self.real, "launches"):
            self.real.launches = getattr(self.module, self.name).launches
        setattr(self.module, self.name, self.real)

    @property
    def launches(self) -> int:
        return getattr(self.module, self.name).launches

    def times(self) -> list[float]:
        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self.events]

    def ms(self) -> float:
        return sum(self.times())


def scorer_row(scorer, operands) -> tuple[int, int, float]:
    """(bytes, element operations, the peak rate of their type) of one
    scored row of a B2 walk: a float32 row (3 float32 operations an
    element), a BQ row of words and its popcount (AND, popcount and add a
    word, at the float32 rate), an SQ row of byte codes and its decoded
    norm (a multiply-add a code), an RQ row of codes with its norm, lower
    and step, or a PQ row of M codes and its norm (a multiply-add a decoded
    dimension; the codebooks the codes index are read once a walk,
    counted by ``walk_bound``). A code row's products are bf16(q) times a
    value bf16 holds exactly (a byte code, a bf16 centroid) with float32
    sums, so they count at the bf16 rate, as Q2-Q4's do."""
    if isinstance(scorer, device_beam.BQScorer):
        w = operands[0].shape[1]
        return w * 4 + 4, 3 * w, FP32_FLOP_S
    if isinstance(scorer, device_beam.SQScorer):
        d = operands[0].shape[1]
        return d + 4, 2 * d, BF16_FLOP_S
    if isinstance(scorer, device_beam.RQScorer):
        d = operands[0].shape[1]
        return d + 12, 2 * d, BF16_FLOP_S
    if isinstance(scorer, device_beam.PQScorer):
        m, _, dsub = operands[1].shape
        return m + 4, 2 * m * dsub, BF16_FLOP_S
    d = operands[0].shape[1]
    return d * 4, 3 * d, FP32_FLOP_S


def walk_bound(args, kw, stats: torch.Tensor) -> tuple[float, str, dict]:
    """The least time of one B2 launch on this run's data: the bytes the
    walk must move (query rows; each row it scored and kept, by its
    scorer's row type, with its presence and allow bytes; the adjacency
    rows of the hops it expanded and of the second hop's parents; the upper
    rows; the outputs) over the memory rate, against its element operations
    over the peak rate of their type (``scorer_row``). What the kernel moves beyond that by its own
    design is reported beside the bound, in ``overhead_bytes``: the rows it
    scored before the visited test and dropped, and the adjacency rows it
    read ahead for a node the next hop did not expand."""
    scorer, q, operands, adj, present, eps, ua, us, ef, _ = args
    keep_k = kw.get("keep_k", 0) if kw.get("allow") is not None else 0
    st = stats.long().sum(0).tolist()
    m0 = adj.shape[1]
    m = ua.shape[2] if ua.shape[0] else 0
    b = q.shape[0]
    row, ops, rate = scorer_row(scorer, operands)
    row_bytes = row + 1 + (1 if keep_k else 0)
    nbytes = (q.numel() * q.element_size() + st[1] * row_bytes
              + st[2] * m0 * 4 + st[3] * m * 4 + b * (ef + keep_k) * 8)
    extra = {}
    if isinstance(scorer, device_beam.PQScorer):
        # the bf16 codebooks, read once; beside the bound, what the kernel
        # reads of them from L2: each query's ADC table reads them whole,
        # or, where the table does not fit, each scored row gathers its
        # centroids (D bf16 values)
        cb = operands[1]
        nbytes += cb.numel() * 2
        extra = {"codebook_bytes": cb.numel() * 2,
                 "table_build_bytes": b * cb.numel() * 2,
                 "centroid_bytes_gathered_without_table": st[1] * cb.shape[0]
                 * cb.shape[2] * 2}
    flops = float(st[1] * ops)
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / rate
    per_q = stats.float()
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations",
            {"bytes": nbytes, "flops": flops, **extra,
             "overhead_bytes": {"speculative_rows": st[4] * row_bytes,
                                "read_ahead_lost": st[5] * m0 * 4},
             "steps_mean": float(per_q[:, 0].mean()),
             "steps_median": float(per_q[:, 0].median()),
             "steps_max": int(stats[:, 0].max()),
             "scored_mean": float(per_q[:, 1].mean()),
             "speculative_rows_mean": float(per_q[:, 4].mean()),
             "read_ahead_lost_mean": float(per_q[:, 5].mean()),
             "upper_rows_mean": float(per_q[:, 3].mean())})


def time_walk(args, kw, iters: int, plain_iters: int) -> dict:
    """One captured B2 launch: the kernel against its plain version on the
    same inputs (beam, and kept track when filtered), the kernel's and the
    plain version's times, the bound from the kernel's counters."""
    scorer, q, c, adj, present, eps, ua, us, ef, max_steps = args
    stats = torch.zeros((q.shape[0], len(device_beam.STATS)),
                        dtype=torch.int32, device="cuda")
    kernel = device_beam.fused_search_cuda(*args, **kw, stats=stats)
    plain = device_beam._fused_search(*args, **kw)
    torch.cuda.synchronize()
    if isinstance(scorer, device_beam.BQScorer):
        # integer distances: the walk is the plain version's exactly
        if not all(torch.equal(kt, pt) for kt, pt in zip(kernel, plain)):
            raise AssertionError("the BQ walk differs from its plain version")
    agreement = (MIN_ID_AGREEMENT_BF16
                 if isinstance(scorer, (device_beam.SQScorer,
                                        device_beam.PQScorer,
                                        device_beam.RQScorer))
                 else MIN_ID_AGREEMENT)
    err, same, total = compare_walks(kernel[:2], plain[:2], agreement)
    if len(kernel) == 4:
        ek, sk, tk = check_kept(kernel[2:], plain[2:], kw["allow"], present,
                                agreement)
        err, same, total = max(err, ek), same + sk, total + tk
    ms = cuda_ms(lambda: device_beam.fused_search_cuda(*args, **kw), iters, 3)
    # the same launches back to back: the device time without the host's
    # part of each call (its checks, the visited set's allocation)
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        device_beam.fused_search_cuda(*args, **kw)
    t1.record()
    t1.synchronize()
    plain_ms = cuda_ms(lambda: device_beam._fused_search(*args, **kw),
                       plain_iters, 1)
    bound_ms, bound_by, work = walk_bound(args, kw, stats)
    return {"rows": q.shape[0], "ef_pad": ef, "max_steps": max_steps,
            "ms_median": float(np.median(ms)), "ms_max": float(np.max(ms)),
            "ms_back_to_back": t0.elapsed_time(t1) / iters,
            "ms_per_hop": float(np.median(ms)) / max(1, work["steps_max"]),
            "us_per_hop": float(np.median(ms)) * 1e3
            / max(1.0, work["steps_median"]),
            "plain_ms": float(np.median(plain_ms)), "bound_ms": bound_ms,
            "bound_by": bound_by, "work": work, "vs_plain_max_abs_err": err,
            "vs_plain_id_agreement": same / max(1, total)}


def phase_hnsw(state: dict) -> dict:
    """The HNSW index at bench_glove's configuration, B2 on the path."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    corpus, queries = glove_data(HNSW_ROWS)
    state["glove"] = (corpus, queries)
    cfg = HNSWIndexConfig(distance="cosine", ef=HNSW_EF,
                          ef_construction=HNSW_EFC, max_connections=HNSW_M,
                          initial_capacity=HNSW_ROWS, device_beam=True,
                          insert_batch=HNSW_INSERT)
    idx = HNSWIndex(HNSW_DIMS, cfg)
    ids = np.arange(HNSW_ROWS, dtype=np.int64)
    device_beam.fused_search.launches = 0
    t0 = time.perf_counter()
    marks = []
    with KernelSpy() as build_spy:
        for s in range(0, HNSW_ROWS, HNSW_ADD_STEP):
            idx.add_batch(ids[s:s + HNSW_ADD_STEP],
                          corpus[s:s + HNSW_ADD_STEP])
            marks.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_launches = device_beam.fused_search.launches
    if build_launches < 1:
        raise AssertionError("construction did not launch B2")
    build_b2_ms = build_spy.ms()
    store_corpus, valid, _ = idx.store.snapshot()
    gt = cosine_truth(store_corpus, valid, queries)

    # the served path: launches counted from 0 for one search, one launch
    # for the batch
    device_beam.fused_search.launches = 0
    dispatches = device_beam.dispatch_count()
    res = idx.search(queries, K)
    search_launches = device_beam.fused_search.launches
    if search_launches != 1 or device_beam.dispatch_count() - dispatches != 1:
        raise AssertionError(f"HNSWIndex.search made {search_launches} B2 "
                             "launches, not one")
    rec = recall(res.ids, gt)
    search_ms = host_p(lambda: idx.search(queries, K), 50)

    # B2 alone at the main path's shapes: the search's launch, and one
    # construction launch (the build's widest: the rows of a sub-batch that
    # fit the visited budget, ef_construction padded)
    with KernelSpy() as spy:
        idx.search(queries, K)
    args, kw = spy.last
    walk = time_walk(args, kw, 30, 3)
    cargs, ckw = build_spy.widest
    cwalk = time_walk(cargs, ckw, 10, 1)
    del build_spy

    # the host walk on the same index (bench_glove clears the mirror)
    beam = idx._device_beam
    idx._device_beam = None
    try:
        host_res = idx.search(queries, K)
        host_ms = host_p(lambda: idx.search(queries, K), 3)
    finally:
        idx._device_beam = beam
    host_rec = recall(host_res.ids, gt)
    if rec < host_rec - 0.01:
        raise AssertionError(f"fused walk recall {rec} < host walk "
                             f"{host_rec} - 0.01")

    # ef sweep: recall and p50 at each ef; the smallest ef at the target
    sweep = []
    for ef_s in EF_SWEEP:
        idx.config.ef = ef_s
        r = recall(idx.search(queries, K).ids, gt)
        p50 = float(np.percentile(host_p(lambda: idx.search(queries, K), 10),
                                  50))
        sweep.append({"ef": ef_s, "recall_at_10": r, "p50_ms": p50,
                      "qps": BATCH / p50 * 1e3})
    idx.config.ef = HNSW_EF
    at_target = next((x for x in sweep if x["recall_at_10"]
                      >= HNSW_RECALL_TARGET), None)

    # a 1% delete: no deleted id comes back
    rng = np.random.default_rng(HNSW_SEED + 1)
    deleted = rng.choice(HNSW_ROWS, HNSW_ROWS // 100, replace=False)
    idx.delete(deleted)
    after = idx.search(queries, K)
    if np.isin(after.ids, deleted).any():
        raise AssertionError("a deleted id came back from the HNSW index")
    valid_after = idx.store.snapshot()[1]
    rec_after = recall(after.ids, cosine_truth(store_corpus, valid_after,
                                               queries))
    peak = torch.cuda.max_memory_allocated()
    state["kernel_b2"] = {
        "name": "device_beam_search", "route": "cuda",
        "source": "weaviate_tpu_torch/csrc/device_beam.cu",
        "replaces": "weaviate_tpu/ops/device_beam.py:222",
        "launches": build_launches + search_launches,
        "max_abs_err": walk["vs_plain_max_abs_err"],
        "ms": walk["ms_median"], "plain_ms": walk["plain_ms"],
        "bound_ms": walk["bound_ms"], "bound_by": walk["bound_by"],
        "library_ms": None,
        "launches_build": build_launches,
        "launches_per_search": search_launches,
        "share_of_bound": walk["bound_ms"] / walk["ms_median"],
        "us_per_hop": walk["us_per_hop"],
        "construction_launch_ms": cwalk["ms_median"],
        "construction_bound_ms": cwalk["bound_ms"],
        "construction_bound_by": cwalk["bound_by"],
        "construction_us_per_hop": cwalk["us_per_hop"],
        "overhead_bytes": walk["work"]["overhead_bytes"],
    }
    del idx, store_corpus, valid, valid_after, args, kw, cargs, ckw
    torch.cuda.empty_cache()
    return {
        "rows": HNSW_ROWS, "dims": HNSW_DIMS, "metric": "cosine",
        "ef": HNSW_EF, "ef_construction": HNSW_EFC, "max_connections": HNSW_M,
        "insert_batch": HNSW_INSERT, "batch": BATCH, "k": K,
        "build_s": build_s, "vectors_per_s": HNSW_ROWS / build_s,
        "build_s_at_each_100k": marks,
        "b2_launches_build": build_launches,
        "b2_build_ms": build_b2_ms,
        "recall_at_10": rec, "host_walk_recall_at_10": host_rec,
        "search_p50_ms": float(np.percentile(search_ms, 50)),
        "search_p99_ms": float(np.percentile(search_ms, 99)),
        "b2_launches_per_search": search_launches,
        "b2_search_launch": walk,
        "b2_construction_launch": cwalk,
        "host_walk_p50_ms": float(np.percentile(host_ms, 50)),
        "ef_sweep": sweep,
        "smallest_ef_at_recall_0.95": at_target,
        "deleted": len(deleted), "recall_at_10_after_delete": rec_after,
        "peak_device_bytes": peak,
        "card": state["card"],
    }


def phase_hnsw_db(seed: int, state: dict) -> dict:
    """The HNSW path through the user's entry point: ``DB`` ->
    ``Collection`` -> ``Shard`` -> ``HNSWIndex`` -> B2."""
    corpus, queries = state.pop("glove")
    rows = corpus[:HNSW_DB_ROWS + HNSW_DB_EXTRA]
    rng = np.random.default_rng(seed + 2)
    uuids = _uuids(rng, len(rows))
    uuid_arr = np.array(uuids)
    bucket = np.arange(len(rows)) % 100
    torch.cuda.reset_peak_memory_stats()
    root = tempfile.mkdtemp(prefix="chip_smoke_hnsw_db_")
    try:
        return _drive_hnsw_db(state, root, rows, queries, uuids, uuid_arr,
                              bucket)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _crash_leaving_commit_logs(db) -> int:
    """Objects and delta logs durable, the HNSW graphs not condensed: the
    commit logs hold the graph edits since the last snapshot. Returns their
    bytes."""
    pending = 0
    for col in db._collections.values():
        for shard in col._shards.values():
            shard.async_queue.flush()
            shard._delta.flush()
            shard.store.flush_all()
            shard._persist_counter()
            shard._persist_meta()
            for idx in shard._vector_indexes.values():
                idx._commitlog.flush()
                pending += idx._commitlog.pending_bytes
    db.cycles.stop()
    return pending


def _drive_hnsw_db(state, root, rows, queries, uuids, uuid_arr, bucket):
    flt = Where.eq("bucket", FILTER_BUCKET)
    beam_flt = Where.lt("bucket", BEAM_FILTER_BUCKETS)
    n = HNSW_DB_ROWS

    def put(db_col, lo, hi):
        for s in range(lo, hi, DB_BATCH):
            e = min(hi, s + DB_BATCH)
            db_col.put_batch([StorageObject(
                uuid=uuids[i], collection="Glove", vector=rows[i],
                properties={"bucket": int(bucket[i])}) for i in range(s, e)])

    db = DB(root)
    col = db.create_collection(CollectionConfig(
        name="Glove", properties=[Property("bucket", DataType.INT)],
        vector_config=HNSWIndexConfig(
            distance="cosine", ef=HNSW_EF, ef_construction=HNSW_EFC,
            max_connections=HNSW_M, device_beam=True),
        resident_filters=[beam_flt.to_dict()]))
    device_beam.fused_search.launches = 0
    t0 = time.perf_counter()
    put(col, 0, n)
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    ingest_launches = device_beam.fused_search.launches
    shard = next(iter(col._shards.values()))
    index = shard.vector_index()
    if not isinstance(index, HNSWIndex) or index._device_beam is None:
        raise AssertionError("the collection did not build a fused-walk HNSW")
    corpus_t, valid, _ = index.store.snapshot()
    gt = cosine_truth(corpus_t, valid, queries)

    device_beam.fused_search.launches = 0
    got = uuid_rows(db_search(col, queries))
    launches = device_beam.fused_search.launches
    if launches < 1:
        raise AssertionError("vector_search_batch did not launch B2")
    rec = recall(got, uuid_arr[gt])
    index_rec = recall(index.search(queries, K).ids, gt)
    plans = PLANNER_PLANS.value(plan=PLAN_EXACT)
    rows_f = db_search(col, queries, flt)
    if PLANNER_PLANS.value(plan=PLAN_EXACT) != plans + 1:
        raise AssertionError("the 1% filter did not take the exact plan")
    got_f = uuid_rows(rows_f)
    if any(o.properties["bucket"] != FILTER_BUCKET
           for r in rows_f for o, _ in r):
        raise AssertionError("the filtered query returned a non-matching object")
    allow = torch.zeros_like(valid)
    allow[:n] = torch.from_numpy(bucket[:n] == FILTER_BUCKET).cuda()
    q = normalize(torch.from_numpy(queries).cuda())
    gt_f = flat_search(q, corpus_t, K, "cosine", valid_mask=valid,
                       allow_mask=allow, precision="fp32")[1].cpu().numpy()
    rec_f = recall(got_f, uuid_arr[gt_f])
    if rec_f < 0.99:
        raise AssertionError(f"exact-plan filtered recall@10 {rec_f} < 0.99")

    # the resident 45% filter: the planner's filtered beam, one B2 launch
    # with the kept track and a two-hop budget of 1
    plans = PLANNER_PLANS.value(plan=PLAN_BEAM)
    device_beam.fused_search.launches = 0
    with KernelSpy() as spy:
        rows_b = db_search(col, queries, beam_flt)
    beam_launches = device_beam.fused_search.launches
    if PLANNER_PLANS.value(plan=PLAN_BEAM) != plans + 1:
        raise AssertionError("the 45% filter did not take the filtered beam")
    if beam_launches != 1 or spy.last[1].get("allow") is None \
            or spy.last[1]["expand"] != 1:
        raise AssertionError("the filtered beam did not run as one filtered "
                             "B2 launch with expansion 1")
    if any(o.properties["bucket"] >= BEAM_FILTER_BUCKETS
           for r in rows_b for o, _ in r):
        raise AssertionError("the filtered beam returned a non-matching "
                             "object")
    got_b = uuid_rows(rows_b)
    allow_b = torch.zeros_like(valid)
    allow_b[:n] = torch.from_numpy(bucket[:n] < BEAM_FILTER_BUCKETS).cuda()
    gt_b = flat_search(q, corpus_t, K, "cosine", valid_mask=valid,
                       allow_mask=allow_b, precision="fp32")[1].cpu().numpy()
    rec_b = recall(got_b, uuid_arr[gt_b])
    if rec_b < HNSW_RECALL_TARGET:
        raise AssertionError(f"filtered-beam recall@10 {rec_b} < "
                             f"{HNSW_RECALL_TARGET}")
    beam_walk = time_walk(*spy.last, 10, 1)
    search_ms = host_p(lambda: db_search(col, queries), 20)
    filtered_ms = host_p(lambda: db_search(col, queries, flt), 10)
    beam_ms = host_p(lambda: db_search(col, queries, beam_flt), 10)
    del corpus_t, valid, allow, allow_b, q, spy

    # close and reopen: the graph comes back from graph.npz
    t0 = time.perf_counter()
    db.close()
    db = DB(root)
    col = db.get_collection("Glove")
    reopen_s = time.perf_counter() - t0
    if col.count() != n:
        raise AssertionError(f"reopened count {col.count()} != {n}")
    if uuid_rows(db_search(col, queries)) != got \
            or uuid_rows(db_search(col, queries, flt)) != got_f \
            or uuid_rows(db_search(col, queries, beam_flt)) != got_b:
        raise AssertionError("the reopened HNSW collection answers differently")

    # a snapshot, more objects, then a crash: their graph edits replay
    # from the commit log
    db.flush()
    put(col, n, n + HNSW_DB_EXTRA)
    want = uuid_rows(db_search(col, queries))
    pending = _crash_leaving_commit_logs(db)
    if pending <= 0:
        raise AssertionError("the crash left no commit log to replay")
    t0 = time.perf_counter()
    db = DB(root)
    col = db.get_collection("Glove")
    crash_reopen_s = time.perf_counter() - t0
    index = next(iter(col._shards.values())).vector_index()
    if col.count() != n + HNSW_DB_EXTRA or index.count() != n + HNSW_DB_EXTRA:
        raise AssertionError("the crash-reopened collection lost objects")
    if uuid_rows(db_search(col, queries)) != want:
        raise AssertionError("the crash-reopened HNSW collection answers "
                             "differently")
    db.close()
    return {
        "rows": n, "extra_rows_after_snapshot": HNSW_DB_EXTRA,
        "batch": BATCH, "k": K, "put_batch": DB_BATCH,
        "ingest_s": ingest_s, "objects_per_s": n / ingest_s,
        "b2_launches_ingest": ingest_launches,
        "b2_launches_search": launches,
        "recall_at_10": rec, "index_recall_at_10": index_rec,
        "recall_at_10_filtered": rec_f, "filtered_plan": PLAN_EXACT,
        "search_p50_ms": float(np.percentile(search_ms, 50)),
        "search_p99_ms": float(np.percentile(search_ms, 99)),
        "filtered_search_p50_ms": float(np.percentile(filtered_ms, 50)),
        "beam_filter": beam_flt.to_dict(),
        "beam_filter_selectivity": float(np.mean(
            bucket[:n] < BEAM_FILTER_BUCKETS)),
        "recall_at_10_filtered_beam": rec_b, "filtered_beam_plan": PLAN_BEAM,
        "b2_launches_filtered_beam": beam_launches,
        "filtered_beam_search_p50_ms": float(np.percentile(beam_ms, 50)),
        "b2_filtered_beam_launch": beam_walk,
        "reopen_s": reopen_s, "crash_reopen_s": crash_reopen_s,
        "commit_log_bytes_replayed": pending,
        "peak_device_bytes": torch.cuda.max_memory_allocated(),
        "card": state["card"],
    }

# phase quant: bench.py bench_bq's configuration (LAION-like BQ flat, 768-d:
# 4,096 centres from seed 99, noise 0.45, unit rows; queries = the first
# 256 rows + 0.05 noise) and bench_msmarco's per-tenant SQ index (2,048
# centres, noise 0.4, unit rows, 8.8M / 16 tenants = 550,000 rows). Cut 6:
# BQ_ROWS of bench_bq's 10,000,000 rows, for the time limit (the BQ ingest
# is host-bound: 76.6 s of the script's time at 10M on an H100)
QUANT_DIMS = 768
BQ_CONFIGURED, BQ_ROWS, BQ_RESCORE = 10_000_000, 4_194_304, 320
SQ_ROWS, SQ_RESCORE = 550_000, 200
QUANT_ADD_STEP = 500_000


def clustered(n: int, d: int, centres: int, noise: float, seed: int,
              unit: bool = True) -> torch.Tensor:
    """Seeded clustered rows made on the card (bench.py's generators'
    shapes; numpy would take minutes at 10M rows)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    c = torch.randn(centres, d, generator=gen, device="cuda")
    out = torch.empty((n, d), device="cuda")
    for s in range(0, n, QUANT_ADD_STEP):
        e = min(n, s + QUANT_ADD_STEP)
        assign = torch.randint(0, centres, (e - s,), generator=gen,
                               device="cuda")
        out[s:e] = c[assign] + noise * torch.randn(e - s, d, generator=gen,
                                                   device="cuda")
    return normalize(out) if unit else out


def exact_truth(corpus: torch.Tensor, queries: torch.Tensor, metric: str,
                k: int = K) -> np.ndarray:
    """Exact float32 top-k ids (TF32 off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    return flat_search(queries, corpus, k, metric, chunk_size=262144,
                       precision="fp32")[1].cpu().numpy()


def scan_bound(kind: str, b: int, n: int, d: int, fetch: int,
               planes: dict, qbytes: int) -> tuple[float, str, dict]:
    """The least time of a Q1-Q4 search: its inputs read once (the code
    planes as they lie in device memory, Q3's codebooks, the mask, the
    queries' ``qbytes``) and its outputs written once, over the memory
    rate, against its 2*B*N*D products (D the width the products run over:
    bits for BQ, codes for SQ and RQ, decoded dimensions for PQ) over the
    int8 (BQ bit products) or bf16 tensor-core rate."""
    nbytes = (sum(t[:n].numel() * t.element_size() for t in planes.values())
              + n + qbytes + b * fetch * 8)
    width = d
    if kind in ("sq", "rq"):
        width = planes["codes"].shape[1]
    if kind == "pq":
        nbytes += 256 * d * 2  # the bf16 codebooks: centroids x D
    rate = INT8_OPS_S if kind == "bq" else BF16_FLOP_S
    t_ops = 2.0 * b * n * width / rate
    t_bytes = nbytes / HBM_BYTES_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations",
            {"bytes": nbytes, "ops": 2 * b * n * width})


def merge_bound(cand_keys, k: int) -> tuple[float, str, dict]:
    """The least time of the merge on these lists: each query's taken keys
    and the rows of its k survivors read once and its [b, k] distances and
    ids written once, over the memory rate (its comparisons are not a
    tensor-core rate's work). ``bytes_all_slots`` counts every slot of the
    [splits, b, k] lists instead, the bound before the merge skipped its
    padding."""
    splits, b, _ = cand_keys.shape
    taken = int((cand_keys[..., :k] != quantized.NONE_KEY).sum())
    kept = int((cand_keys[..., :k] != quantized.NONE_KEY).sum(-1).sum(0)
               .clamp(max=k).sum())
    nbytes = taken * 4 + kept * 4 + b * k * 8
    all_slots = splits * b * k * 8 + b * k * 8
    return nbytes / HBM_BYTES_S * 1e3, "bytes", {
        "bytes": nbytes, "bytes_all_slots": all_slots,
        "bound_ms_all_slots": all_slots / HBM_BYTES_S * 1e3}


def list_fill(cand_keys, k: int) -> dict:
    """Taken entries of the lists' first ``k`` slots: a split's and a
    query's mean and largest; raises if a taken entry follows padding (the
    merge reads each list's taken prefix only)."""
    taken = cand_keys[..., :k] != quantized.NONE_KEY
    if not bool((taken[..., :-1] | ~taken[..., 1:]).all()):
        raise AssertionError("a list holds a taken entry after padding")
    split = taken.sum(-1).float()
    query = split.sum(0)
    return {"split_mean": float(split.mean()), "split_max": int(split.max()),
            "query_mean": float(query.mean()), "query_max": int(query.max()),
            "slots_a_query": taken.shape[0] * k}


def check_merge(cand_keys, cand_rows, k: int) -> dict:
    """The merge alone on a scan's real lists: laid out as it reads them
    (taken entries, then padding), equal to its plain version (a stable
    sort), timed beside it and beside ``torch.topk`` over the same keys in
    signed order (it returns the same keys; its order among ties is not
    promised)."""
    splits, b, _ = cand_keys.shape
    fill = list_fill(cand_keys, k)
    kd, ki = quantized.merge_partials(cand_keys, cand_rows, k)
    pd, pi = quantized.merge_partials_plain(cand_keys, cand_rows, k)
    torch.cuda.synchronize()
    if not (torch.equal(kd, pd) and torch.equal(ki, pi)):
        raise AssertionError("the merge differs from its plain version")
    ms = cuda_ms(lambda: quantized.merge_partials(cand_keys, cand_rows, k),
                 10, 2)
    plain_ms = cuda_ms(lambda: quantized.merge_partials_plain(
        cand_keys, cand_rows, k), 3, 1)
    # the keys' unsigned order as int32's signed order: what topk sorts
    flat = cand_keys[..., :k].permute(1, 0, 2).reshape(b, splits * k)
    signed = torch.bitwise_xor(flat, -(1 << 31))
    lk = torch.topk(signed, k, dim=1, largest=False, sorted=True).values
    want = torch.sort(quantized._key_order(flat), dim=1).values[:, :k]
    if not torch.equal(quantized._key_order(
            torch.bitwise_xor(lk, -(1 << 31))), want):
        raise AssertionError("torch.topk takes other keys")
    library_ms = cuda_ms(lambda: torch.topk(signed, k, dim=1, largest=False,
                                            sorted=True), 10, 2)
    bound_ms, bound_by, work = merge_bound(cand_keys, k)
    return {"ms": float(np.median(ms)), "plain_ms": float(np.median(plain_ms)),
            "library_ms": float(np.median(library_ms)), "bound_ms": bound_ms,
            "bound_by": bound_by, "work": work, "fill": fill,
            "shape": {"splits": splits, "b": b, "k": k}}


def merge_lists(gen, splits: int, b: int, k: int, fill, keys: int,
                aligned: bool = True):
    """Lists [splits, b, cap] as the scans leave them (``aligned``: cap a
    multiple of 32, as ``scan_plan`` gives it; else not a multiple of 4):
    each
    (split, query) list's taken entries first, ``fill`` of them ("full":
    k; "empty": none; else random in [0, k]), keys drawn from ``keys``
    values (order keys of positive floats; few values make ties across
    splits), rows ascending in split order, then ``NONE_KEY`` / -1 padding;
    the slots past k hold junk the merge must not read."""
    dev = torch.device("cuda")
    cap = (-(-k // 32) * 32 + 32 if aligned
           else k + 7 if (k + 7) % 4 else k + 5)
    if fill == "full":
        n = torch.full((splits, b, 1), k, device=dev)
    elif fill == "empty":
        n = torch.zeros((splits, b, 1), device=dev, dtype=torch.long)
    else:
        n = torch.randint(0, k + 1, (splits, b, 1), device=dev,
                          generator=gen)
    slot = torch.arange(cap, device=dev)
    taken = slot < n
    key = (1 << 31) + 0x3F000000 + torch.randint(
        0, keys, (splits, b, cap), device=dev, generator=gen)
    key = torch.where(taken, key - (1 << 32), torch.full_like(key, -1))
    row = (torch.arange(splits, device=dev)[:, None, None] * 4 * cap
           + 3 * slot)
    row = torch.where(taken, row, -1)
    junk = slot >= k
    key = torch.where(junk, torch.randint(-(1 << 31), (1 << 31) - 1,
                                          key.shape, device=dev,
                                          generator=gen), key)
    row = torch.where(junk, 7, row)
    return key.to(torch.int32).contiguous(), row.to(torch.int32).contiguous()


# the merge's edges: (name, splits, B, k, fill, distinct keys, lists
# aligned); "fit" and "stream" take the largest k whose full lists the
# kernel stages in shared memory at 132 splits, and one more (its streaming
# path); lists not aligned take 4-byte copies into the stage
MERGE_EDGES = (
    ("full", 131, 256, 200, "full", 1 << 20, True),
    ("empty", 131, 256, 200, "empty", 1 << 20, True),
    ("ties_at_kth", 131, 256, 200, "random", 3, True),
    ("ties_full", 132, 64, 320, "full", 2, True),
    ("k1", 131, 256, 1, "random", 1 << 20, True),
    ("k1_full_ties", 131, 16, 1, "full", 1, True),
    ("fit", 132, 64, "fit", "full", 1 << 20, True),
    ("stream", 132, 64, "stream", "full", 1 << 20, True),
    ("stream_ties", 132, 16, "stream", "full", 5, True),
    ("stream_unaligned", 132, 16, "stream", "full", 1 << 20, False),
    ("b1", 132, 1, 320, "random", 1 << 20, True),
    ("b257", 131, 257, 200, "random", 1 << 20, True),
    ("unaligned", 131, 64, 201, "random", 7, False),
    ("max_k", 8, 4, quantized.MAX_K, "random", 1 << 20, True),
    ("max_k_full", 8, 4, quantized.MAX_K, "full", 1 << 20, True),
    ("pq_shape", 131, 256, 40, "random", 1 << 20, True),
)


def merge_edges(seed: int) -> dict:
    """The merge against its plain version, ids and distances bit for bit,
    on made lists at each of MERGE_EDGES; the stage capacity the wrapper
    computes equals the kernel's."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 23)
    lib = quantized._library()
    splits = 132
    fit = max(k for k in range(1, quantized.MAX_K + 1)
              if quantized.merge_places([k] * splits)
              <= quantized.merge_stage_cap(splits, k))
    out = {"cases": 0, "fit_k": fit, "paths": {"staged": 0, "streaming": 0}}
    for s, k in ((splits, fit), (splits, fit + 1), (131, 200), (132, 320),
                 (8, quantized.MAX_K), (1, 1)):
        if lib.topk_merge_stage_cap(s, k) != quantized.merge_stage_cap(s, k):
            raise AssertionError(f"the merge's stage capacity at {s} x {k}: "
                                 f"{lib.topk_merge_stage_cap(s, k)} in the "
                                 f"kernel, {quantized.merge_stage_cap(s, k)}"
                                 " in the wrapper")
    for name, s, b, k, fill, keys, aligned in MERGE_EDGES:
        k = {"fit": fit, "stream": fit + 1}.get(k, k)
        ck, cr = merge_lists(gen, s, b, k, fill, keys, aligned)
        kd, ki = quantized.merge_partials(ck, cr, k)
        pd, pi = quantized.merge_partials_plain(ck, cr, k)
        torch.cuda.synchronize()
        if not (torch.equal(kd, pd) and torch.equal(ki, pi)):
            bad = int((ki != pi).sum() + (kd != pd).sum())
            raise AssertionError(f"the merge differs from its plain version "
                                 f"at edge {name} ({s} x {b} x {k}, {fill}): "
                                 f"{bad} slots")
        counts = (ck[..., :k] != quantized.NONE_KEY).sum(-1)  # [s, b]
        most = int(((counts + 3) // 4 * 4).sum(0).max())
        path = ("staged" if most <= quantized.merge_stage_cap(s, k)
                else "streaming")
        out["paths"][path] += 1
        out[name] = {"splits": s, "b": b, "k": k, "path_of_fullest": path}
        out["cases"] += 1
    if not all(out["paths"].values()):
        raise AssertionError(f"a merge path went untested: {out['paths']}")
    return out


# the scans of the quantized flat indexes: (wrapper, its kernel's number,
# the JAX program it replaces, the product it runs)
SCANS = {
    "bq": (quantized.bq_search, 1, "weaviate_tpu/ops/quantized.py:138",
           "1-bit mma.m16n8k256 and.popc"),
    "sq": (quantized.sq_search, 2, "weaviate_tpu/ops/quantized.py:168",
           "bf16 wgmma.m64n256k16, warp-specialized (wg_scan_kernel)"),
    "pq": (quantized.pq_search, 3, "weaviate_tpu/ops/quantized.py:204",
           "bf16 wgmma.m64n256k16 on rows decoded through the bf16 "
           "codebooks, warp-specialized (wg_scan_kernel)"),
    "rq": (quantized.rq_search, 4, "weaviate_tpu/ops/quantized.py:241",
           "bf16 wgmma.m64n256k16, warp-specialized (wg_scan_kernel)"),
}


def scan_operands(kind: str, backend, qrep, planes, mask, metric: str,
                  fetch: int, plan, cand):
    """A search's kernel and plain version with their arguments, its scan
    alone (one launch into ``cand``), the plain distance of returned ids
    (``compare``'s ``near``) and the rows the product reads, decoded to
    bf16 (None for BQ): the yardstick ``torch.matmul`` multiplies."""
    qz = backend.quantizer
    if kind == "bq":
        args = (qrep.code, planes["packed"], planes["popcount"], mask,
                qz.dims, fetch)
        return (quantized.bq_search_cuda, quantized._bq_search_plain, args,
                lambda: quantized.bq_scan_cuda(*args, plan, *cand), None,
                None)
    qb, q_sum, q_sq = quantized.sq_query_terms(qrep.code)
    codes, dsq = planes["codes"], planes["dec_sqnorm"]
    if kind == "sq":
        args = (qrep.code, codes, dsq, qz.a, qz.s, mask, metric, fetch)
        return (quantized.sq_search_cuda, quantized._sq_search_plain, args,
                lambda: quantized.sq_scan_cuda(
                    qb, codes, dsq, mask, q_sum, q_sq, qz.a, qz.s, metric,
                    fetch, plan, *cand),
                lambda ids: quantized.sq_gather_distance(
                    qrep.code, codes, ids, dsq, qz.a, qz.s, metric),
                lambda: codes.to(torch.bfloat16))
    if kind == "rq":
        lo, st = planes["lower"], planes["step"]
        args = (qrep.code, codes, lo, st, dsq, mask, metric, fetch)
        return (quantized.rq_search_cuda, quantized._rq_search_plain, args,
                lambda: quantized.rq_scan_cuda(
                    qb, codes, lo, st, dsq, mask, q_sum, q_sq, metric, fetch,
                    plan, *cand),
                lambda ids: quantized.rq_gather_distance(
                    qrep.code, codes, ids, lo, st, dsq, metric),
                lambda: codes.to(torch.bfloat16))
    cb = qz.device_codebooks(codes.device)
    args = (qrep.code, codes, cb, dsq, mask, metric, fetch)

    def decoded():
        return torch.cat([quantized._pq_decode(codes[s:s + QUANT_ADD_STEP],
                                               cb, qz.dims)
                          for s in range(0, codes.shape[0], QUANT_ADD_STEP)])

    return (quantized.pq_search_cuda, quantized._pq_search_plain, args,
            lambda: quantized.pq_scan_cuda(qb, codes, cb, dsq, mask, q_sq,
                                           metric, fetch, plan, *cand),
            lambda ids: quantized.pq_gather_distance(
                qrep.code, codes, cb, ids, dsq, metric),
            decoded)


# rows of one encode timed alone in ``quant_flat``
ENCODE_ROWS = 100_000


def pq_encode_split(qz: ProductQuantizer, v: np.ndarray,
                    want: np.ndarray) -> dict:
    """``ProductQuantizer.encode`` of the prepped rows ``v``, step by step
    and each step timed: the host copy of the segments, their upload, the
    nearest-centroid assignment on the card, the codes' download and
    transpose, the host decode and the host sum of the decoded norms. The
    codes must be ``want``, the encode's own."""
    out = {}
    t = time.perf_counter()

    def lap(name):
        nonlocal t
        torch.cuda.synchronize()
        now = time.perf_counter()
        out[name] = now - t
        t = now

    seg = np.ascontiguousarray(qz._segments(v))
    lap("segments_host_s")
    x = torch.from_numpy(seg).to("cuda")
    lap("upload_s")
    a = _assign_chunked(x, qz.device_codebooks("cuda", False),
                        min(16384, max(256, x.shape[1])))
    lap("assign_s")
    codes = np.ascontiguousarray(a.to(torch.uint8).cpu().numpy().T)
    lap("download_s")
    dec = qz.decode(codes)
    lap("decode_host_s")
    np.sum(dec * dec, axis=1)
    lap("norms_host_s")
    if not np.array_equal(codes, want):
        raise AssertionError("the timed PQ encode steps differ from encode")
    out["total_s"] = sum(out.values())
    return out


def quant_flat(kind: str, n: int, cfg: FlatIndexConfig, rows,
               state: dict, add_step: int = QUANT_ADD_STEP) -> dict:
    """One quantized flat index through ``make_flat``: ingest from the
    card's rows in steps of ``add_step`` (``rows()`` makes them and the
    queries; the corpus is freed after the ground truth), each step timed;
    the fit and one encode, each timed alone (PQ's encode also step by
    step, ``pq_encode_split``); recall@10
    against the exact float32 answer, the search's launches (one scan, one
    merge), the search on the kernels beside its bound and its plain
    version, the scan alone and the merge alone, the product alone in
    ``torch.matmul`` (code scans: rows decoded to bf16 once, outside the
    timing), search p50/p99, the rescore's share, device and host bytes."""
    corpus, queries = rows()
    d = corpus.shape[1]
    metric = cfg.distance
    idx = make_flat(d, cfg)
    backend = idx.backend
    step_s = []
    t0 = time.perf_counter()
    for s in range(0, n, add_step):
        e = min(n, s + add_step)
        t1 = time.perf_counter()
        idx.add_batch(np.arange(s, e, dtype=np.int64), corpus[s:e].cpu().numpy())
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t1)
    ingest_s = time.perf_counter() - t0
    # the fit and the encode, each timed alone: a fresh quantizer of the
    # same configuration fits a sample of the training limit's size; the
    # index's own encode takes ENCODE_ROWS of the rows it ingested
    limit = getattr(cfg.quantizer, "training_limit", 100_000)
    sample = backend.originals.sample(limit)
    fresh = build_quantizer(cfg.quantizer, d, metric, device="cuda")
    t1 = time.perf_counter()
    fresh.fit(sample)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t1
    fit_rows = len(sample)
    del fresh
    enc_rows = backend._prep_vectors(
        corpus[:min(n, ENCODE_ROWS)].cpu().numpy())
    t1 = time.perf_counter()
    enc = backend._encode(enc_rows)
    torch.cuda.synchronize()
    enc_s = time.perf_counter() - t1
    enc_split = (pq_encode_split(backend.quantizer, enc_rows, enc["codes"])
                 if kind == "pq" else None)
    del sample, enc, enc_rows
    gt = exact_truth(corpus, queries, metric)
    del corpus
    torch.cuda.empty_cache()
    qn = queries.cpu().numpy()
    qrep = backend.prep_queries(qn)
    planes, mask = backend.codes.snapshot()
    nrows = int(mask.shape[0])
    fetch = max(4 * K, cfg.quantizer.rescore_limit, K)
    # the served path, launches counted from 0 for one search: one scan
    # over every query, one merge
    scan_fn, number, replaces, product = SCANS[kind]
    scan_fn.launches = 0
    quantized.merge_partials.launches = 0
    res = idx.search(qn, K)
    launches = {"scan": scan_fn.launches,
                "merge": quantized.merge_partials.launches}
    if launches != quantized.search_launches():
        raise AssertionError(f"{kind} flat search made {launches} launches")
    rec = recall(res.ids, gt)
    search_ms = host_p(lambda: idx.search(qn, K), 20)
    # the search's kernels alone, on the search's own inputs
    plan = quantized.device_plan(kind, len(qn), nrows, fetch, "cuda")
    cand = quantized._lists(plan, len(qn), "cuda")
    kernel, plain, args, scan, near, decoded = scan_operands(
        kind, backend, qrep, planes, mask, metric, fetch, plan, cand)
    kd, ki = kernel(*args)
    pd, pi = plain(*args)
    torch.cuda.synchronize()
    if kind == "bq":
        if not (torch.equal(kd, pd) and torch.equal(ki, pi)):
            raise AssertionError("Q1 differs from its plain version")
        err, agree = 0.0, 1.0
    else:
        err, same, total = compare(kd, ki, pd, pi, masked_near(near, mask))
        agree = same / max(1, total)
    ms = cuda_ms(lambda: kernel(*args), 10, 2)
    plain_ms = cuda_ms(lambda: plain(*args), 1, 0)
    bound_ms, bound_by, work = scan_bound(
        kind, len(qn), nrows, d, fetch, planes,
        qrep.code.numel() * qrep.code.element_size())
    # the scan alone, then the merge alone on the scan's lists
    scan_ms = float(np.median(cuda_ms(scan, 10, 2)))
    scan()
    merge = check_merge(*cand, fetch)
    yardstick = None
    if decoded is not None:
        # the bf16 product alone, on rows decoded once outside the timing
        wide = decoded()
        qb16 = qrep.code.to(torch.bfloat16)
        yardstick = float(np.median(cuda_ms(
            lambda: torch.matmul(qb16, wide.T), 10, 2)))
        del wide, qb16
    del cand
    torch.cuda.empty_cache()
    # the host rescore of the scan's candidates, alone
    cand_ids = ki.cpu().numpy()
    rescore_ms = host_p(lambda: exact_rescore(
        qrep.host, cand_ids, backend.originals, metric, K), 5)
    p50 = float(np.percentile(search_ms, 50))
    entry = {
        "name": f"{kind}_scan", "route": "cuda",
        "source": "weaviate_tpu_torch/csrc/quantized.cu",
        "replaces": replaces,
        "launches": launches["scan"], "max_abs_err": err,
        "ms": float(np.median(ms)), "plain_ms": float(np.median(plain_ms)),
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        "share_of_bound": bound_ms / float(np.median(ms)),
        "ms_covers": "one search: one scan launch and one merge launch",
        "scan_ms": scan_ms, "product": product,
        "merge_ms": merge["ms"],
        "launches_per_search": launches,
        "shape": {"b": len(qn), "n": nrows, "d": d, "fetch": fetch,
                  "splits": plan.splits, "split_rows": plan.split_rows,
                  "list_cap": plan.cap},
    }
    if yardstick is not None:
        entry["matmul_ms"] = yardstick
        entry["matmul_covers"] = ("the bf16 product only: torch.matmul of "
                                  "the bf16 queries against the rows "
                                  "decoded to bf16 once, outside the timing")
    state[f"kernel_q{number}"] = entry
    # the merge's entry: its times at the BQ search's shape (the larger),
    # the other searches' beside them
    if kind == "bq":
        state["kernel_merge"] = {
            "name": "topk_merge", "route": "cuda",
            "source": "weaviate_tpu_torch/csrc/quantized.cu",
            "replaces": "weaviate_tpu/ops/quantized.py:68",
            "launches": 0, "max_abs_err": 0.0, **merge}
    else:
        state["kernel_merge"][f"at_{kind}_shape"] = merge
    state["kernel_merge"]["launches"] += launches["merge"]
    state["kernel_merge"][f"launches_{kind}_search"] = launches["merge"]
    out = {
        "rows": n, "dims": d, "metric": metric,
        "quantizer": kind, "rescore_limit": cfg.quantizer.rescore_limit,
        "fetch": fetch, "batch": len(qn), "k": K,
        "ingest_s": ingest_s, "vectors_per_s": n / ingest_s,
        "first_add_s": step_s[0], "first_add_rows": min(n, add_step),
        "first_add_covers": "the first step's add_batch: the fit, then the "
                            "encode of every row it added",
        "add_step_s": step_s,
        "fit_s": fit_s, "fit_sample_rows": fit_rows,
        "encode_s": enc_s, "encode_rows": min(n, ENCODE_ROWS),
        "encode_vectors_per_s": min(n, ENCODE_ROWS) / max(enc_s, 1e-9),
        "encode_split": enc_split,
        "recall_at_10": rec, "launches_per_search": launches,
        "search_p50_ms": p50,
        "search_p99_ms": float(np.percentile(search_ms, 99)),
        "qps": len(qn) / p50 * 1e3,
        "kernel_search_ms": float(np.median(ms)), "scan_ms": scan_ms,
        "merge": merge, "bound_ms": bound_ms, "bound_by": bound_by,
        "plain_ms": float(np.median(plain_ms)), "matmul_ms": yardstick,
        "scan_work": work, "plan": plan._asdict(),
        "kernel_vs_plain_max_abs_err": err,
        "kernel_vs_plain_id_agreement": agree,
        "rescore_p50_ms": float(np.percentile(rescore_ms, 50)),
        "rescore_share_of_search": float(np.percentile(rescore_ms, 50)) / p50,
        "device_bytes": backend.codes.nbytes,
        "host_bytes": backend.originals.nbytes,
    }
    del idx, backend, qrep, planes, mask, args, kd, ki, pd, pi, scan
    torch.cuda.empty_cache()
    return out


def phase_quant(state: dict) -> dict:
    """The quantized flat indexes at bench_bq's and bench_msmarco's
    configurations, each through ``make_flat`` and its scan kernel."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(14)

    def bq_rows():
        corpus = clustered(BQ_ROWS, QUANT_DIMS, 4096, 0.45, 99)
        return corpus, normalize(corpus[:BATCH] + 0.05 * torch.randn(
            BATCH, QUANT_DIMS, generator=gen, device="cuda"))

    sq_queries = []

    def sq_rows():
        # RQ takes the SQ tenant's rows and queries
        corpus = clustered(SQ_ROWS, QUANT_DIMS, 2048, 0.4, 1000)
        if not sq_queries:
            pick = torch.randint(0, SQ_ROWS, (BATCH,), generator=gen,
                                 device="cuda")
            sq_queries.append(normalize(corpus[pick] + 0.05 * torch.randn(
                BATCH, QUANT_DIMS, generator=gen, device="cuda")))
        return corpus, sq_queries[0]

    bq = quant_flat("bq", BQ_ROWS, FlatIndexConfig(
        distance="cosine", initial_capacity=BQ_ROWS,
        quantizer=BQConfig(rescore_limit=BQ_RESCORE)), bq_rows, state)
    bq["rows_configured"] = BQ_CONFIGURED
    sq = quant_flat("sq", SQ_ROWS, FlatIndexConfig(
        distance="cosine", initial_capacity=SQ_ROWS,
        quantizer=SQConfig(rescore_limit=SQ_RESCORE)), sq_rows, state)
    # RQ in the SQ tenant's place: the same rows and queries
    rq = quant_flat("rq", SQ_ROWS, FlatIndexConfig(
        distance="cosine", initial_capacity=SQ_ROWS,
        quantizer=RQConfig(rescore_limit=SQ_RESCORE)), sq_rows, state)
    rq_hnsw = hnsw_rq(state)
    return {"bq": bq, "sq": sq, "rq": rq, "rq_hnsw": rq_hnsw,
            "peak_device_bytes": torch.cuda.max_memory_allocated(),
            "card": state["card"]}


# phase quant's HNSW + RQ: the first RQ_HNSW_ROWS of the SQ tenant's rows
# (cut from 550,000 for the time limit; the quantized build is host-bound)
# in an HNSW index at quant_db's graph settings, RQ with the tenant's
# rescore limit: B2-RQ in construction and search
RQ_HNSW_ROWS = 32_768


def hnsw_rq(state: dict) -> dict:
    """HNSW + RQ with the fused walk over the SQ tenant's first rows: the
    build, recall@10 of the device walk and the host walk, one B2 launch a
    search, B2-RQ beside its bound and its plain version."""
    corpus = clustered(SQ_ROWS, QUANT_DIMS, 2048, 0.4, 1000)[:RQ_HNSW_ROWS]
    gen = torch.Generator(device="cuda").manual_seed(15)
    pick = torch.randint(0, RQ_HNSW_ROWS, (BATCH,), generator=gen,
                         device="cuda")
    queries = normalize(corpus[pick] + 0.05 * torch.randn(
        BATCH, QUANT_DIMS, generator=gen, device="cuda"))
    out = hnsw_quantized(
        "rq", corpus.cpu().numpy(), queries.cpu().numpy(), HNSWIndexConfig(
            distance="cosine", ef=96, ef_construction=96, max_connections=16,
            insert_batch=4096, flat_search_cutoff=0, device_beam=True,
            initial_capacity=RQ_HNSW_ROWS,
            quantizer=RQConfig(rescore_limit=SQ_RESCORE)), state)
    out["rows_configured"] = SQ_ROWS
    return out


# phase hnsw_quant: bench.py bench_hnsw_quant's bq configuration (seed 29,
# 1,024 centres, noise 0.35, l2-squared, 768-d; queries = the first 256 rows
# + 0.1 noise), cut in depth from HNSW_QUANT_CONFIGURED to HNSW_QUANT_ROWS
# for the time limit (the build is host-bound at about 1,500-1,800 rows/s;
# halved from 262,144 to make room for phase hybrid, and again from 131,072
# for phases hfresh and segment); a fixed depth, so B2-BQ's and the
# build's numbers compare across runs at one depth. The generator makes
# HNSW_QUANT_DATA_ROWS rows (the draws depend on the count): the cell takes
# the first HNSW_QUANT_ROWS, phase quant_db the first 102,000
HNSW_QUANT_CONFIGURED, HNSW_QUANT_ROWS = 1_000_000, 65_536
HNSW_QUANT_DATA_ROWS = 131_072
HNSW_QUANT_EF, HNSW_QUANT_RESCORE = 96, 80


def hnsw_quant_data(n: int, dims: int = QUANT_DIMS
                    ) -> tuple[np.ndarray, np.ndarray]:
    """bench_hnsw_quant's rows and queries at ``dims``, as float32 numpy."""
    rng = np.random.default_rng(29)
    centers = rng.standard_normal((1024, dims)).astype(np.float32)
    corpus = centers[rng.integers(0, 1024, n)] + 0.35 * rng.standard_normal(
        (n, dims)).astype(np.float32)
    queries = corpus[:BATCH] + 0.1 * rng.standard_normal(
        (BATCH, dims)).astype(np.float32)
    return corpus, queries


# the scorers the quantized HNSW phases walk: the JAX program each row type
# replaces
B2_REPLACES = {"bq": "weaviate_tpu/ops/device_beam.py:112",
               "sq": "weaviate_tpu/ops/device_beam.py:85",
               "pq": "weaviate_tpu/ops/device_beam.py:98",
               "rq": "weaviate_tpu/ops/device_beam.py:125"}


def hnsw_quantized(kind: str, corpus: np.ndarray, queries: np.ndarray,
                   cfg: HNSWIndexConfig, state: dict,
                   add_step: int = 100_000) -> dict:
    """HNSW + a quantizer with the fused walk: the build (B2 launches and
    their summed time), recall@10 of the device walk against the exact
    float32 answer and against the host walk on the same index, one B2
    launch a search, B2 beside its bound and its plain version; its
    ``kernels`` entry in ``state["kernel_b2_<kind>"]``."""
    rows, d = corpus.shape
    idx = HNSWIndex(d, cfg)
    device_beam.fused_search.launches = 0
    t0 = time.perf_counter()
    with KernelSpy() as build_spy:
        for s in range(0, rows, add_step):
            e = min(rows, s + add_step)
            idx.add_batch(np.arange(s, e), corpus[s:e])
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_launches = device_beam.fused_search.launches
    if build_launches < 1:
        raise AssertionError(f"the {kind} construction did not launch B2")
    build_b2_ms = build_spy.ms()
    gt = exact_truth(torch.from_numpy(corpus).cuda(),
                     torch.from_numpy(queries).cuda(), cfg.distance)

    device_beam.fused_search.launches = 0
    res = idx.search(queries, K)
    search_launches = device_beam.fused_search.launches
    if search_launches != 1:
        raise AssertionError(f"HNSW+{kind} search made {search_launches} B2 "
                             "launches, not one")
    rec = recall(res.ids, gt)
    search_ms = host_p(lambda: idx.search(queries, K), 20)
    with KernelSpy() as spy:
        idx.search(queries, K)
    walk = time_walk(*spy.last, 20, 1)
    # the build's widest launch: the rows of a sub-batch that fit the
    # visited budget, ef_construction padded
    cwalk = time_walk(*build_spy.widest, 5, 1)
    beam = idx._device_beam
    idx._device_beam = None
    try:
        host_res = idx.search(queries, K)
        host_ms = host_p(lambda: idx.search(queries, K), 2)
    finally:
        idx._device_beam = beam
    host_rec = recall(host_res.ids, gt)
    if rec < host_rec - 0.005:
        raise AssertionError(f"HNSW+{kind} device-walk recall {rec} < host "
                             f"walk {host_rec} - 0.005")
    state[f"kernel_b2_{kind}"] = {
        "name": f"device_beam_search/{kind}", "route": "cuda",
        "source": "weaviate_tpu_torch/csrc/device_beam.cu",
        "replaces": B2_REPLACES[kind],
        "launches": build_launches + search_launches,
        "max_abs_err": walk["vs_plain_max_abs_err"],
        "ms": walk["ms_median"], "plain_ms": walk["plain_ms"],
        "bound_ms": walk["bound_ms"], "bound_by": walk["bound_by"],
        "library_ms": None, "launches_build": build_launches,
        "launches_per_search": search_launches,
        "share_of_bound": walk["bound_ms"] / walk["ms_median"],
        "us_per_hop": walk["us_per_hop"],
        "construction_launch_ms": cwalk["ms_median"],
        "construction_bound_ms": cwalk["bound_ms"],
        "construction_bound_by": cwalk["bound_by"],
        "construction_us_per_hop": cwalk["us_per_hop"],
    }
    peak = torch.cuda.max_memory_allocated()
    del idx, beam, spy, build_spy
    torch.cuda.empty_cache()
    return {
        "rows": rows, "dims": d, "metric": cfg.distance, "quantizer": kind,
        "rescore_limit": cfg.quantizer.rescore_limit, "ef": cfg.ef,
        "ef_construction": cfg.ef_construction,
        "max_connections": cfg.max_connections,
        "insert_batch": cfg.insert_batch, "batch": len(queries), "k": K,
        "build_s": build_s, "vectors_per_s": rows / build_s,
        "b2_launches_build": build_launches, "b2_build_ms": build_b2_ms,
        "recall_at_10": rec, "host_walk_recall_at_10": host_rec,
        "b2_launches_per_search": search_launches,
        "search_p50_ms": float(np.percentile(search_ms, 50)),
        "search_p99_ms": float(np.percentile(search_ms, 99)),
        "host_walk_p50_ms": float(np.percentile(host_ms, 50)),
        "b2_search_launch": walk, "b2_construction_launch": cwalk,
        "peak_device_bytes": peak, "card": state["card"],
    }


def phase_hnsw_quant(state: dict) -> dict:
    """HNSW + BQ with the fused walk: build, recall of the device walk
    against the host walk on the same index, one B2 launch a search, B2-BQ
    beside its bound and its plain version."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    corpus, queries = hnsw_quant_data(HNSW_QUANT_DATA_ROWS)
    state["hnsw_quant"] = (corpus, queries)
    out = hnsw_quantized("bq", corpus[:HNSW_QUANT_ROWS], queries,
                         HNSWIndexConfig(
        distance="l2-squared", ef=HNSW_QUANT_EF, ef_construction=96,
        max_connections=16, insert_batch=4096, flat_search_cutoff=0,
        device_beam=True, initial_capacity=HNSW_QUANT_ROWS,
        quantizer=BQConfig(rescore_limit=HNSW_QUANT_RESCORE)), state)
    out["rows_configured"] = HNSW_QUANT_CONFIGURED
    return out


# phase pq: BASELINE.json config 3 (DBpedia-OpenAI 1M 1536-d, PQ with 96
# segments) as bench.py bench_pq runs it, not cut: 1,000,000 rows of
# 1,024 centres with noise 0.35, made on the card from a seed, l2-squared,
# queries = the first 256 rows + 0.1 noise, added in steps of 200,000 (the
# fit takes a 100,000-row sample of the first step)
PQ_ROWS, PQ_DIMS, PQ_SEGMENTS, PQ_RESCORE = 1_000_000, 1536, 96, 40
PQ_ADD_STEP = 200_000


def phase_pq(state: dict) -> dict:
    """Config 3 as a flat index over PQ codes through ``make_flat``: the
    fit and encode on the card, Q3 and the merge, the host rescore."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(16)

    def rows():
        corpus = clustered(PQ_ROWS, PQ_DIMS, 1024, 0.35, 11, unit=False)
        return corpus, (corpus[:BATCH] + 0.1 * torch.randn(
            BATCH, PQ_DIMS, generator=gen, device="cuda")).contiguous()

    out = quant_flat("pq", PQ_ROWS, FlatIndexConfig(
        distance="l2-squared", initial_capacity=PQ_ROWS,
        quantizer=PQConfig(segments=PQ_SEGMENTS, rescore_limit=PQ_RESCORE)),
        rows, state, add_step=PQ_ADD_STEP)
    out.update(segments=PQ_SEGMENTS,
               peak_device_bytes=torch.cuda.max_memory_allocated(),
               card=state["card"])
    return out


# phase hnsw_pq: config 3 as a graph, bench_hnsw_quant's pq configuration
# (seed 29, 1,024 centres, noise 0.35, 1536-d, l2-squared, ef 96,
# ef_construction 96, M 16, insert_batch 4096, PQ 96 segments, rescore 40);
# cut 4: HNSW_PQ_ROWS of 1,000,000 rows (the quantized build is host-bound,
# and the script's time limit), a fixed depth so runs compare
HNSW_PQ_ROWS = 32_768


def phase_hnsw_pq(state: dict) -> dict:
    """HNSW + PQ with the fused walk (B2-PQ) at config 3's widths."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    corpus, queries = hnsw_quant_data(HNSW_PQ_ROWS, PQ_DIMS)
    out = hnsw_quantized("pq", corpus, queries, HNSWIndexConfig(
        distance="l2-squared", ef=HNSW_QUANT_EF, ef_construction=96,
        max_connections=16, insert_batch=4096, flat_search_cutoff=0,
        device_beam=True, initial_capacity=HNSW_PQ_ROWS,
        quantizer=PQConfig(segments=PQ_SEGMENTS, rescore_limit=PQ_RESCORE)),
        state)
    out["rows_configured"] = PQ_ROWS
    out["segments"] = PQ_SEGMENTS
    return out


# phase quant_db: the first QUANT_DB_ROWS of phase hnsw_quant's rows as
# objects in an HNSW + SQ collection (cosine), the scale of phase hnsw_db
QUANT_DB_ROWS, QUANT_DB_EXTRA = 100_000, 2_000


def phase_quant_db(seed: int, state: dict) -> dict:
    """The quantized HNSW path through the user's entry point: ``DB`` ->
    ``Collection`` -> ``Shard`` -> ``HNSWIndex`` + SQ -> B2-SQ and Q2."""
    corpus, queries = state.pop("hnsw_quant")
    rows = corpus[:QUANT_DB_ROWS + QUANT_DB_EXTRA]
    rng = np.random.default_rng(seed + 3)
    uuids = _uuids(rng, len(rows))
    bucket = np.arange(len(rows)) % 100
    torch.cuda.reset_peak_memory_stats()
    root = tempfile.mkdtemp(prefix="chip_smoke_quant_db_")
    try:
        return _drive_quant_db(state, root, rows, queries, uuids,
                               np.array(uuids), bucket)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _drive_quant_db(state, root, rows, queries, uuids, uuid_arr, bucket):
    flt = Where.eq("bucket", FILTER_BUCKET)
    beam_flt = Where.lt("bucket", BEAM_FILTER_BUCKETS)
    n = QUANT_DB_ROWS

    def put(db_col, lo, hi):
        for s in range(lo, hi, DB_BATCH):
            e = min(hi, s + DB_BATCH)
            db_col.put_batch([StorageObject(
                uuid=uuids[i], collection="Laion", vector=rows[i],
                properties={"bucket": int(bucket[i])}) for i in range(s, e)])

    db = DB(root)
    col = db.create_collection(CollectionConfig(
        name="Laion", properties=[Property("bucket", DataType.INT)],
        vector_config=HNSWIndexConfig(
            distance="cosine", ef=96, ef_construction=96, max_connections=16,
            device_beam=True, quantizer=SQConfig(rescore_limit=200)),
        resident_filters=[beam_flt.to_dict()]))
    device_beam.fused_search.launches = 0
    t0 = time.perf_counter()
    with KernelSpy() as build_spy:
        put(col, 0, n)
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    ingest_launches = device_beam.fused_search.launches
    index = next(iter(col._shards.values())).vector_index()
    if not isinstance(index, HNSWIndex) or not index.backend.quantized \
            or index._device_beam is None:
        raise AssertionError("the collection did not build a quantized "
                             "fused-walk HNSW")
    unit = normalize(torch.from_numpy(rows[:n]).cuda())
    qt = normalize(torch.from_numpy(queries).cuda())
    gt = exact_truth(unit, qt, "cosine")

    device_beam.fused_search.launches = 0
    got = uuid_rows(db_search(col, queries))
    launches = device_beam.fused_search.launches
    if launches < 1:
        raise AssertionError("vector_search_batch did not launch B2-SQ")
    rec = recall(got, uuid_arr[gt])
    # the 1% filter: the planner's exact plan, the SQ scan (Q2)
    plans = PLANNER_PLANS.value(plan=PLAN_EXACT)
    quantized.sq_search.launches = 0
    quantized.merge_partials.launches = 0
    rows_f = db_search(col, queries, flt)
    q2_launches = quantized.sq_search.launches
    q2_merge_launches = quantized.merge_partials.launches
    if PLANNER_PLANS.value(plan=PLAN_EXACT) != plans + 1 or \
            {"scan": q2_launches, "merge": q2_merge_launches} != \
            quantized.search_launches():
        raise AssertionError("the 1% filter did not take the exact plan "
                             "through one SQ scan and one merge")
    if any(o.properties["bucket"] != FILTER_BUCKET
           for r in rows_f for o, _ in r):
        raise AssertionError("the filtered query returned a non-matching "
                             "object")
    got_f = uuid_rows(rows_f)
    sel_f = np.flatnonzero(bucket[:n] == FILTER_BUCKET)
    gt_f = sel_f[exact_truth(unit[torch.from_numpy(sel_f).cuda()], qt,
                             "cosine")]
    rec_f = recall(got_f, uuid_arr[gt_f])
    # the resident 45% filter: the filtered beam, one B2-SQ launch with the
    # kept track
    plans = PLANNER_PLANS.value(plan=PLAN_BEAM)
    device_beam.fused_search.launches = 0
    with KernelSpy() as spy:
        rows_b = db_search(col, queries, beam_flt)
    beam_launches = device_beam.fused_search.launches
    if PLANNER_PLANS.value(plan=PLAN_BEAM) != plans + 1 or beam_launches != 1 \
            or spy.last[1].get("allow") is None:
        raise AssertionError("the 45% filter did not run as one filtered "
                             "B2-SQ launch")
    if any(o.properties["bucket"] >= BEAM_FILTER_BUCKETS
           for r in rows_b for o, _ in r):
        raise AssertionError("the filtered beam returned a non-matching "
                             "object")
    got_b = uuid_rows(rows_b)
    sel_b = np.flatnonzero(bucket[:n] < BEAM_FILTER_BUCKETS)
    gt_b = sel_b[exact_truth(unit[torch.from_numpy(sel_b).cuda()], qt,
                             "cosine")]
    rec_b = recall(got_b, uuid_arr[gt_b])
    beam_walk = time_walk(*spy.last, 10, 1)
    with KernelSpy() as spy:
        db_search(col, queries)
    walk = time_walk(*spy.last, 10, 1)
    cwalk = time_walk(*build_spy.widest, 5, 1)
    search_ms = host_p(lambda: db_search(col, queries), 10)
    filtered_ms = host_p(lambda: db_search(col, queries, flt), 5)
    beam_ms = host_p(lambda: db_search(col, queries, beam_flt), 5)
    state["kernel_b2_sq"] = {
        "name": "device_beam_search/sq", "route": "cuda",
        "source": "weaviate_tpu_torch/csrc/device_beam.cu",
        "replaces": "weaviate_tpu/ops/device_beam.py:85",
        "launches": ingest_launches + launches + beam_launches,
        "max_abs_err": walk["vs_plain_max_abs_err"],
        "ms": walk["ms_median"], "plain_ms": walk["plain_ms"],
        "bound_ms": walk["bound_ms"], "bound_by": walk["bound_by"],
        "library_ms": None, "launches_ingest": ingest_launches,
        "launches_per_search": launches,
        "share_of_bound": walk["bound_ms"] / walk["ms_median"],
        "us_per_hop": walk["us_per_hop"],
        "construction_launch_ms": cwalk["ms_median"],
        "construction_bound_ms": cwalk["bound_ms"],
        "construction_bound_by": cwalk["bound_by"],
        "construction_us_per_hop": cwalk["us_per_hop"],
    }
    state["kernel_q2"]["launches"] += q2_launches
    state["kernel_merge"]["launches"] += q2_merge_launches
    state["kernel_merge"]["launches_quant_db"] = q2_merge_launches
    del unit, qt, spy, build_spy

    t0 = time.perf_counter()
    db.close()
    db = DB(root)
    col = db.get_collection("Laion")
    reopen_s = time.perf_counter() - t0
    if col.count() != n:
        raise AssertionError(f"reopened count {col.count()} != {n}")
    index = next(iter(col._shards.values())).vector_index()
    if not index.backend.quantizer.fitted:
        raise AssertionError("the reopened index lost its quantizer state")
    if uuid_rows(db_search(col, queries)) != got \
            or uuid_rows(db_search(col, queries, flt)) != got_f \
            or uuid_rows(db_search(col, queries, beam_flt)) != got_b:
        raise AssertionError("the reopened quantized collection answers "
                             "differently")
    db.flush()
    put(col, n, n + QUANT_DB_EXTRA)
    want = uuid_rows(db_search(col, queries))
    pending = _crash_leaving_commit_logs(db)
    t0 = time.perf_counter()
    db = DB(root)
    col = db.get_collection("Laion")
    crash_reopen_s = time.perf_counter() - t0
    if col.count() != n + QUANT_DB_EXTRA:
        raise AssertionError("the crash-reopened collection lost objects")
    if uuid_rows(db_search(col, queries)) != want:
        raise AssertionError("the crash-reopened quantized collection "
                             "answers differently")
    db.close()
    return {
        "rows": n, "extra_rows_after_snapshot": QUANT_DB_EXTRA,
        "quantizer": "sq", "rescore_limit": 200, "metric": "cosine",
        "batch": BATCH, "k": K, "put_batch": DB_BATCH,
        "ingest_s": ingest_s, "objects_per_s": n / ingest_s,
        "b2_launches_ingest": ingest_launches,
        "b2_launches_search": launches,
        "recall_at_10": rec, "recall_at_10_filtered": rec_f,
        "filtered_plan": PLAN_EXACT, "q2_launches_filtered": q2_launches,
        "merge_launches_filtered": q2_merge_launches,
        "recall_at_10_filtered_beam": rec_b, "filtered_beam_plan": PLAN_BEAM,
        "b2_launches_filtered_beam": beam_launches,
        "search_p50_ms": float(np.percentile(search_ms, 50)),
        "search_p99_ms": float(np.percentile(search_ms, 99)),
        "filtered_search_p50_ms": float(np.percentile(filtered_ms, 50)),
        "filtered_beam_search_p50_ms": float(np.percentile(beam_ms, 50)),
        "b2_search_launch": walk, "b2_filtered_beam_launch": beam_walk,
        "b2_construction_launch": cwalk,
        "reopen_s": reopen_s, "crash_reopen_s": crash_reopen_s,
        "commit_log_bytes_replayed": pending,
        "peak_device_bytes": torch.cuda.max_memory_allocated(),
        "card": state["card"],
    }


# ---------------------------------------------------------------------------
# BASELINE.json config 5: MS-MARCO hybrid BM25 + vector, 16 tenants
# ---------------------------------------------------------------------------

# bench.py bench_msmarco's configuration: 8.8M docs over 16 tenants (550,000
# a tenant), a 30,000-term Zipf vocabulary (df = 0.5 per / (1 + rank)^0.9,
# at least 1), tf 1-3, doc lengths 40-89, queries of 3-6 terms drawn with
# p ~ sqrt(df + 1), BM25 k1 1.2 and b 0.75, alpha 0.5, relativeScoreFusion,
# k 10; 768-d cosine vectors from 2,048 centres with noise 0.4 in an SQ
# flat index with rescore limit 200 a tenant
MS_TENANTS, MS_TENANT_DOCS, MS_VOCAB = 16, 550_000, 30_000
MS_K1, MS_B, MS_ALPHA = 1.2, 0.75, 0.5
# phase hybrid: cut 7, HYBRID_DOCS objects a tenant (of 550,000), the
# 16-tenant layout kept: the largest power of two at which the phase stays
# near 90 s on an H100's host (the ingest, about 2,600 objects/s, and the
# close, which snapshots 16 x 30,000 posting lists, are host-bound); its
# requests, and the exact answer's fetch a leg
HYBRID_DOCS = 8192
HYBRID_REQUESTS = 256
HYBRID_GT_FETCH = 100
# B6a and B6b against their plain versions: scores to RTOL_B6, ids equal
# wherever the neighbouring scores differ by more than that (the plain
# versions sum with float atomics on the card, in another order)
RTOL_B6 = 1e-5
B6A_QUERIES = 8
# (legs, leg length, union, k): config 5's, a union in device memory (past
# the kernel's shared-memory plan), the widest in shared memory, k = union,
# the small path's widest (a slot repeated across its 32-position steps)
B6B_SHAPES = ((2, 32, 64, 10), (8, 2048, 16384, 100), (2, 4096, 8192, 10),
              (3, 8, 16, 16), (2, 64, 128, 64))


def zipf_postings(per: int, seed: int) -> dict:
    """One tenant's postings as bench_msmarco makes them, on the card: the
    (term, doc) edges deduplicated and sorted by term then doc (each term's
    docs ascend, unique), tf 1-3, each term's [start, end) and df, and doc
    lengths 40-89."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    ranks = torch.arange(MS_VOCAB, device=dev)
    df_target = torch.clamp(
        (0.5 * per / (1.0 + ranks.double()) ** 0.9).long(), min=1)
    terms = torch.repeat_interleave(ranks, df_target)
    docs = torch.randint(0, per, (terms.numel(),), generator=g, device=dev)
    key = torch.unique(terms * per + docs)
    terms, docs = key // per, key % per
    bounds = torch.searchsorted(terms, torch.arange(MS_VOCAB + 1,
                                                    device=dev))
    bounds = bounds.cpu().numpy()
    return {"per": per, "terms": terms, "docs": docs.to(torch.int32),
            "tf": torch.randint(1, 4, (key.numel(),), generator=g,
                                device=dev).float(),
            "bounds": bounds, "df": np.diff(bounds),
            "dl": torch.randint(40, 90, (per,), generator=g,
                                device=dev).float()}


def query_pool(df: np.ndarray, n: int, seed: int) -> list[np.ndarray]:
    """bench_msmarco's query terms: 3-6 draws with p ~ sqrt(df + 1)."""
    rng = np.random.default_rng(seed)
    p = (df + 1.0) ** 0.5
    p /= p.sum()
    return [np.unique(rng.choice(MS_VOCAB, int(rng.integers(3, 7)), p=p))
            for _ in range(n)]


def bm25_idf(n_docs: int, df: int) -> float:
    return float(np.log(1.0 + (n_docs - df + 0.5) / (df + 0.5)))


def sparse_inputs(post: dict, terms, dl, avgdl: float, k: int,
                  allow_share, gen) -> dict:
    """B6a's operands for one query over one tenant's postings, as
    ``InvertedIndex.bm25_device_search`` lays them out: a segment a term
    (its weight, avgdl and group a segment's), entries padded to a power
    of two with rows -1, the doc space padded to ``bucket(per)``;
    ``allow_share`` None allows every doc."""
    dev = torch.device("cuda")
    b = post["bounds"]
    lens = [int(b[t + 1] - b[t]) for t in terms]
    idx = torch.cat([torch.arange(int(b[t]), int(b[t + 1]), device=dev)
                     for t in terms])
    n = idx.numel()
    p_len = fusion.bucket(n)
    rows = torch.full((p_len,), -1, dtype=torch.int32, device=dev)
    rows[:n] = post["docs"][idx]
    tf = torch.zeros(p_len, device=dev)
    tf[:n] = post["tf"][idx]
    dls = torch.zeros(p_len, device=dev)
    dls[:n] = dl[rows[:n].long()]
    seg_w = torch.tensor([bm25_idf(post["per"], int(post["df"][t]))
                          for t in terms], dtype=torch.float32, device=dev)
    seg_avgdl = torch.full((len(terms),), avgdl, device=dev)
    seg_grp = torch.arange(len(terms), dtype=torch.int32, device=dev)
    seg = torch.tensor(np.concatenate([[0], np.cumsum(lens)]),
                       dtype=torch.int32, device=dev)
    per = post["per"]
    s_len = fusion.bucket(per, floor=fusion.bucket(k))
    allow = torch.zeros(s_len, dtype=torch.bool, device=dev)
    allow[:per] = True if allow_share is None else (
        torch.rand(per, generator=gen, device=dev) < allow_share)
    return {"rows": rows, "tf": tf, "dl": dls, "seg": seg, "seg_w": seg_w,
            "seg_avgdl": seg_avgdl, "seg_grp": seg_grp, "allow": allow,
            "entries": n, "groups": len(terms)}


def sparse_call(op: dict, k: int, min_match: int, fn):
    """``fn`` (the kernel's wrapper or the plain version) on ``op``."""
    a = (op["rows"], op["tf"], op["dl"], op["seg"], op["seg_w"],
         op["seg_avgdl"], op["allow"], k, MS_K1, MS_B)
    if min_match:
        return fn(*a, op["seg_grp"], fusion.bucket(op["groups"], floor=2),
                  min_match)
    return fn(*a)


def check_b6(kv, ki, pv, pi, what: str) -> tuple[float, int]:
    """Kernel (kv, ki) against plain (pv, pi): scores to RTOL_B6, -1 slots
    equal, ids equal except where the plain page's neighbouring scores lie
    within RTOL_B6. Returns (max abs error, ids that differ)."""
    kv, ki, pv, pi = (t.cpu().numpy() for t in (kv, ki, pv, pi))
    err = np.abs(kv - pv)
    if (err > RTOL_B6 * np.abs(pv) + 1e-6).any():
        raise AssertionError(f"{what}: scores differ, max {err.max()}")
    if ((ki == -1) != (pi == -1)).any():
        raise AssertionError(f"{what}: -1 slots differ")
    diff = np.nonzero(ki != pi)[0]
    for i in diff:
        near = [pv[x] for x in (i - 1, i + 1) if 0 <= x < len(pv)]
        if not any(abs(v - pv[i]) <= RTOL_B6 * abs(pv[i]) for v in near):
            raise AssertionError(f"{what}: id {i} differs outside a tie")
    return float(err.max()) if len(err) else 0.0, len(diff)


def same_bits(a, b) -> bool:
    return all(torch.equal(x.view(torch.int32), y.view(torch.int32))
               for x, y in zip(a, b))


def b6a_bound_ms(op: dict, k: int, min_match: int) -> float:
    """B6a's bytes over the memory rate: each entry read once (row, tf,
    dl), each segment's boundary, weight and avgdl (and its group under
    min-match), the allow mask, the output page written once."""
    segs = op["seg"].numel() - 1
    moved = (op["entries"] * 12 + segs * (12 + (4 if min_match else 0)) + 4
             + op["allow"].numel() + k * 8)
    return moved / HBM_BYTES_S * 1e3


def b6_sparse_grid(seed: int) -> dict:
    """B6a at phase ``hybrid``'s tenant size (HYBRID_DOCS) and at a full
    config-5 tenant (550,000 docs), bench_msmarco's postings made on the
    card: B6A_QUERIES queries unfiltered, under 1% and 45% allow masks,
    with min-match 2, and at k 100 (whose partial lists the last CTA reads
    from L2 at 550,000 docs), each against the plain version on the card,
    two launches compared bit for bit, and the plain version on the CPU
    (whose scatter sums in entry order, as the kernel does) compared bit
    for bit and reported; each mode timed on its first query."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 21)
    modes = {"unfiltered": (None, 0, 10), "allow_1pct": (0.01, 0, 20),
             "allow_45pct": (0.45, 0, 20), "min_match_2": (None, 2, 10),
             "unfiltered_k100": (None, 0, 100)}
    tenants, max_err, diffs, cpu_equal, cases = {}, 0.0, 0, 0, 0
    for docs, post_seed in ((HYBRID_DOCS, 1000), (MS_TENANT_DOCS, seed + 5)):
        post = zipf_postings(docs, post_seed)
        dl = post["dl"]
        avgdl = float(dl.mean())
        queries = query_pool(post["df"], B6A_QUERIES, seed + 7)
        out = {}
        for mode, (share, mm, k) in modes.items():
            timed = None
            for qi, terms in enumerate(queries):
                op = sparse_inputs(post, terms, dl, avgdl, k, share, gen)
                kern = sparse_call(op, k, mm, sparse.sparse_topk_cuda)
                again = sparse_call(op, k, mm, sparse.sparse_topk_cuda)
                plain = sparse_call(op, k, mm, sparse.sparse_topk_plain)
                torch.cuda.synchronize()
                what = f"B6a {docs} docs {mode} query {qi}"
                if not same_bits(kern, again):
                    raise AssertionError(f"{what}: two launches differ")
                e, d = check_b6(*kern, *plain, what)
                cpu_op = {key: v.cpu() if torch.is_tensor(v) else v
                          for key, v in op.items()}
                cpu = sparse_call(cpu_op, k, mm, sparse.sparse_topk_plain)
                if not same_bits([t.cpu() for t in kern], cpu):
                    raise AssertionError(
                        f"{what}: the page differs from the CPU plain "
                        f"version's bits")
                cpu_equal += 1
                max_err, diffs, cases = max(max_err, e), diffs + d, cases + 1
                if qi == 0:
                    timed = {
                        "entries": op["entries"], "terms": len(terms),
                        "space": op["allow"].numel(), "k": k,
                        "ctas": sparse.sparse_ctas(op["allow"].numel()),
                        "kept": int((kern[1] >= 0).sum()),
                        "ms": float(np.median(cuda_ms(lambda: sparse_call(
                            op, k, mm, sparse.sparse_topk_cuda), 20))),
                        "plain_ms": float(np.median(cuda_ms(
                            lambda: sparse_call(
                                op, k, mm, sparse.sparse_topk_plain), 5))),
                        "bound_ms": b6a_bound_ms(op, k, mm)}
            out[mode] = timed
        tenants[str(docs)] = {"vocab": MS_VOCAB,
                              "edges": int(post["docs"].numel()),
                              "modes": out}
        del post
    # the C entry's doc range per CTA is the wrapper's
    for space in (1, 512, 8192, 65536, 1 << 20, (1 << 31) - 1):
        if sparse._library().sparse_range(space) != sparse.sparse_range(
                space):
            raise AssertionError(f"B6a's range at {space} docs: the C entry "
                                 f"and the wrapper differ")
    return {"cases": cases, "max_abs_err": max_err,
            "ids_differing_in_ties": diffs,
            "bitwise_equal_to_cpu_plain": f"{cpu_equal}/{cases}",
            "tenants": tenants, "tolerance": {"rtol": RTOL_B6}}


def fusion_inputs(legs: int, width: int, union: int, seed: int):
    """Random slot matrices on the card: -1 pads, a slot repeated within a
    leg (at positions 0, 1 and, where the leg is that long, 40 and 63),
    slots past the union, scores rounded to one decimal (ties)."""
    rng = np.random.default_rng(seed)
    slots = rng.integers(0, union + 4, (legs, width)).astype(np.int32)
    slots[rng.random((legs, width)) < 0.2] = -1
    slots[0, [j for j in (0, 1, 40, 63) if j < width]] = 3
    scores = np.round(rng.normal(size=(legs, width)), 1).astype(np.float32)
    weights = rng.random(legs).astype(np.float32)
    dev = torch.device("cuda")
    return (torch.from_numpy(slots).to(dev), torch.from_numpy(scores).to(dev),
            torch.from_numpy(weights).to(dev))


def fusion_call(algo: str, slots, scores, weights, k: int, union: int,
                kernel: bool):
    if kernel:
        return fusion.fusion_topk_cuda(
            slots, None if algo == "rankedFusion" else scores, weights, k,
            union)
    if algo == "rankedFusion":
        return fusion.ranked_fusion_plain(slots, weights, k, union)
    return fusion.relative_score_fusion_plain(slots, scores, weights, k,
                                              union)


def b6b_bound_ms(slots, k: int) -> float:
    """B6b's bytes over the memory rate: the slots, scores and weights read
    once, the page written once."""
    legs, width = slots.shape
    return (legs * width * 8 + legs * 4 + k * 8) / HBM_BYTES_S * 1e3


def b6_fusion_grid(seed: int) -> dict:
    """B6b over B6B_SHAPES, both algorithms, each against the plain version
    on the card, two launches compared bit for bit, and the plain version
    on the CPU compared bit for bit and reported; each timed."""
    out, max_err, diffs, cpu_equal, cases = {}, 0.0, 0, 0, 0
    for si, (legs, width, union, k) in enumerate(B6B_SHAPES):
        slots, scores, weights = fusion_inputs(legs, width, union,
                                               seed + si)
        for algo in ("relativeScoreFusion", "rankedFusion"):
            args = (algo, slots, scores, weights, k, union)
            kern = fusion_call(*args, True)
            again = fusion_call(*args, True)
            plain = fusion_call(*args, False)
            torch.cuda.synchronize()
            what = f"B6b {algo} {legs}x{width} union {union}"
            if not same_bits(kern, again):
                raise AssertionError(f"{what}: two launches differ")
            e, d = check_b6(*kern, *plain, what)
            cpu = fusion_call(algo, slots.cpu(), scores.cpu(),
                              weights.cpu(), k, union, False)
            if not same_bits([t.cpu() for t in kern], cpu):
                raise AssertionError(f"{what}: the page differs from the "
                                     f"CPU plain version's bits")
            cpu_equal += 1
            max_err, diffs, cases = max(max_err, e), diffs + d, cases + 1
            out[f"{algo}_{legs}x{width}_u{union}_k{k}"] = {
                "path": fusion.fusion_path(legs, width, union, k),
                "ms": float(np.median(cuda_ms(
                    lambda: fusion_call(*args, True), 20))),
                "plain_ms": float(np.median(cuda_ms(
                    lambda: fusion_call(*args, False), 10))),
                "bound_ms": b6b_bound_ms(slots, k)}
    return {"cases": cases, "max_abs_err": max_err,
            "ids_differing_in_ties": diffs,
            "bitwise_equal_to_cpu_plain": f"{cpu_equal}/{cases}",
            "shapes": out, "tolerance": {"rtol": RTOL_B6}}


def gen_block(t: int, per: int, centers: np.ndarray) -> np.ndarray:
    """bench_msmarco's tenant vectors: unit rows from the tenant's draws of
    the 2,048 centres with noise 0.4."""
    g = np.random.default_rng(1000 + t)
    assign = g.integers(0, 2048, per)
    blk = centers[assign] + 0.4 * g.standard_normal(
        (per, centers.shape[1])).astype(np.float32)
    blk /= np.linalg.norm(blk, axis=1, keepdims=True) + 1e-12
    return blk


def tenant_texts(post: dict) -> tuple[list[str], np.ndarray]:
    """Each doc's text: its terms, each written tf times, and its length,
    the sum of its tfs (the collection counts the tokens it indexes, so
    bench_msmarco's separate lengths of 40-89 do not apply here)."""
    docs = post["docs"].cpu().numpy()
    terms = post["terms"].cpu().numpy()
    tf = post["tf"].cpu().numpy().astype(np.int64)
    order = np.argsort(docs, kind="stable")
    words = np.array([f"t{r}" for r in range(MS_VOCAB)], dtype=object)
    toks = np.repeat(words[terms[order]], tf[order])
    ends = np.cumsum(np.bincount(np.repeat(docs[order], tf[order]),
                                 minlength=post["per"]))
    starts = np.concatenate([[0], ends[:-1]])
    texts = [" ".join(toks[a:b]) for a, b in zip(starts, ends)]
    return texts, (ends - starts).astype(np.float32)


def hybrid_truth(post: dict, dl: torch.Tensor, blk: torch.Tensor, terms,
                 qv: torch.Tensor) -> list[int]:
    """The exact hybrid page of one query as bench_msmarco builds it: dense
    BM25 over the tenant's postings and exact float32 cosine, the top
    HYBRID_GT_FETCH of each, fused by relativeScoreFusion (the host twin);
    doc rows."""
    per = post["per"]
    avgdl = float(dl.mean())
    scores = torch.zeros(per, dtype=torch.float32, device="cuda")
    b = post["bounds"]
    for t in terms:
        lo, hi = int(b[t]), int(b[t + 1])
        ids = post["docs"][lo:hi].long()
        tf = post["tf"][lo:hi]
        denom = tf + MS_K1 * (1 - MS_B + MS_B * dl[ids] / avgdl)
        scores.index_add_(0, ids, bm25_idf(per, hi - lo) * tf
                          * (MS_K1 + 1) / denom)
    top = torch.sort(scores, descending=True, stable=True).indices[
        :HYBRID_GT_FETCH]
    bm_set = [(d, s) for d, s in zip(top.tolist(), scores[top].tolist())
              if s > 0]
    dist = 1.0 - blk @ qv
    vtop = torch.sort(dist, stable=True).indices[:HYBRID_GT_FETCH]
    vec_set = [(d, -s) for d, s in zip(vtop.tolist(), dist[vtop].tolist())]
    fused = relative_score_fusion([bm_set, vec_set],
                                  [1 - MS_ALPHA, MS_ALPHA], K)
    return [d for d, _ in fused]


def _numel0(a) -> int:
    """The entries or slots of a B6 launch: its first argument's size."""
    return a[0].numel()


def check_pages(got, want, what: str) -> None:
    """Two [(object, score)] pages of one request: scores to RTOL_B6,
    uuids equal except inside near ties."""
    gs = np.asarray([s for _, s in got])
    ws = np.asarray([s for _, s in want])
    if len(gs) != len(ws) or not np.allclose(gs, ws, rtol=RTOL_B6,
                                             atol=1e-6):
        raise AssertionError(f"{what}: scores differ {gs} {ws}")
    for i, ((a, _), (b, _)) in enumerate(zip(got, want)):
        near = [ws[x] for x in (i - 1, i + 1) if 0 <= x < len(ws)]
        if a.uuid != b.uuid and not any(
                abs(v - ws[i]) <= RTOL_B6 * abs(ws[i]) for v in near):
            raise AssertionError(f"{what}: hit {i} differs outside a tie")


def leg_ms() -> dict:
    """Summed seconds and counts of the hybrid legs so far."""
    out = {}
    for leg in ("sparse", "dense"):
        key = (("leg", leg),)
        out[leg] = (HYBRID_LEG_SECONDS._sums.get(key, 0.0),
                    HYBRID_LEG_SECONDS._totals.get(key, 0))
    return out


def phase_hybrid(seed: int, state: dict) -> dict:
    """BASELINE.json config 5 through the user's entry points, cut 7:
    ``DB`` -> one multi-tenant ``Collection`` of MS_TENANTS tenants of
    HYBRID_DOCS objects (text from bench_msmarco's Zipf vocabulary, an int
    ``bucket``, 768-d cosine vectors in an SQ flat index), then
    HYBRID_REQUESTS hybrid requests a pass: unfiltered (WAND + Q2 + B6b),
    under ``bucket == 7`` (1%) and ``bucket < 45`` (45%; the device sparse
    leg, B6a), rankedFusion, ``bm25_search(device_scoring=True)``, and one
    aggregate a tenant."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    centers = np.random.default_rng(99).standard_normal(
        (2048, QUANT_DIMS)).astype(np.float32)
    rng = np.random.default_rng(seed + 13)
    tenants = []
    for t in range(MS_TENANTS):
        post = zipf_postings(HYBRID_DOCS, 1000 + t)
        texts, lens = tenant_texts(post)
        tenants.append({
            "name": f"tenant{t}", "post": post, "texts": texts,
            "dl": torch.from_numpy(lens).cuda(),
            "vecs": gen_block(t, HYBRID_DOCS, centers),
            "bucket": rng.integers(0, 100, HYBRID_DOCS),
            "uuids": _uuids(rng, HYBRID_DOCS)})
    # bench_msmarco's query pool: terms from tenant 0's df, vectors near a
    # row of the request's tenant
    pool = query_pool(tenants[0]["post"]["df"], HYBRID_REQUESTS, 5)
    rng_q = np.random.default_rng(5)
    qvecs = np.empty((HYBRID_REQUESTS, QUANT_DIMS), np.float32)
    for t in range(MS_TENANTS):
        sel = np.arange(t, HYBRID_REQUESTS, MS_TENANTS)
        qv = tenants[t]["vecs"][rng_q.integers(0, HYBRID_DOCS, len(sel))] \
            + 0.25 * rng_q.standard_normal(
                (len(sel), QUANT_DIMS)).astype(np.float32)
        qvecs[sel] = qv / (np.linalg.norm(qv, axis=1, keepdims=True) + 1e-12)
    data_s = time.perf_counter() - t0
    root = tempfile.mkdtemp(prefix="chip_smoke_hybrid_")
    try:
        out = _drive_hybrid(state, root, tenants, pool, qvecs)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["data_s"] = data_s
    return out


def _drive_hybrid(state, root, tenants, pool, qvecs) -> dict:
    db = DB(root)
    col = db.create_collection(CollectionConfig(
        name="Msmarco",
        properties=[Property("body", DataType.TEXT),
                    Property("bucket", DataType.INT)],
        vector_config=FlatIndexConfig(
            distance="cosine", initial_capacity=HYBRID_DOCS,
            quantizer=SQConfig(rescore_limit=SQ_RESCORE)),
        multi_tenancy=MultiTenancyConfig(enabled=True)))
    t0 = time.perf_counter()
    for ten in tenants:
        col.add_tenant(ten["name"])
        for s in range(0, HYBRID_DOCS, DB_BATCH):
            e = min(HYBRID_DOCS, s + DB_BATCH)
            col.put_batch([StorageObject(
                uuid=ten["uuids"][i], collection="Msmarco",
                vector=ten["vecs"][i],
                properties={"body": ten["texts"][i],
                            "bucket": int(ten["bucket"][i])})
                for i in range(s, e)], tenant=ten["name"])
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    n_obj = MS_TENANTS * HYBRID_DOCS
    texts = [" ".join(f"t{r}" for r in terms) for terms in pool]

    def tenant_of(i):
        return tenants[i % MS_TENANTS]

    filters = {"unfiltered": None,
               "one_pct": Where.eq("bucket", FILTER_BUCKET),
               "near_half": Where.lt("bucket", BEAM_FILTER_BUCKETS)}
    allowed = {"unfiltered": lambda b: True,
               "one_pct": lambda b: b == FILTER_BUCKET,
               "near_half": lambda b: b < BEAM_FILTER_BUCKETS}

    def request(name, i):
        ten = tenant_of(i)
        if name == "bm25_device":
            return col.bm25_search(texts[i], K, tenant=ten["name"],
                                   device_scoring=True)
        return col.hybrid_search(
            query=texts[i], vector=qvecs[i], alpha=MS_ALPHA, k=K,
            fusion="rankedFusion" if name == "ranked"
            else "relativeScoreFusion",
            flt=filters.get(name), tenant=ten["name"])

    # warm each route once (kernels built, first launches) outside the
    # counted drive
    for name in ("unfiltered", "near_half", "bm25_device"):
        request(name, 0)
    passes = ("unfiltered", "one_pct", "near_half", "ranked", "bm25_device")
    res, per_pass, last = {}, {}, {}
    # the main path's drive: every count at 0 just before, read just after
    sparse.sparse_topk_cuda.launches = 0
    fusion.fusion_topk_cuda.launches = 0
    q2_before = quantized.sq_search.launches
    with KernelSpy(sparse, "sparse_topk_cuda", _numel0) as b6a_spy, \
            KernelSpy(fusion, "fusion_topk_cuda", _numel0) as b6b_spy:
        for name in passes:
            counts = (sparse.sparse_topk_cuda.launches,
                      fusion.fusion_topk_cuda.launches,
                      quantized.sq_search.launches)
            legs = leg_ms()
            ms, rows = [], []
            for i in range(HYBRID_REQUESTS):
                t1 = time.perf_counter()
                rows.append(request(name, i))
                ms.append((time.perf_counter() - t1) * 1e3)
            after = leg_ms()
            res[name] = rows
            last[name] = (b6a_spy.widest, b6b_spy.widest)
            b6a_spy.widest = b6b_spy.widest = None
            per_pass[name] = {
                "p50_ms": float(np.median(ms)),
                "p99_ms": float(np.percentile(ms, 99)),
                "b6a_launches": sparse.sparse_topk_cuda.launches - counts[0],
                "b6b_launches": fusion.fusion_topk_cuda.launches - counts[1],
                "q2_launches": quantized.sq_search.launches - counts[2],
                **{f"{leg}_leg_ms": ((after[leg][0] - legs[leg][0])
                                     / max(1, after[leg][1] - legs[leg][1])
                                     * 1e3) for leg in legs}}
    b6a_launches = sparse.sparse_topk_cuda.launches
    b6b_launches = fusion.fusion_topk_cuda.launches
    q2_launches = quantized.sq_search.launches - q2_before
    if b6b_launches <= 0 or per_pass["unfiltered"]["b6b_launches"] <= 0:
        raise AssertionError("the hybrid requests launched no B6b")
    if b6a_launches <= 0 or per_pass["near_half"]["b6a_launches"] <= 0:
        raise AssertionError("the filtered sparse legs launched no B6a")
    # the pages: finite, descending, inside their filter; full where the
    # dense leg has ten allowed rows to give
    for name, rows in res.items():
        for i, row in enumerate(rows):
            sc = [s for _, s in row]
            if not all(np.isfinite(sc)) or sc != sorted(sc, reverse=True):
                raise AssertionError(f"{name} request {i}: bad page {sc}")
            if name in ("unfiltered", "ranked", "near_half") and \
                    len(row) != K:
                raise AssertionError(f"{name} request {i}: {len(row)} hits")
            ok = allowed.get(name, allowed["unfiltered"])
            if not all(ok(o.properties["bucket"]) for o, _ in row):
                raise AssertionError(f"{name} request {i}: filter broken")
    # B6a's pages against WAND's on the same collection
    for i in range(0, HYBRID_REQUESTS, 16):
        check_pages(res["bm25_device"][i],
                    col.bm25_search(texts[i], K, tenant=tenant_of(i)["name"]),
                    f"bm25 device vs WAND, request {i}")
    # recall@10 against the exact hybrid ranking
    recalls = []
    for t, ten in enumerate(tenants):
        blk = torch.from_numpy(ten["vecs"]).cuda()
        for i in range(t, HYBRID_REQUESTS, MS_TENANTS):
            gt = hybrid_truth(ten["post"], ten["dl"], blk, pool[i],
                              torch.from_numpy(qvecs[i]).cuda())
            served = {o.uuid for o, _ in res["unfiltered"][i]}
            recalls.append(len(served & {ten["uuids"][d] for d in gt}) / K)
        del blk
    # one aggregate a tenant
    t1 = time.perf_counter()
    for ten in tenants:
        agg = col.aggregate({"bucket": "numeric", "body": "text"},
                            tenant=ten["name"], top_occurrences_limit=5)
        if agg["meta"]["count"] != HYBRID_DOCS or \
                agg["properties"]["bucket"]["count"] != HYBRID_DOCS:
            raise AssertionError(f"aggregate {ten['name']}: {agg['meta']}")
    aggregate_ms = (time.perf_counter() - t1) * 1e3 / MS_TENANTS
    # B6a (the 45% filter's sparse leg) and B6b (the unfiltered pass's
    # fusion) on the main path's widest inputs: each against its plain
    # version, then timed (launches made here are not the drive's, read
    # above)
    (a_args, a_kw), _ = last["near_half"]
    _, (b_args, b_kw) = last["unfiltered"]
    kv, ki = sparse.sparse_topk_cuda(*a_args, **a_kw)
    err_a, _ = check_b6(kv, ki, *sparse.sparse_topk_plain(*a_args, **a_kw),
                        "B6a on the main path")
    slots, scores, weights, k, union = b_args

    def plain_b():
        if scores is None:
            return fusion.ranked_fusion_plain(slots, weights, k, union)
        return fusion.relative_score_fusion_plain(slots, scores, weights, k,
                                                  union)

    err_b, _ = check_b6(*fusion.fusion_topk_cuda(*b_args, **b_kw),
                        *plain_b(), "B6b on the main path")
    op = {"entries": int((a_args[0] >= 0).sum()), "allow": a_args[6],
          "seg": a_args[3]}
    state["kernel_b6_sparse"] = {
        "name": "sparse_topk", "route": "cuda",
        "source": "weaviate_tpu_torch/csrc/hybrid.cu",
        "replaces": "weaviate_tpu/ops/sparse.py:82",
        "launches": b6a_launches, "max_abs_err": err_a,
        "ms": float(np.median(cuda_ms(
            lambda: sparse.sparse_topk_cuda(*a_args, **a_kw), 50))),
        "plain_ms": float(np.median(cuda_ms(
            lambda: sparse.sparse_topk_plain(*a_args, **a_kw), 20))),
        "bound_ms": b6a_bound_ms(op, a_args[7],
                                 a_args[12] if len(a_args) > 10 else 0),
        "bound_by": "bytes", "library_ms": None,
        "entries": op["entries"], "space": int(a_args[6].numel())}
    state["kernel_b6_fusion"] = {
        "name": "fusion_topk", "route": "cuda",
        "source": "weaviate_tpu_torch/csrc/hybrid.cu",
        "replaces": "weaviate_tpu/ops/fusion.py:90",
        "launches": b6b_launches, "max_abs_err": err_b,
        "ms": float(np.median(cuda_ms(
            lambda: fusion.fusion_topk_cuda(*b_args, **b_kw), 50))),
        "plain_ms": float(np.median(cuda_ms(plain_b, 20))),
        "bound_ms": b6b_bound_ms(slots, k),
        "bound_by": "bytes", "library_ms": None,
        "shape": [int(slots.shape[0]), int(slots.shape[1]), int(union), k]}
    peak = torch.cuda.max_memory_allocated()
    t1 = time.perf_counter()
    db.close()
    close_s = time.perf_counter() - t1
    return {"tenants": MS_TENANTS, "docs_per_tenant": HYBRID_DOCS,
            "docs_configured_per_tenant": MS_TENANT_DOCS,
            "objects": n_obj, "ingest_s": ingest_s,
            "objects_per_s": n_obj / ingest_s,
            "requests_per_pass": HYBRID_REQUESTS, "alpha": MS_ALPHA,
            "k": K, "passes": per_pass,
            "recall_at_10": float(np.mean(recalls)),
            "recall_fetch": {"served_per_leg": 2 * K,
                             "truth_per_leg": HYBRID_GT_FETCH},
            "b6a_launches": b6a_launches, "b6b_launches": b6b_launches,
            "q2_launches": q2_launches,
            "b6a": state["kernel_b6_sparse"],
            "b6b": state["kernel_b6_fusion"],
            "aggregate_ms": aggregate_ms, "close_s": close_s,
            "peak_device_bytes": peak, "card": state["card"]}


# ---------------------------------------------------------------------------
# slice 7a: the rerank stage (B7a), multivector, multi-target (B7b)
# ---------------------------------------------------------------------------

# B7a against its plain version: float32 sums of the same products in
# another order, scores of unit-norm tokens (at most Tq = 32 a score)
B7A_ATOL, B7A_RTOL = 2e-4, 1e-5
B7A_GRID = dict(tq=(1, 32), t=(4, 256), d=(128, 768), c=(64, 1024),
                out_k=(8, 64))
# and the kernel's other paths: (b, tq, t, d, c, out_k) with D off 16-byte
# rows (4-byte copies), two passes of query-token rows, D past one staged
# chunk with 64 query tokens, scores staged past 48 KB, and scores past
# shared memory (ranked from L2)
B7A_EDGES = ((2, 5, 8, 99, 100, 10), (2, 40, 16, 128, 256, 32),
             (1, 64, 4, 2048, 64, 8), (1, 1, 4, 128, 20_000, 64),
             (1, 2, 4, 64, 60_000, 64))
# the multivector cell: ColBERTv2's shapes (colbert-ir/colbertv2.0: 128-d
# L2-normalised tokens, documents of up to 180 tokens, queries of 32) and
# Weaviate's MUVERA defaults (ksim 4, dprojections 16, repetitions 10), at
# 16,384 documents (cut 9: 32,768 left the script 26 s under its limit on a
# slow host, its host-bound ingest 82 s of that)
MV_DOCS, MV_DIMS, MV_TQ = 16_384, 128, 32
MV_TOKENS = (40, 180)
MV_QUERIES, MV_BATCH, MV_SEED = 256, 1024, 41
# documents in clusters of 16 that share 6 of their 10 topics (4,096 topic
# centres); a token is a topic centre + noise of norm about 1, normalised;
# a query token a document token + noise of norm about 0.5, normalised
MV_TOPICS, MV_CLUSTER, MV_SHARED, MV_OWN = 4096, 16, 6, 4
MV_TOKEN_NOISE, MV_QUERY_NOISE = 1.0, 0.5
# the HNSW rerank cell: bench.py bench_rerank's configuration
RR_ROWS, RR_DIMS, RR_TOKENS, RR_BATCH, RR_QUERIES = 32_768, 128, 4, 64, 64
# the multi-target cell: bench.py bench_multitarget's 2t corpus
MT_ROWS, MT_DIMS, MT_QUERIES = 32_768, {"a": 768, "b": 256}, 32
# the fused search joins the same walks as the host oracle, so their top
# 10s agree: less agreement than this is a fault
MT_MIN_ORACLE_RECALL = 0.9
MT_COMBOS = (("sum", None), ("average", None), ("minimum", None),
             ("manualWeights", {"a": 0.7, "b": 0.3}),
             ("relativeScore", {"a": 0.7, "b": 0.3}))


def unit_rows(gen, shape) -> torch.Tensor:
    x = torch.randn(*shape, generator=gen, device="cuda")
    return (x / (x.norm(dim=-1, keepdim=True) + 1e-12)).contiguous()


def b7a_bound_ms(cand, tmask, qm, d: int) -> tuple[float, str, dict]:
    """The least time of one B7a launch on this run's inputs: the valid
    candidates' kept tokens read once (D float32 and a mask byte each),
    their mask rows, the query tokens, the ids and the outputs, over the
    memory rate, against 2 x (kept query tokens) x (kept candidate
    tokens) x D float32 operations over the float32 peak."""
    n = tmask.shape[0]
    ok = (cand >= 0) & (cand < n)
    rows = cand.clamp(0, n - 1).long()
    kept = (tmask[rows].sum(-1) * ok).to(torch.float64)       # [B, C]
    qkept = qm.sum(-1).to(torch.float64)                        # [B]
    t = tmask.shape[1]
    nbytes = float(kept.sum() * (4 * d) + ok.sum() * t
                   + qm.numel() * (4 * d + 1) + cand.numel() * 4)
    flops = float(2 * (qkept[:, None] * kept).sum() * d)
    tb, to = nbytes / HBM_BYTES_S, flops / FP32_FLOP_S
    return (max(tb, to) * 1e3, "bytes" if tb >= to else "operations",
            {"bytes": nbytes, "flops": flops})


def check_b7a(args, module, out_k: int) -> dict:
    """B7a against its plain version on the same inputs: scores within
    B7A_ATOL + B7A_RTOL * |plain|, sentinel slots alike, and where ids
    differ the kernel's id scores (in the plain version) within that
    tolerance of the plain score at the slot: a near tie."""
    cand, tokens, tmask, q, qm = args
    ki, kd = rerank.rerank_topk_cuda(*args, module, out_k)
    pi, pd = rerank.rerank_topk_plain(*args, module, out_k)
    valid, sc = rerank._module_scores(module, cand, tokens, tmask, q, qm)
    sc = torch.where(valid, sc, -torch.inf)
    torch.cuda.synchronize()
    live = pd < MASK_DISTANCE
    tol = B7A_ATOL + B7A_RTOL * pd.abs()
    err = (kd - pd).abs()
    if bool((err[live] > tol[live]).any()):
        raise AssertionError(f"B7a scores differ: max {err[live].max()}")
    if not bool(((ki == -1) == ~live).all() and ((pi == -1) == ~live).all()
                and (kd[~live] >= MASK_DISTANCE).all()):
        raise AssertionError("B7a sentinel slots differ from (-1, mask)")
    diff = (ki != pi) & live
    if bool(diff.any()):
        eq = cand[:, None, :] == ki[:, :, None]
        own = torch.where(eq, sc[:, None, :], -torch.inf).amax(-1)
        if bool(((-own - pd).abs() > tol)[diff].any()):
            raise AssertionError("B7a ids differ beyond a near tie")
    n_live = int(live.sum())
    return {"max_abs_err": float(err[live].max()) if n_live else 0.0,
            "slots": n_live, "near_ties": int(diff.sum())}


def b7_rerank_grid(seed: int) -> dict:
    """B7a over Tq, T, D, C and out_k of B7A_GRID and both modules, on
    unit-norm token planes with partly masked rows (a kept prefix of 1 to
    T tokens), fully masked rows, twin rows (exact ties between ids), a
    repeated id, -1 pads and masked query tokens; B = 2 (3 at the small
    shapes)."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 71)
    modules = (MaxSimRerank(), LinearRerank(w_max=1.0, w_mean=0.25,
                                            bias=0.5))
    cases, worst, slots, ties = 0, 0.0, 0, 0
    for t in B7A_GRID["t"]:
        for d in B7A_GRID["d"]:
            for c in B7A_GRID["c"]:
                n = c + 64
                tokens = unit_rows(gen, (n, t, d))
                keep = torch.randint(1, t + 1, (n,), generator=gen,
                                     device="cuda")
                tmask = torch.arange(t, device="cuda")[None, :] < keep[:, None]
                tmask[::17] = False               # row 0 among them
                tokens[3] = tokens[2]             # twins: exact ties
                tmask[3] = tmask[2]
                b = 2 if t * d * c > 64 * 768 * 64 else 3
                cand = torch.randint(0, n, (b, c), generator=gen,
                                     device="cuda", dtype=torch.int32)
                cand[:, 0], cand[:, 1], cand[:, 2] = 0, 2, 3
                cand[:, 4] = cand[:, 5]           # a repeated id
                cand[:, c - c // 8:] = -1
                for tq in B7A_GRID["tq"]:
                    q = unit_rows(gen, (b, tq, d))
                    qm = torch.ones((b, tq), dtype=torch.bool, device="cuda")
                    qm[:, tq - tq // 4:] = False
                    for out_k in B7A_GRID["out_k"]:
                        for module in modules:
                            r = check_b7a((cand, tokens, tmask, q, qm),
                                          module, out_k)
                            cases += 1
                            worst = max(worst, r["max_abs_err"])
                            slots += r["slots"]
                            ties += r["near_ties"]
                del q, qm
                del tokens, tmask, cand
                torch.cuda.empty_cache()
    for b, tq, t, d, c, out_k in B7A_EDGES:
        n = c + 64
        tokens = unit_rows(gen, (n, t, d))
        keep = torch.randint(1, t + 1, (n,), generator=gen, device="cuda")
        tmask = torch.arange(t, device="cuda")[None, :] < keep[:, None]
        cand = torch.randint(-1, n, (b, c), generator=gen, device="cuda",
                             dtype=torch.int32)
        q = unit_rows(gen, (b, tq, d))
        qm = torch.ones((b, tq), dtype=torch.bool, device="cuda")
        for module in modules:
            r = check_b7a((cand, tokens, tmask, q, qm), module, out_k)
            cases += 1
            worst = max(worst, r["max_abs_err"])
            slots += r["slots"]
            ties += r["near_ties"]
        del tokens, tmask, cand, q, qm
        torch.cuda.empty_cache()
    return {"cases": cases, "max_abs_err": worst, "slots": slots,
            "near_ties": ties,
            "tolerance": {"atol": B7A_ATOL, "rtol": B7A_RTOL}}


def join_legs(gen) -> list:
    """One leg a row type, each its own capacity: (name, scorer, operands,
    queries [8, ...], present [cap])."""
    b = 8
    specs = (("raw", "cosine", 96, 3000), ("bq", "l2-squared", 256, 2500),
             ("sq", "l2-squared", 128, 3000), ("pq", "l2-squared", 128, 2000),
             ("rq", "cosine", 128, 3000))
    legs = []
    for kind, metric, d, cap in specs:
        rows = torch.randn(cap, d, generator=gen, device="cuda")
        q = rows[:b] + 0.1 * torch.randn(b, d, generator=gen, device="cuda")
        if kind == "raw":
            scorer = device_beam.RawScorer(metric, "bf16")
            ops, qrep = (normalize(rows).contiguous(),), normalize(q)
        else:
            scorer, ops, qrep = quant_walk_inputs(kind, metric, rows, q,
                                                  segments=16)
        present = torch.rand(cap, generator=gen, device="cuda") < 0.9
        legs.append((kind, scorer, ops, qrep.contiguous(), present))
    return legs


def join_pools(gen, legs, fetch: int) -> list:
    """[8, fetch + 8] pools: ids up to 200 past the widest capacity, the
    first quarter of each shared with the first pool (duplicates across
    pools), a repeat inside a pool, -1 pads."""
    top = max(leg[4].shape[0] for leg in legs) + 200
    pools = []
    for i in range(len(legs)):
        p = torch.randint(0, top, (8, fetch + 8), generator=gen,
                          device="cuda", dtype=torch.int32)
        if pools:
            p[:, : fetch // 4] = pools[0][:, : fetch // 4]
        p[:, fetch // 2] = p[:, fetch // 2 + 1]
        p[:, fetch - 3:fetch] = -1
        pools.append(p.contiguous())
    return pools


def check_b7b(args, fetch: int, join: str) -> dict:
    """B7b against its plain version: joined distances slot for slot
    within ATOL + RTOL * |plain|, sentinel slots alike, no id twice; where
    ids differ, the kernel's id is in the plain version's union with a
    joined distance within that tolerance of the plain one at the slot: a
    near tie."""
    ki, kd = device_beam.mt_join_topk_cuda(*args, fetch, join)
    pi, pd = device_beam.mt_join_topk_plain(*args, fetch, join)
    union, joined = device_beam._mt_joined(*args, fetch, join)
    torch.cuda.synchronize()
    live = pd < MASK_DISTANCE
    tol = ATOL + RTOL * pd.abs()
    err = (kd - pd).abs()
    if bool((err[live] > tol[live]).any()):
        raise AssertionError(f"B7b distances differ: max {err[live].max()}")
    if not bool(((ki == -1) == ~live).all() and ((pi == -1) == ~live).all()):
        raise AssertionError("B7b sentinel slots differ from -1")
    for row in ki.cpu().numpy():
        row = row[row >= 0]
        if len(np.unique(row)) != len(row):
            raise AssertionError("B7b returned an id twice")
    diff = (ki != pi) & live
    if bool(diff.any()):
        eq = union[:, None, :] == ki[:, :, None].long()
        own = torch.where(eq, joined[:, None, :], torch.inf).amin(-1)
        if bool(((own - pd).abs() > tol)[diff].any()):
            raise AssertionError("B7b ids differ beyond a near tie")
    n_live = int(live.sum())
    return {"max_abs_err": float(err[live].max()) if n_live else 0.0,
            "slots": n_live, "near_ties": int(diff.sum())}


def b7_join_grid(seed: int) -> dict:
    """B7b over 2 and 3 targets of every row type (raw bf16 cosine, BQ,
    SQ, PQ through its ADC table, RQ), fetch 64 and 256, the three joins,
    on pools with duplicates across pools, members missing a target (a
    tenth of each target's rows absent) and ids past a target's
    capacity."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 73)
    legs = join_legs(gen)
    combos = ((0, 1), (2, 3), (4, 0), (0, 2, 4), (1, 3, 2))
    cases, worst, slots, ties = 0, 0.0, 0, 0
    kinds = set()
    for combo in combos:
        sel = [legs[i] for i in combo]
        kinds.update(leg[0] for leg in sel)
        for fetch in (64, 256):
            pools = join_pools(gen, sel, fetch)
            w = 0.2 + torch.rand(8, len(sel), generator=gen, device="cuda")
            args = ([leg[1] for leg in sel], [leg[3] for leg in sel],
                    [leg[2] for leg in sel], [leg[4] for leg in sel], pools,
                    w.contiguous())
            for join in ("weighted", "minimum", "relative"):
                r = check_b7b(args, fetch, join)
                cases += 1
                worst = max(worst, r["max_abs_err"])
                slots += r["slots"]
                ties += r["near_ties"]
    return {"cases": cases, "row_types": sorted(kinds), "max_abs_err": worst,
            "slots": slots, "near_ties": ties,
            "tolerance": {"atol": ATOL, "rtol": RTOL}}


def exact_maxsim(q_tokens, q_mask, tokens, tmask, k: int, valid=None,
                 chunk: int = 128):
    """Exact MaxSim top-k of each query token set against every row of the
    token plane (bench.py ``_exact_maxsim_gt`` on the card: chunked
    float32 products, TF32 off, a running top-k); rows without a kept
    token, or outside ``valid``, never rank. -> (ids, scores) numpy."""
    torch.backends.cuda.matmul.allow_tf32 = False
    nq, tq, d = q_tokens.shape
    n, t, _ = tokens.shape
    qf = q_tokens.reshape(nq * tq, d)
    top_s = torch.full((nq, k), -torch.inf, device="cuda")
    top_i = torch.full((nq, k), -1, dtype=torch.long, device="cuda")
    live = tmask.any(1) if valid is None else (tmask.any(1) & valid)
    for s in range(0, n, chunk):
        e = min(n, s + chunk)
        sims = (qf @ tokens[s:e].reshape(-1, d).T).reshape(nq, tq, e - s, t)
        sims = torch.where(tmask[s:e][None, None], sims, -torch.inf)
        best = sims.amax(-1)
        best = torch.where(torch.isfinite(best), best, 0.0)
        best = torch.where(q_mask[:, :, None], best, 0.0)
        sc = torch.where(live[s:e][None], best.sum(1), -torch.inf)
        ms = torch.cat([top_s, sc], 1)
        mi = torch.cat([top_i, torch.arange(s, e, device="cuda").expand(
            nq, -1)], 1)
        top_s, sel = ms.topk(k, dim=1)
        top_i = torch.gather(mi, 1, sel)
    return top_i.cpu().numpy(), top_s.cpu().numpy()


def ndcg_at_k(result_ids, gt_ids, gt_scores, k: int) -> float:
    """bench.py ``_ndcg_at_k``: NDCG@k with the exact MaxSim scores as
    graded gains (min-shifted per query); ids outside the truth gain 0."""
    out = []
    log2 = np.log2(np.arange(2, k + 2))
    for i in range(len(result_ids)):
        floor = float(gt_scores[i].min())
        gains = {int(d): max(0.0, float(s) - floor) + 1e-9
                 for d, s in zip(gt_ids[i], gt_scores[i])}
        dcg = sum(gains.get(int(d), 0.0) / log2[j]
                  for j, d in enumerate(result_ids[i][:k]))
        idcg = sum(g / log2[j] for j, g in enumerate(
            sorted(gains.values(), reverse=True)[:k]))
        out.append(dcg / idcg if idcg > 0 else 0.0)
    return float(np.mean(out))


def b7a_entry(args, module, out_k: int, launches: int, iters: int = 50
              ) -> dict:
    """B7a at a main path's captured inputs: its time, its plain version's
    and its bound, beside its launches on the main path."""
    err = check_b7a(args, module, out_k)["max_abs_err"]
    ms = cuda_ms(lambda: rerank.rerank_topk_cuda(*args, module, out_k),
                 iters)
    plain = cuda_ms(lambda: rerank.rerank_topk_plain(*args, module, out_k),
                    max(3, iters // 10))
    bound, by, work = b7a_bound_ms(args[0], args[2], args[4],
                                   args[1].shape[2])
    return {"ms": float(np.median(ms)), "plain_ms": float(np.median(plain)),
            "bound_ms": bound, "bound_by": by, "max_abs_err": err,
            "launches": launches, "work": work,
            "shape": {"b": int(args[0].shape[0]), "c": int(args[0].shape[1]),
                      "t": int(args[1].shape[1]), "d": int(args[1].shape[2]),
                      "tq": int(args[3].shape[1]), "out_k": out_k}}


def rerank_multivector(state: dict) -> dict:
    """The multivector cell through ``DB``: MV_DOCS documents of 40-180
    unit 128-d tokens, clustered (MV_CLUSTER documents share MV_SHARED of
    their topics), in a collection whose target is
    ``MultiVectorIndexConfig`` at MUVERA's defaults; MV_QUERIES queries of
    32 tokens jittered from a document's, k 10, one at a time."""
    gen = torch.Generator(device="cuda").manual_seed(MV_SEED)
    rng = np.random.default_rng(MV_SEED)
    t0 = time.perf_counter()
    centres = unit_rows(gen, (MV_TOPICS, MV_DIMS))
    lens = rng.integers(MV_TOKENS[0], MV_TOKENS[1] + 1, MV_DOCS)
    offs = np.concatenate([[0], np.cumsum(lens)])
    n_topics = MV_SHARED + MV_OWN
    shared = torch.randint(0, MV_TOPICS, (MV_DOCS // MV_CLUSTER + 1,
                                          MV_SHARED), generator=gen,
                           device="cuda")
    own = torch.randint(0, MV_TOPICS, (MV_DOCS, MV_OWN), generator=gen,
                        device="cuda")
    topics = torch.cat([shared[torch.arange(MV_DOCS, device="cuda")
                               // MV_CLUSTER], own], 1)
    doc_of = torch.from_numpy(np.repeat(np.arange(MV_DOCS), lens)).cuda()
    pick = torch.randint(0, n_topics, (int(offs[-1]),), generator=gen,
                         device="cuda")
    tok = centres[topics[doc_of, pick]] + MV_TOKEN_NOISE / MV_DIMS ** 0.5 \
        * torch.randn(int(offs[-1]), MV_DIMS, generator=gen, device="cuda")
    tok = (tok / tok.norm(dim=1, keepdim=True)).cpu().numpy()
    del doc_of, pick, topics
    qdoc = rng.choice(MV_DOCS, MV_QUERIES, replace=False)
    q_tokens = np.empty((MV_QUERIES, MV_TQ, MV_DIMS), np.float32)
    for i, dd in enumerate(qdoc):
        sel = rng.choice(lens[dd], MV_TQ, replace=False)
        q = tok[offs[dd] + sel] + MV_QUERY_NOISE / MV_DIMS ** 0.5 \
            * rng.standard_normal((MV_TQ, MV_DIMS)).astype(np.float32)
        q_tokens[i] = q / np.linalg.norm(q, axis=1, keepdims=True)
    uuids = _uuids(rng, MV_DOCS)
    data_s = time.perf_counter() - t0
    root = tempfile.mkdtemp(prefix="chip_smoke_multivector_")
    try:
        db = DB(root)
        col = db.create_collection(CollectionConfig(
            name="Colbert", properties=[Property("bucket", DataType.INT)],
            vector_config=MultiVectorIndexConfig(
                ksim=4, dproj=16, repetitions=10, rescore_limit=0,
                initial_capacity=MV_DOCS)))
        t1 = time.perf_counter()
        for s in range(0, MV_DOCS, MV_BATCH):
            col.put_batch([StorageObject(
                uuid=uuids[i], collection="Colbert",
                vector=tok[offs[i]:offs[i + 1]],
                properties={"bucket": i % 100})
                for i in range(s, min(MV_DOCS, s + MV_BATCH))])
        ingest_s = time.perf_counter() - t1
        idx = next(iter(col._shards.values())).vector_index()
        # the served path: launches from 0, one B7a launch a query
        with KernelSpy(rerank, "rerank_topk_cuda", None) as spy:
            l_start = spy.launches
            col.vector_search(q_tokens[0], K)
            spy.events.clear()
            spy_launch0 = spy.launches
            got, lat = [], []
            for i in range(MV_QUERIES):
                ts = time.perf_counter()
                page = col.vector_search(q_tokens[i], K)
                lat.append((time.perf_counter() - ts) * 1e3)
                got.append([o.doc_id for o, _ in page])
            launches = spy.launches - spy_launch0
            main_launches = spy.launches - l_start
            dev_ms = spy.times()
            args, kw = spy.last
        if launches != MV_QUERIES:
            raise AssertionError(f"{launches} B7a launches for "
                                 f"{MV_QUERIES} multivector searches")
        toks, tmask = idx._token_store.sync()
        valid = idx.inner.store.snapshot()[1]
        qt = torch.from_numpy(q_tokens).cuda()
        gt_ids, _ = exact_maxsim(qt, torch.ones(qt.shape[:2], dtype=torch.bool,
                                               device="cuda"), toks, tmask, K,
                                 valid=valid)
        ids = np.full((MV_QUERIES, K), -1, np.int64)
        for i, row in enumerate(got):
            ids[i, :len(row)] = row
        rec = recall(ids, gt_ids)
        entry = b7a_entry(args[:5], args[5], args[6], launches)
        peak = torch.cuda.max_memory_allocated()
        out = {"docs": MV_DOCS, "dims": MV_DIMS, "tokens": list(MV_TOKENS),
               "token_rows": int(offs[-1]), "query_tokens": MV_TQ,
               "queries": MV_QUERIES, "k": K,
               "fde_dim": idx.encoder.fde_dim, "data_s": data_s,
               "ingest_s": ingest_s, "docs_per_s": MV_DOCS / ingest_s,
               "search_p50_ms": float(np.percentile(lat, 50)),
               "search_p99_ms": float(np.percentile(lat, 99)),
               "recall_at_10": rec, "b7a_launches": launches,
               "b7a_launches_main_path": main_launches,
               "b7a_ms_median": float(np.median(dev_ms)),
               "b7a": entry,
               "token_plane_device_bytes": idx._token_store.nbytes,
               "token_plane_host_bytes": idx._token_store.host_bytes,
               "peak_device_bytes": peak}
        del toks, tmask, valid, args, kw
        db.close()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    return out


def rerank_hnsw(state: dict) -> dict:
    """The HNSW rerank tier at bench_rerank's configuration: RR_ROWS
    128-d rows around n / 2000 centres (noise 0.3), 4 jittered tokens a row
    (set_tokens), l2-squared, ef 96, ef_construction 96, M 16, insert_batch
    4096, ``RerankModuleConfig("rerank-maxsim", max_tokens=4)``; 64 queries
    (a row's tokens + 0.05 noise, their mean the query vector) one at a
    time for quality, a batch of 64 for time."""
    rng = np.random.default_rng(13)
    n, d = RR_ROWS, RR_DIMS
    centres = rng.standard_normal((max(8, n // 2000), d)).astype(np.float32)
    corpus = (centres[rng.integers(0, len(centres), n)]
              + 0.3 * rng.standard_normal((n, d))).astype(np.float32)
    tok = (corpus[:, None, :] + 0.15 * rng.standard_normal(
        (n, RR_TOKENS, d))).astype(np.float32)
    qdoc = rng.choice(n, RR_QUERIES, replace=False)
    q_tokens = (tok[qdoc] + 0.05 * rng.standard_normal(
        (RR_QUERIES, RR_TOKENS, d))).astype(np.float32)
    pooled = q_tokens.mean(axis=1)
    cfg = HNSWIndexConfig(
        distance="l2-squared", ef_construction=96, max_connections=16, ef=96,
        device_beam=True, flat_search_cutoff=0, insert_batch=4096,
        initial_capacity=n,
        rerank=RerankModuleConfig(module="rerank-maxsim",
                                  max_tokens=RR_TOKENS))
    t0 = time.perf_counter()
    idx = HNSWIndex(d, cfg)
    idx.add_batch(np.arange(n, dtype=np.int64), corpus)
    idx.set_tokens(np.arange(n, dtype=np.int64), tok)
    build_s = time.perf_counter() - t0
    toks, tmask = idx._token_store.sync(min_rows=n)
    qm = torch.ones((RR_QUERIES, RR_TOKENS), dtype=torch.bool, device="cuda")
    gt_ids, gt_s = exact_maxsim(torch.from_numpy(q_tokens).cuda(), qm, toks,
                                tmask, K, chunk=8192)
    mod = MaxSimRerank()
    quality = {}
    with KernelSpy(rerank, "rerank_topk_cuda", None) as spy:
        l_start = spy.launches
        for name in ("norerank", "rerank"):
            ids = np.full((RR_QUERIES, K), -1, np.int64)
            for i in range(RR_QUERIES):
                rr = (RerankRequest(mod, q_tokens[i]) if name == "rerank"
                      else None)
                ids[i] = idx.search(pooled[i:i + 1], K, rerank=rr).ids[0]
            quality[name] = {"recall_at_10": recall(ids, gt_ids),
                             "ndcg_at_10": ndcg_at_k(ids, gt_ids, gt_s, K)}
        # the batch: B2 and B7a launches a search, from 0
        bq = np.repeat(pooled[:1], RR_BATCH, axis=0)
        rr = RerankRequest(mod, q_tokens[0])
        idx.search(bq, K, rerank=rr)
        device_beam.fused_search.launches = 0
        l0 = spy.launches
        idx.search(bq, K, rerank=rr)
        b7a = spy.launches - l0
        args, _ = spy.last
        b2 = device_beam.fused_search.launches
        if (b2, b7a) != (1, 1):
            raise AssertionError(f"a reranked HNSW search made {b2} B2 and "
                                 f"{b7a} B7a launches, not 1 and 1")
        p_rr = host_p(lambda: idx.search(bq, K, rerank=rr), 30)
        main_launches = spy.launches - l_start
    p_plain = host_p(lambda: idx.search(bq, K), 30)
    entry = b7a_entry(args[:5], args[5], args[6], main_launches)
    del toks, tmask, idx
    torch.cuda.empty_cache()
    return {"rows": n, "dims": d, "tokens": RR_TOKENS, "ef": 96,
            "ef_construction": 96, "max_connections": 16, "batch": RR_BATCH,
            "k": K, "build_s": build_s, "quality": quality,
            "search_p50_ms": float(np.percentile(p_rr, 50)),
            "search_p99_ms": float(np.percentile(p_rr, 99)),
            "search_p50_ms_without_rerank": float(np.percentile(p_plain, 50)),
            "b2_launches_per_search": b2, "b7a_launches_per_search": b7a,
            "b7a_launches_main_path": main_launches, "b7a": entry}


def exact_multitarget(xs, qs, combination: str, weights, k: int,
                      pool: int) -> np.ndarray:
    """The brute-force multi-target answer on the card: every row's exact
    distance under each target (float64, TF32 off), joined as the
    combination joins them (``weight_row``, ``join_mode``);
    relativeScore normalises over the union of each target's exact
    top-``pool``, the pool width the fused search joins over. ``xs``
    target -> float64 rows [N, d] on the card. -> row ids [len(qs), k]."""
    torch.backends.cuda.matmul.allow_tf32 = False
    targets = list(xs)
    w = torch.from_numpy(weight_row(targets, combination, weights)).to(
        "cuda", torch.float64)
    per = []
    for t in targets:
        q = torch.from_numpy(np.stack([x[t] for x in qs])).to(
            "cuda", torch.float64)
        per.append((q * q).sum(1, keepdim=True) - 2 * q @ xs[t].T
                   + (xs[t] * xs[t]).sum(1)[None])
    dist = torch.stack(per, -1)                                # [Q, N, T]
    mode = join_mode(combination)
    if mode == "minimum":
        joined = dist.amin(-1)
    elif mode == "weighted":
        joined = (dist * w).sum(-1)
    else:
        member = torch.zeros(dist.shape[:2], dtype=torch.bool, device="cuda")
        for ti in range(len(targets)):
            member.scatter_(1, dist[:, :, ti].topk(
                pool, dim=1, largest=False).indices, True)
        m = member[:, :, None]
        lo = torch.where(m, dist, torch.inf).amin(1, keepdim=True)
        span = torch.where(m, dist, -torch.inf).amax(1, keepdim=True) - lo
        span = torch.where(span > 0, span, 1.0)
        joined = torch.where(member, (((dist - lo) / span) * w).sum(-1),
                             torch.inf)
    return joined.topk(k, dim=1, largest=False).indices.cpu().numpy()


def rerank_multitarget(state: dict) -> dict:
    """The multi-target cell through ``DB``: bench_multitarget's 2t corpus
    (targets ``a`` 768-d and ``b`` 256-d, normal rows, HNSW l2-squared, ef
    64, ef_construction 64, the fused walk) at MT_ROWS objects; MT_QUERIES
    queries (a row + 0.05 noise) under each combination, recall@10 against
    the brute-force join over every row (``exact_multitarget``) and against
    the host oracle (per-target walks 64 deep, gaps recomputed exactly).
    Asserts agreement with the oracle of at least MT_MIN_ORACLE_RECALL and
    the exact first hit in the top 10 of every query."""
    rng = np.random.default_rng(29)
    vecs = {t: rng.standard_normal((MT_ROWS, dd)).astype(np.float32)
            for t, dd in MT_DIMS.items()}
    root = tempfile.mkdtemp(prefix="chip_smoke_multitarget_")
    try:
        db = DB(root)
        hnsw = dict(distance="l2-squared", ef=64, ef_construction=64)
        col = db.create_collection(CollectionConfig(
            name="Multi2t", vector_config=HNSWIndexConfig(**hnsw),
            named_vectors={t: HNSWIndexConfig(**hnsw, device_beam=True,
                                              initial_capacity=MT_ROWS)
                           for t in MT_DIMS}))
        t0 = time.perf_counter()
        for lo in range(0, MT_ROWS, 4096):
            col.put_batch([StorageObject(
                uuid=f"{i:08x}-0000-0000-0000-000000000000",
                collection="Multi2t",
                named_vectors={t: vecs[t][i] for t in MT_DIMS})
                for i in range(lo, min(MT_ROWS, lo + 4096))])
        ingest_s = time.perf_counter() - t0
        rows = rng.choice(MT_ROWS, MT_QUERIES, replace=False)
        qs = [{t: vecs[t][r] + 0.05 * rng.standard_normal(
            dd).astype(np.float32) for t, dd in MT_DIMS.items()}
            for r in rows]
        xs = {t: torch.from_numpy(vecs[t]).to("cuda", torch.float64)
              for t in MT_DIMS}
        uuid_of = "{:08x}-0000-0000-0000-000000000000".format
        per = {}
        total = 0
        walk_events = []
        with KernelSpy(device_beam, "mt_join_topk_cuda", None) as spy, \
                KernelSpy() as walks:
            l_start = spy.launches
            col.multi_target_search(qs[0], k=K, combination="sum")
            for combination, weights in MT_COMBOS:
                gt = [{o.uuid for o, _ in col._multi_target_search_host(
                    q, k=max(4 * K, 64), combination=combination,
                    weights=weights)[:K]} for q in qs]
                exact = [[uuid_of(int(i)) for i in row]
                         for row in exact_multitarget(
                             xs, qs, combination, weights, K, 64)]
                live, lat = [], []
                for q in qs:
                    device_beam.fused_search.launches = 0
                    j0 = spy.launches
                    w0 = len(walks.events)
                    ts = time.perf_counter()
                    page = col.multi_target_search(
                        q, k=K, combination=combination, weights=weights)
                    lat.append((time.perf_counter() - ts) * 1e3)
                    walk_events += walks.events[w0:]
                    b2, b7b = (device_beam.fused_search.launches,
                               spy.launches - j0)
                    if (b2, b7b) != (len(MT_DIMS), 1):
                        raise AssertionError(
                            f"a multi-target search made {b2} B2 and {b7b} "
                            f"B7b launches, not {len(MT_DIMS)} and 1")
                    live.append({o.uuid for o, _ in page})
                    total += 1
                r_oracle = float(np.mean(
                    [len(live[i] & gt[i]) / K for i in range(len(qs))]))
                first = sum(ex[0] in lv for ex, lv in zip(exact, live))
                if r_oracle < MT_MIN_ORACLE_RECALL or first < len(qs):
                    raise AssertionError(
                        f"multi-target {combination}: recall@10 against "
                        f"the host oracle {r_oracle}, the exact first hit "
                        f"in {first} of {len(qs)} top 10s")
                per[combination] = {
                    "recall_at_10_exact": float(np.mean(
                        [len(live[i] & set(exact[i])) / K
                         for i in range(len(qs))])),
                    "recall_at_10_host_oracle": r_oracle,
                    "host_oracle_recall_at_10_exact": float(np.mean(
                        [len(gt[i] & set(exact[i])) / K
                         for i in range(len(qs))])),
                    "exact_first_hit": first / len(qs),
                    "p50_ms": float(np.percentile(lat, 50)),
                    "p99_ms": float(np.percentile(lat, 99))}
            args, _ = spy.last
            join_ms = spy.times()
            torch.cuda.synchronize()
            walk_ms = sum(a.elapsed_time(b) for a, b in walk_events)
            launches = spy.launches - l_start
        scorers, queries, operands, present, pools, weights, fetch, join = \
            args
        err = check_b7b(args[:6], fetch, join)["max_abs_err"]
        ms = cuda_ms(lambda: device_beam.mt_join_topk_cuda(*args), 50)
        plain = cuda_ms(lambda: device_beam.mt_join_topk_plain(*args), 10)
        entry = {"ms": float(np.median(ms)),
                 "plain_ms": float(np.median(plain)), "max_abs_err": err,
                 "launches": launches,
                 "shape": {"b": int(pools[0].shape[0]), "fetch": fetch,
                           "targets": len(scorers), "join": join}}
        entry.update(zip(("bound_ms", "bound_by", "work"),
                         b7b_bound_ms(args[:6], fetch)))
        del xs
        db.close()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    return {"rows": MT_ROWS, "dims": MT_DIMS, "ef": 64,
            "ef_construction": 64, "queries": MT_QUERIES, "k": K,
            "ingest_s": ingest_s, "objects_per_s": MT_ROWS / ingest_s,
            "by_combination": per, "b2_launches_per_search": len(MT_DIMS),
            "searches": total, "b7b_launches_main_path": launches,
            "b7b_ms_median_on_path": float(np.median(join_ms)),
            "b2_ms_per_search": walk_ms / max(1, total),
            "b7b": entry}


def b7b_bound_ms(args, fetch: int) -> tuple[float, str, dict]:
    """The least time of one B7b launch on these inputs: each target's
    pool cut to fetch and query read once, the valid members' rows of
    every target (``scorer_row``'s bytes; PQ's codebooks once), their
    presence bytes, the weights and the outputs, over the memory rate,
    against the rows' element operations over their peak rate."""
    scorers, queries, operands, present, pools, weights = args
    b = pools[0].shape[0]
    cand = torch.cat([p[:, :fetch].long() for p in pools], 1)
    cand = device_beam._mt_dedup(cand)
    ok = cand >= 0
    for pres in present:
        cap = pres.shape[0]
        ok &= (cand < cap) & pres[cand.clamp(0, cap - 1)]
    members = float(ok.sum())
    nbytes = float(b * fetch * 4 * len(pools) + weights.numel() * 4
                   + b * fetch * 8)
    t_ops = 0.0
    for sc, q, ops in zip(scorers, queries, operands):
        row, n_ops, rate = scorer_row(sc, ops)
        nbytes += members * (row + 1) + q.numel() * q.element_size()
        if isinstance(sc, device_beam.PQScorer):
            nbytes += ops[1].numel() * 2
        t_ops += members * n_ops / rate
    t_bytes = nbytes / HBM_BYTES_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations",
            {"bytes": nbytes, "members": members})


def phase_rerank(state: dict) -> dict:
    """Slice 7a on the card: the multivector cell (MUVERA FDE scan, then
    B7a), the HNSW rerank tier (B2, then B7a) and the multi-target cell
    (one B2 launch a target, then B7b), each through the user's entry
    point."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mv = rerank_multivector(state)
    mv_s = time.perf_counter() - t0
    hn = rerank_hnsw(state)
    hn_s = time.perf_counter() - t0 - mv_s
    mt = rerank_multitarget(state)
    mt_s = time.perf_counter() - t0 - mv_s - hn_s
    # each cell counts the launches of its own drive of the main path (the
    # comparisons with the plain versions come after, uncounted)
    b7a = mv["b7a_launches_main_path"] + hn["b7a_launches_main_path"]
    b7b = mt["b7b_launches_main_path"]
    if b7a < 1 or b7b < 1:
        raise AssertionError(f"phase rerank launched B7a {b7a} and B7b "
                             f"{b7b} times")
    state["kernel_b7_rerank"] = {
        "name": "rerank_topk", "route": "cuda",
        "source": "weaviate_tpu_torch/csrc/rerank.cu",
        "replaces": "weaviate_tpu/ops/device_beam.py:161",
        **{k: mv["b7a"][k] for k in ("ms", "plain_ms", "bound_ms",
                                     "bound_by", "max_abs_err")},
        "launches": b7a, "library_ms": None,
        "shape": mv["b7a"]["shape"],
        "hnsw_tier": {k: hn["b7a"][k] for k in ("ms", "plain_ms", "bound_ms",
                                                "bound_by", "shape")}}
    state["kernel_b7_join"] = {
        "name": "mt_join_topk", "route": "cuda",
        "source": "weaviate_tpu_torch/csrc/device_beam.cu",
        "replaces": "weaviate_tpu/ops/device_beam.py:986",
        **{k: mt["b7b"][k] for k in ("ms", "plain_ms", "bound_ms",
                                     "bound_by", "max_abs_err", "shape")},
        "launches": b7b, "library_ms": None}
    return {"multivector": mv, "hnsw_rerank": hn, "multitarget": mt,
            "seconds_by_cell": {"multivector": mv_s, "hnsw_rerank": hn_s,
                                "multitarget": mt_s},
            "b7a_launches": b7a, "b7b_launches": b7b,
            "card": state["card"]}


# ---------------------------------------------------------------------------
# slice 7b: HFresh (B9a) and the geo index; slice 6b: the segment tier
# ---------------------------------------------------------------------------

# B9a against its plain version: float32 sums of the same terms in another
# order (D up to 768; manhattan sums reach a few hundred)
B9_ATOL, B9_RTOL = 1e-4, 1e-5
# the grid: columns a row within the shared-memory plan's keys and past
# them (global scratch), D off 16-byte rows, k past the columns
B9_COLS = (1100, 30_000)
B9_DIMS = (768, 99)
# query rows and postings of a grid case: posting 0 is probed by every
# row, more than the TILE_QUERIES of one scoring tile
B9_ROWS, B9_POSTINGS = 24, 80
# the HFresh cell: config 4's generator (bench.py:868 bench_bq: LAION-like
# unit 768-d rows around 4,096 centres, noise 0.45), HFresh at its
# defaults, cosine, cut 10: HF_ROWS rows (the host-bound ingest: 14.4 s
# at 32,768 rows left phases hfresh and segment at 70.8 s together, over
# their 60 s; PERF.md section 4). HF_MIN_RECALL is a floor under the
# card's 0.559 at 16,384 rows (0.793 at 32,768: more rows a centre), not
# a quality limit: probing 8 postings sets it.
HF_ROWS = 16_384
HF_CENTRES, HF_NOISE, HF_REPS, HF_STEP = 4096, 0.45, 10, 4096
HF_MIN_RECALL = 0.5
# the geo cell: past the device cutoff (2,000,000 points), 64 queries at
# radii of 1 to 500 km; meters of the float32 device path against numpy's
# float64 within GEO_ATOL + GEO_RTOL * r within GEO_NEAR_M of a query
# (float32 coordinates are 1-2 m apart; far away arcsin's slope near 1
# amplifies the float32 error to hundreds of meters, reported)
GEO_POINTS, GEO_QUERIES, GEO_FULL_CHECKS = 4_194_304, 64, 4
GEO_ATOL, GEO_RTOL, GEO_NEAR_M = 8.0, 1e-6, 1_000_000.0
# the segment cell: config 5's text generator at SEG_DOCS docs (cut 11),
# an "auto" twin whose cutoff the ingest crosses
SEG_DOCS, SEG_CUTOFF, SEG_QUERIES = 8192, 4096, 64
SEG_MIGRATION_WAIT_S = 120.0


def device_ms(fn, n: int = 20, spin_cycles: int = 20_000_000) -> dict:
    """Device ms a call of ``fn``: ``n`` calls enqueued behind a spin kernel
    that holds the stream, so they run back to back whatever their host
    part; ``held`` says the enqueue ended before the spin did."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e2 = torch.cuda.Event(enable_timing=True)
    e0.record()
    torch.cuda._sleep(spin_cycles)
    e1.record()
    for _ in range(n):
        fn()
    e2.record()
    held = not e1.query()
    e2.synchronize()
    return {"ms": e1.elapsed_time(e2) / n, "held": held,
            "spin_ms": e0.elapsed_time(e1)}


def b9_inputs(gen, b: int, n: int, d: int, c: int, metric: str):
    """B9a's operands on the card, drawn as postings: B9_POSTINGS postings
    of about c/16 to c/8 rows (a third of the rows of posting 1 are posting 0's:
    replicas), one empty, one holding a row and its 64 exact copies;
    query r probes posting 0 (probed by every query: more queries than a
    tile) and 7 others, query 1 the copies' posting with its query equal
    to the copied row, query 2 the empty one; a tenth of the rows dead;
    each query's candidates the sorted union of its postings' rows, padded
    to c columns with n - 1 (masked; a row stays sorted), query 0 wholly
    masked and a third of query 3's columns off (an allow list). ->
    (queries, corpus, valid, cand, mask, the ``Postings`` on the card)."""
    dev = torch.device("cuda")
    if metric == "hamming":
        corpus = torch.randint(0, 3, (n, d), generator=gen,
                               device=dev).float()
        q = torch.randint(0, 3, (b, d), generator=gen, device=dev).float()
    else:
        corpus = torch.randn(n, d, generator=gen, device=dev)
        q = torch.randn(b, d, generator=gen, device=dev)
    corpus[100:164] = corpus[7]
    q[1] = corpus[7]
    if metric == "cosine":
        corpus, q = normalize(corpus), normalize(q)
    valid = torch.rand(n, generator=gen, device=dev) >= 0.1
    valid[7] = valid[100:164] = True
    rng = np.random.default_rng(int(torch.randint(
        0, 2 ** 31 - 1, (1,), generator=gen, device=dev)))
    nprobe, size = 8, max(16, (c - 65) // 8)  # room for posting 3
    postings = [rng.choice(n, int(rng.integers(size // 2, size + 1)),
                           replace=False) for _ in range(B9_POSTINGS)]
    postings[1][:len(postings[1]) // 3] = postings[0][:len(postings[1]) // 3]
    postings[2] = np.empty(0, np.int64)
    postings[3] = np.r_[7, np.arange(100, 164)]
    probe = np.zeros((b, nprobe), np.int64)
    for r in range(b):
        probe[r, 1:] = 4 + rng.choice(B9_POSTINGS - 4, nprobe - 1,
                                      replace=False)
    probe[1, 1], probe[2, 1] = 3, 2
    cand_lists = [np.unique(np.concatenate([postings[p] for p in row]))
                  for row in probe]
    cand = np.full((b, c), n - 1, np.int32)
    mask = np.zeros((b, c), bool)
    for r, ids in enumerate(cand_lists):
        if len(ids) > c:
            raise AssertionError(f"B9a's grid drew {len(ids)} > {c} columns")
        cand[r, :len(ids)] = ids
        mask[r, :len(ids)] = True
    mask[0] = False
    mask[3, rng.random(c) < 1 / 3] = False
    q_t, cand_t, mask_t, posts = hfresh.posting_operands(
        q.cpu().numpy(), cand, mask, probe,
        hfresh.posting_table(postings, n, dev), n, dev)
    return q_t, corpus.contiguous(), valid, cand_t, mask_t, posts


def check_b9a(args, k: int, metric: str) -> dict:
    """B9a against its plain version: distances slot for slot within
    B9_ATOL + B9_RTOL * |plain|; where columns differ, the kernel's column
    is a near tie (its plain distance within that tolerance of the plain
    one at the slot); no column twice in a row. ``args``: queries, corpus,
    valid, cand, mask and the ``Postings``."""
    ops, posts = args[:5], args[5]
    kd, kc = hfresh.posting_topk_cuda(*ops, k, metric, posts)
    pd, pc = hfresh.posting_topk_plain(*ops, k, metric)
    torch.cuda.synchronize()
    tol = B9_ATOL + B9_RTOL * pd.abs()
    err = (kd - pd).abs()
    if bool((err > tol).any()):
        raise AssertionError(f"B9a distances differ ({metric}, k {k}): "
                             f"max {err.max().item()}")
    srt = torch.sort(kc.long(), dim=1).values
    if bool((srt[:, 1:] == srt[:, :-1]).any()):
        raise AssertionError("B9a returned a column twice")
    diff = kc != pc
    if bool(diff.any()):
        q, corpus, valid, cand, mask = ops
        full = hfresh.gather_distance(q, corpus, cand, metric, "fp32")
        full = torch.where(mask & valid[cand.long()], full, MASK_DISTANCE)
        own = torch.gather(full, 1, kc.long())
        if bool(((own - pd).abs() > tol)[diff].any()):
            raise AssertionError(f"B9a columns differ beyond a near tie "
                                 f"({metric}, k {k})")
    return {"max_abs_err": float(err.max()), "near_ties": int(diff.sum()),
            "slots": int(pd.numel())}


def b9a_bound_ms(args, k: int) -> tuple[float, str, dict]:
    """The least time of one B9a launch on these inputs: the unique valid
    candidate rows that a row's mask keeps, read once, the queries,
    candidates, mask and outputs once, over the memory rate, against 2 D
    float32 operations a kept (query, candidate) pair at the float32
    peak."""
    q, corpus, valid, cand, mask = args[:5]
    b, d = q.shape
    c = cand.shape[1]
    kk = min(k, c)
    keep = mask & valid[cand.long()]
    pairs = int(keep.sum())
    rows = int(torch.unique(cand[keep]).numel())
    nbytes = float(rows * d * 4 + b * d * 4 + b * c * 5 + b * kk * 8)
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = 2.0 * pairs * d / FP32_FLOP_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations",
            {"bytes": nbytes, "unique_rows": rows, "pairs": pairs,
             "bytes_per_pair": nbytes / max(1, pairs),
             "read_bytes_per_pair_unshared": 4 * d})


def b9_posting_grid(seed: int) -> dict:
    """B9a against its plain version over every metric, D of 768 and 99,
    columns a row within the keys' shared memory and past it, k of 10, 100
    and past the columns, on postings as ``b9_inputs`` draws them (shared
    and unshared, replicas, an empty one, a posting over more queries than
    a tile), rows wholly masked, dead store rows and exact duplicate
    rows."""
    if B9_ROWS <= hfresh.TILE_QUERIES:
        raise AssertionError("B9a's grid has no posting over two tiles")
    gen = torch.Generator(device="cuda").manual_seed(seed + 91)
    cases, worst, ties, slots = 0, 0.0, 0, 0
    plans = set()
    smem = hfresh._smem_max(torch.cuda.current_device())
    for metric in hfresh.METRICS:
        for d in B9_DIMS:
            for c in B9_COLS:
                args = b9_inputs(gen, B9_ROWS, max(2 * c, 4096), d, c,
                                 metric)
                for k in (10, 100, c + 5):
                    r = check_b9a(args, k, metric)
                    plans.add(hfresh.posting_plan(c, d, min(k, c), smem)[:2])
                    cases += 1
                    worst = max(worst, r["max_abs_err"])
                    ties += r["near_ties"]
                    slots += r["slots"]
                del args
    if len(plans) < 3:
        raise AssertionError(f"B9a's grid missed a plan: {sorted(plans)}")
    return {"cases": cases, "max_abs_err": worst, "near_ties": ties,
            "slots": slots, "plans_keys_sel_in_smem": sorted(plans),
            "smem_max": smem,
            "tolerance": {"atol": B9_ATOL, "rtol": B9_RTOL}}


class StepTimer:
    """Host seconds and calls of named methods of one object, each call
    counted inclusive of what it calls, while installed (instance
    attributes shadow the methods; removing them restores the class's)."""

    def __init__(self, obj, names):
        self.obj, self.names = obj, names
        self.acc = {n: [0.0, 0] for n in names}

    def __enter__(self):
        for name in self.names:
            real = getattr(self.obj, name)
            acc = self.acc[name]

            def timed(*a, _real=real, _acc=acc, **kw):
                t0 = time.perf_counter()
                try:
                    return _real(*a, **kw)
                finally:
                    _acc[0] += time.perf_counter() - t0
                    _acc[1] += 1

            setattr(self.obj, name, timed)
        return self

    def __exit__(self, *exc):
        for name in self.names:
            delattr(self.obj, name)

    def report(self) -> dict:
        return {n: {"s": v[0], "calls": v[1]} for n, v in self.acc.items()}


def phase_hfresh(seed: int, state: dict) -> dict:
    """Slice 7b on the card: an HFresh collection through ``DB`` (B9a a
    search) and the geo index past its device cutoff."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rows = clustered(HF_ROWS, QUANT_DIMS, HF_CENTRES, HF_NOISE, seed + 47)
    host = rows.cpu().numpy()
    rng = np.random.default_rng(seed + 47)
    queries = host[:BATCH] + 0.05 * rng.standard_normal(
        (BATCH, QUANT_DIMS)).astype(np.float32)
    truth = exact_truth(rows, normalize(torch.from_numpy(queries).cuda()),
                        "cosine")
    del rows
    uuids = _uuids(rng, HF_ROWS)
    data_s = time.perf_counter() - t0
    root = tempfile.mkdtemp(prefix="chip_smoke_hfresh_")
    try:
        out = _drive_hfresh(state, root, host, queries, truth, uuids)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["data_s"] = data_s
    t1 = time.perf_counter()
    out["geo"] = geo_cell(seed)
    out["geo"]["seconds"] = time.perf_counter() - t1
    return out


def _drive_hfresh(state, root, host, queries, truth, uuids) -> dict:
    db = DB(root)
    col = db.create_collection(CollectionConfig(
        name="Hfresh", properties=[Property("bucket", DataType.INT)],
        vector_config=HFreshIndexConfig(distance="cosine")))
    shard = col._get_shard("shard0")
    idx = shard._index_for("", QUANT_DIMS)
    steps = StepTimer(idx, ("add_batch", "_add_assign", "_maintain",
                            "_split", "_reassign_neighbors", "_merge",
                            "_live_posting", "_centroid_dists"))
    store_steps = StepTimer(idx.store, ("put", "get"))
    t0 = time.perf_counter()
    at = {}
    with steps, store_steps:
        for s in range(0, HF_ROWS, HF_STEP):
            e = min(HF_ROWS, s + HF_STEP)
            col.put_batch([StorageObject(
                uuid=uuids[i], collection="Hfresh", vector=host[i],
                properties={"bucket": i % 100}) for i in range(s, e)])
            if e & (e - 1) == 0:  # the ingest's seconds at each power of 2
                at[e] = time.perf_counter() - t0
        torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    st = idx.stats()
    # the posting operands and the device posting table, host ms each
    # with its upload; a CUDA event where each batch's operands start
    operands_ms, table_ms, starts = [], [], []
    build, table = hfresh_index.posting_operands, hfresh_index.posting_table

    def timed(fn, out, events=None):
        def call(*a, **kw):
            if events is not None:
                events.append(torch.cuda.Event(enable_timing=True))
                events[-1].record()
            t1 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                out.append((time.perf_counter() - t1) * 1e3)
        return call

    hfresh_index.posting_table = timed(table, table_ms)
    hfresh_index.posting_operands = timed(build, operands_ms, starts)
    try:
        col.vector_search_batch(queries, K)  # warm: the kernel built and
        # the table of the ingest's postings
        tables_at_warm, operands_ms[:], starts[:] = len(table_ms), [], []
        # the main path's drive: the count at 0 just before, read just after
        hfresh.posting_topk_cuda.launches = 0
        ms, served = [], None
        with KernelSpy(hfresh, "posting_topk_cuda", width=None) as spy:
            for _ in range(HF_REPS):
                t1 = time.perf_counter()
                served = col.vector_search_batch(queries, K)
                ms.append((time.perf_counter() - t1) * 1e3)
            launches = spy.launches
            call_on_path = spy.times()
            (args, kw) = spy.last
        # B9a on the path: from the operands' start to the call's end
        on_path = [a.elapsed_time(e1)
                   for a, (_, e1) in zip(starts, spy.events)]
    finally:
        hfresh_index.posting_operands, hfresh_index.posting_table = (
            build, table)
    if launches < 1:
        raise AssertionError("the HFresh searches launched no B9a")
    if len(on_path) != HF_REPS or len(table_ms) != tables_at_warm:
        raise AssertionError("the HFresh drive's operands and calls do not "
                             "pair, or its postings changed")
    row_of = {u: i for i, u in enumerate(uuids)}
    got = [[row_of[o.uuid] for o, _ in r] for r in served]
    recall_10 = recall(np.asarray([g + [-1] * (K - len(g)) for g in got]),
                       truth)
    if recall_10 < HF_MIN_RECALL:
        raise AssertionError(f"HFresh recall@10 {recall_10} < "
                             f"{HF_MIN_RECALL}")
    for r in served:
        if len(r) != K or not all(np.isfinite([dd for _, dd in r])):
            raise AssertionError("an HFresh row is short or not finite")
    # B9a on the main path's inputs: against its plain version, then timed
    # (launches made here are not the drive's, read above)
    k, metric = args[5], args[6]
    ops = args[:5] + (args[7],)
    chk = check_b9a(ops, k, metric)
    bound, by, work = b9a_bound_ms(ops, k)

    def kernel():
        return hfresh.posting_topk_cuda(*ops[:5], k, metric, ops[5])

    dev = device_ms(kernel)
    posts = ops[5]
    _, per = np.unique(posts.probe.cpu().numpy(), return_counts=True)
    state["kernel_b9_posting"] = {
        "name": "posting_topk", "route": "cuda",
        "source": "weaviate_tpu_torch/csrc/hfresh.cu",
        "replaces": "weaviate_tpu/index/hfresh.py:319",
        "launches": launches,
        "max_abs_err": chk["max_abs_err"],
        "ms": float(np.median(cuda_ms(kernel, 30))),
        "device_ms": dev["ms"], "device_held": dev["held"],
        "on_path_ms_median": float(np.median(on_path)),
        "call_on_path_ms_median": float(np.median(call_on_path)),
        "operands_host_ms_median": float(np.median(operands_ms)),
        "table_host_ms": table_ms[-1] if table_ms else None,
        "plain_ms": float(np.median(cuda_ms(
            lambda: hfresh.posting_topk_plain(*ops[:5], k, metric), 10))),
        "bound_ms": bound, "bound_by": by, "library_ms": None,
        "shape": {"b": int(ops[0].shape[0]), "cmax": int(ops[3].shape[1]),
                  "d": int(ops[0].shape[1]), "k": int(k)},
        "postings": int(posts.table.off.numel() - 1),
        "postings_probed": int(per.size),
        "queries_a_posting_mean": float(per.mean()),
        "queries_a_posting_max": int(per.max()),
        "table_entries": int(posts.table.rows.numel()),
        **work, "near_ties": chk["near_ties"]}
    peak = torch.cuda.max_memory_allocated()
    index_bytes = idx.hbm_bytes()
    t1 = time.perf_counter()
    db.close()
    close_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    db2 = DB(root)
    reopen_s = time.perf_counter() - t1
    col2 = db2.get_collection("Hfresh")
    again = col2.vector_search_batch(queries, K)
    if uuid_rows(again) != uuid_rows(served):
        raise AssertionError("HFresh answers changed across close/reopen")
    recovered = col2._get_shard("shard0").recovered_from
    if recovered != "checkpoint":
        raise AssertionError(f"HFresh reopened from {recovered}")
    db2.close()
    return {"rows": HF_ROWS, "dims": QUANT_DIMS, "batch": BATCH, "k": K,
            "ingest_s": ingest_s, "vectors_per_s": HF_ROWS / ingest_s,
            "ingest_s_at_rows": at,
            "ingest_steps": {**steps.report(),
                             **{f"store.{n}": v for n, v in
                                store_steps.report().items()}},
            "centroids": st["centroids"], "max_posting": st["max_posting"],
            "min_posting": st["min_posting"],
            "cmax": int(ops[3].shape[1]),
            "recall_at_10": recall_10,
            "p50_ms": float(np.median(ms)),
            "p99_ms": float(np.percentile(ms, 99)),
            "b9a_launches": launches, "b9a": state["kernel_b9_posting"],
            "close_s": close_s, "reopen_s": reopen_s,
            "recovered_from": recovered,
            "index_device_bytes": index_bytes, "peak_device_bytes": peak,
            "card": state["card"]}


def geo_cell(seed: int) -> dict:
    """``GeoIndex`` at GEO_POINTS seeded points (uniform on the sphere, a
    percent deleted), past its device cutoff: GEO_QUERIES ``within_range``
    and ``knn`` queries near stored points at radii of 1 to 500 km, each
    held to numpy's float64 ``haversine_m``: ids equal but for points within
    GEO_ATOL + GEO_RTOL * r of the radius, each such point checked (the
    float64 distances are taken for every point of GEO_FULL_CHECKS queries,
    and where the float32 distance is within that of the radius or the
    k-th for the rest)."""
    rng = np.random.default_rng(seed + 53)
    lat = np.degrees(np.arcsin(rng.uniform(-1.0, 1.0, GEO_POINTS)))
    lon = rng.uniform(-180.0, 180.0, GEO_POINTS)
    ids = np.arange(GEO_POINTS, dtype=np.int64) * 2 + 1
    g = geo.GeoIndex()
    t0 = time.perf_counter()
    g.add_batch(ids, lat, lon)
    dead = rng.choice(GEO_POINTS, GEO_POINTS // 100, replace=False)
    for d in ids[dead]:
        g.delete(int(d))
    add_s = time.perf_counter() - t0
    live = np.ones(GEO_POINTS, bool)
    live[dead] = False
    if GEO_POINTS < geo._DEVICE_CUTOFF:
        raise AssertionError("the geo cell is below the device cutoff")
    centres = rng.choice(GEO_POINTS, GEO_QUERIES, replace=False)
    radii = np.geomspace(1_000.0, 500_000.0, GEO_QUERIES)
    worst, worst_near, boundary, knn_ties, hits = 0.0, 0.0, 0, 0, 0
    range_ms, knn_ms = [], []
    for qi, (c, r) in enumerate(zip(centres, radii)):
        la0 = float(lat[c] + rng.normal(0, 0.01))
        lo0 = float(lon[c] + rng.normal(0, 0.01))
        t1 = time.perf_counter()
        got = g.within_range(la0, lo0, r)
        range_ms.append((time.perf_counter() - t1) * 1e3)
        t1 = time.perf_counter()
        kid, kd = g.knn(la0, lo0, K)
        knn_ms.append((time.perf_counter() - t1) * 1e3)
        _, d32 = g._dists(la0, lo0)
        tol = GEO_ATOL + GEO_RTOL * r
        if qi < GEO_FULL_CHECKS:
            d64 = geo.haversine_m(la0, lo0, lat, lon)
            err = np.abs(d32 - d64)
            worst = max(worst, float(err.max()))
            worst_near = max(worst_near, float(err[d64 <= GEO_NEAR_M].max()))
        else:
            kth = np.partition(np.where(live, d32, np.inf), K - 1)[K - 1]
            sub = np.flatnonzero((d32 <= r + tol) | (d32 <= kth + tol))
            d64 = np.full(GEO_POINTS, np.inf)
            d64[sub] = geo.haversine_m(la0, lo0, lat[sub], lon[sub])
        want = ids[(d64 <= r) & live]
        odd = np.setxor1d(got, want)
        rows = (odd - 1) // 2
        if len(odd) and not (np.abs(d64[rows] - r) <= tol).all():
            raise AssertionError(f"geo query {qi}: ids differ beyond the "
                                 f"radius's float32 error")
        boundary += len(odd)
        hits += len(got)
        exp = geo.smallest_stable(np.where(live, d64, np.inf), K)
        if len(kid) != K or not np.allclose(kd, d64[(kid - 1) // 2],
                                            rtol=GEO_RTOL, atol=GEO_ATOL):
            raise AssertionError(f"geo query {qi}: knn meters off")
        swap = kid != ids[exp]
        if swap.any():
            if not np.allclose(d64[(kid[swap] - 1) // 2], d64[exp][swap],
                               rtol=GEO_RTOL, atol=GEO_ATOL):
                raise AssertionError(f"geo query {qi}: knn ids differ "
                                     f"beyond a near tie")
            knn_ties += int(swap.sum())
    if worst_near > GEO_ATOL + GEO_RTOL * GEO_NEAR_M:
        raise AssertionError(f"geo float32 error {worst_near} m within "
                             f"{GEO_NEAR_M} m of a query")
    la0, lo0 = float(lat[0]), float(lon[0])
    dev = g._device_columns()
    card_ms = cuda_ms(lambda: geo.haversine_device(la0, lo0, *dev), 20)
    dists_ms = host_p(lambda: g._dists(la0, lo0), 10)
    numpy_ms = host_p(lambda: geo.haversine_m(la0, lo0, lat, lon), 2)
    return {"points": GEO_POINTS, "deleted": len(dead),
            "queries": GEO_QUERIES, "radii_m": [radii[0], radii[-1]],
            "add_s": add_s, "hits": hits,
            "boundary_points_checked": boundary, "knn_near_ties": knn_ties,
            "max_abs_err_m_vs_float64": worst,
            "max_abs_err_m_within_1000_km": worst_near,
            "tolerance": {"atol_m": GEO_ATOL, "rtol": GEO_RTOL},
            "within_range_p50_ms": float(np.median(range_ms)),
            "knn_p50_ms": float(np.median(knn_ms)),
            "haversine_card_ms": float(np.median(card_ms)),
            "dists_card_with_readback_ms": float(np.median(dists_ms)),
            "haversine_host_float64_ms": float(np.median(numpy_ms))}


def seg_collection(db, name: str, storage: str, cutoff: int = 1_000_000):
    return db.create_collection(CollectionConfig(
        name=name,
        properties=[Property("body", DataType.TEXT),
                    Property("bucket", DataType.INT)],
        vector_config=FlatIndexConfig(distance="cosine", precision="fp32",
                                      initial_capacity=SEG_DOCS),
        inverted_config=InvertedIndexConfig(storage=storage,
                                            segment_cutoff=cutoff)))


def same_page(a, b, what: str) -> None:
    """Two [(object, score)] pages: equal uuids and equal score bits."""
    ua, ub = [o.uuid for o, _ in a], [o.uuid for o, _ in b]
    sa = np.asarray([s for _, s in a], np.float64)
    sb = np.asarray([s for _, s in b], np.float64)
    if ua != ub or sa.tobytes() != sb.tobytes():
        raise AssertionError(f"{what}: pages differ {ua} {sa} / {ub} {sb}")


def phase_segment(seed: int, state: dict) -> dict:
    """Slice 6b through ``DB``: config 5's text (a tenant of SEG_DOCS docs of
    bench_msmarco's Zipf vocabulary) and an int ``bucket`` in a collection
    with ``storage="segment"`` and its twin with ``"ram"``, held to each
    other (BM25 pages, the 1% and 45% allow lists, a hybrid request, an
    aggregate); then ``storage="auto"`` with its cutoff below the depth, so
    the tier migration runs during the ingest and lands; a close and a
    reopen that boots the auto collection into the segment tier."""
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    post = zipf_postings(SEG_DOCS, 1000 + seed)
    texts, _ = tenant_texts(post)
    centers = np.random.default_rng(99).standard_normal(
        (2048, QUANT_DIMS)).astype(np.float32)
    vecs = gen_block(0, SEG_DOCS, centers)
    rng = np.random.default_rng(seed + 59)
    bucket = rng.integers(0, 100, SEG_DOCS)
    uuids = _uuids(rng, SEG_DOCS)
    pool = [" ".join(f"t{r}" for r in terms)
            for terms in query_pool(post["df"], SEG_QUERIES, 7)]
    data_s = time.perf_counter() - t0
    root = tempfile.mkdtemp(prefix="chip_smoke_segment_")
    try:
        out = _drive_segment(state, root, texts, vecs, bucket, uuids, pool)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["data_s"] = data_s
    return out


def _drive_segment(state, root, texts, vecs, bucket, uuids, pool) -> dict:
    db = DB(root)
    cols = {"segment": seg_collection(db, "SegTier", "segment"),
            "ram": seg_collection(db, "RamTwin", "ram"),
            "auto": seg_collection(db, "AutoTier", "auto", SEG_CUTOFF)}
    ingest = {}
    for tier, col in cols.items():
        t0 = time.perf_counter()
        for s in range(0, SEG_DOCS, DB_BATCH // 4):
            e = min(SEG_DOCS, s + DB_BATCH // 4)
            col.put_batch([StorageObject(
                uuid=uuids[i], collection=col.config.name, vector=vecs[i],
                properties={"body": texts[i], "bucket": int(bucket[i])})
                for i in range(s, e)])
        ingest[tier] = time.perf_counter() - t0
    shards = {t: c._get_shard("shard0") for t, c in cols.items()}
    if not getattr(shards["segment"].inverted, "segmented", False) or \
            getattr(shards["ram"].inverted, "segmented", False):
        raise AssertionError("the tiers are not the ones configured")
    t0 = time.perf_counter()
    deadline = t0 + SEG_MIGRATION_WAIT_S
    while not getattr(shards["auto"].inverted, "segmented", False):
        if time.perf_counter() > deadline:
            raise AssertionError("the auto tier never migrated")
        time.sleep(0.05)
    migration_wait_s = time.perf_counter() - t0
    # the tiers held to each other
    bm25_ms = {t: [] for t in cols}
    for i, q in enumerate(pool):
        pages = {}
        for tier, col in cols.items():
            t1 = time.perf_counter()
            pages[tier] = col.bm25_search(q, K)
            bm25_ms[tier].append((time.perf_counter() - t1) * 1e3)
        same_page(pages["segment"], pages["ram"], f"bm25 {i} segment/ram")
        same_page(pages["auto"], pages["ram"], f"bm25 {i} auto/ram")
    masks = {}
    for name, flt in (("one_pct", Where.eq("bucket", FILTER_BUCKET)),
                      ("near_half", Where.lt("bucket",
                                             BEAM_FILTER_BUCKETS))):
        m = {t: s.allow_list(flt) for t, s in shards.items()}
        for t in ("segment", "auto"):
            if not np.array_equal(m[t], m["ram"]):
                raise AssertionError(f"{name} allow list differs ({t})")
        masks[name] = int(m["ram"].sum())
        dev = {t: cols[t].bm25_search(pool[0], K, flt=flt,
                                      device_scoring=True)
               for t in ("segment", "ram")}
        check_pages(dev["segment"], dev["ram"], f"filtered bm25 {name}")
    q = vecs[3] + 0.05 * np.random.default_rng(61).standard_normal(
        QUANT_DIMS).astype(np.float32)
    hyb = {t: cols[t].hybrid_search(query=pool[1], vector=q, alpha=MS_ALPHA,
                                    k=K) for t in cols}
    for t in ("segment", "auto"):
        same_page(hyb[t], hyb["ram"], f"hybrid {t}/ram")
    agg = {t: json.dumps(cols[t].aggregate(
        {"bucket": "numeric", "body": "text"}, top_occurrences_limit=5,
        flt=Where.lt("bucket", BEAM_FILTER_BUCKETS)), sort_keys=True)
        for t in cols}
    if not agg["segment"] == agg["auto"] == agg["ram"]:
        raise AssertionError("aggregates differ between tiers")
    t0 = time.perf_counter()
    db.close()
    close_s = time.perf_counter() - t0
    db2 = DB(root)
    auto2 = db2.get_collection("AutoTier")
    inv = auto2._get_shard("shard0").inverted
    if not getattr(inv, "segmented", False):
        raise AssertionError("the auto collection reopened in the RAM tier")
    same_page(auto2.bm25_search(pool[0], K),
              db2.get_collection("RamTwin").bm25_search(pool[0], K),
              "bm25 after reopen")
    db2.close()
    return {"docs": SEG_DOCS, "queries": len(pool),
            "auto_cutoff": SEG_CUTOFF,
            "ingest_s": ingest,
            "docs_per_s": {t: SEG_DOCS / s for t, s in ingest.items()},
            "migration_wait_s": migration_wait_s,
            "bm25_p50_ms": {t: float(np.median(v))
                            for t, v in bm25_ms.items()},
            "allowed": masks, "close_s": close_s,
            "card": state["card"]}



def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    state: dict = {}
    phases = (
        ("env", phase_env),
        ("kernels", lambda: phase_kernels(args.seed)),
        ("main", lambda: phase_main(args.seed, state)),
        ("warm", lambda: phase_warm(state)),
        ("db", lambda: phase_db(args.seed, state)),
        ("hnsw", lambda: phase_hnsw(state)),
        ("hnsw_db", lambda: phase_hnsw_db(args.seed, state)),
        ("quant", lambda: phase_quant(state)),
        ("hnsw_quant", lambda: phase_hnsw_quant(state)),
        ("quant_db", lambda: phase_quant_db(args.seed, state)),
        ("pq", lambda: phase_pq(state)),
        ("hnsw_pq", lambda: phase_hnsw_pq(state)),
        ("hybrid", lambda: phase_hybrid(args.seed, state)),
        ("rerank", lambda: phase_rerank(state)),
        ("hfresh", lambda: phase_hfresh(args.seed, state)),
        ("segment", lambda: phase_segment(args.seed, state)),
    )
    for name, fn in phases:
        t0 = time.perf_counter()
        out = fn()
        if name == "env":
            state["card"] = out["card"]
        emit({"phase": name, "seconds": time.perf_counter() - t0, **out})
    emit({"kernels": [state[k] for k in (
        "kernel", "kernel_b2", "kernel_b2_bq", "kernel_b2_sq", "kernel_b2_pq",
        "kernel_b2_rq", "kernel_q1", "kernel_q2", "kernel_q3", "kernel_q4",
        "kernel_merge", "kernel_b6_sparse", "kernel_b6_fusion",
        "kernel_b7_rerank", "kernel_b7_join", "kernel_b9_posting")]})
    print(card(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
