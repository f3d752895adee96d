"""Time HNSW construction and search on the card, step by step.

    python3 probe_hnsw_build.py [--rows 100000] [--profile]

Builds ``HNSWIndex`` at ``chip_smoke.py`` phase ``hnsw``'s configuration
(``bench.py bench_glove``: cosine, ef 64, ef_construction 96, M 16, insert
batches of 4096, the fused walk on) over the first ``--rows`` of that
phase's seeded data, in ``add_batch`` steps of 100,000 rows, and prints one
JSON line: build seconds and the seconds inside each construction step
(layer-0 walks in B2, upper-level host walks, greedy descent, linking and
its selection heuristic), B2 launches, recall@10 against the exact float32
answer, and search p50 with the fused walk and with the host walk.
``--profile`` prints a cProfile listing of the last ``add_batch`` step to
standard error. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import cProfile
import functools
import io
import json
import pstats
import subprocess
import sys
import time

import numpy as np
import torch

import chip_smoke as cs
from weaviate_tpu_torch.index.hnsw import HNSWIndex
from weaviate_tpu_torch.ops import device_beam
from weaviate_tpu_torch.schema.config import HNSWIndexConfig

STEPS = ("_construction_beam_level0", "_search_level",
         "_greedy_step_until_stable", "_link_level", "_select_heuristic_batch")


def timed_steps(seconds: dict) -> None:
    """Wraps each construction step of ``HNSWIndex`` to add its seconds to
    ``seconds`` (nested steps count in both)."""
    for name in STEPS:
        fn = getattr(HNSWIndex, name)

        @functools.wraps(fn)
        def wrap(*a, _fn=fn, _name=name, **kw):
            t0 = time.perf_counter()
            try:
                return _fn(*a, **kw)
            finally:
                seconds[_name] = seconds.get(_name, 0.0) \
                    + time.perf_counter() - t0

        setattr(HNSWIndex, name, wrap)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=100_000)
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_hnsw_build: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    corpus, queries = cs.glove_data(args.rows)
    seconds: dict = {}
    timed_steps(seconds)
    idx = HNSWIndex(cs.HNSW_DIMS, HNSWIndexConfig(
        distance="cosine", ef=cs.HNSW_EF, ef_construction=cs.HNSW_EFC,
        max_connections=cs.HNSW_M, initial_capacity=args.rows,
        device_beam=True, insert_batch=cs.HNSW_INSERT))
    device_beam.fused_search.launches = 0
    marks = []
    t0 = time.perf_counter()
    for s in range(0, args.rows, cs.HNSW_ADD_STEP):
        last = s + cs.HNSW_ADD_STEP >= args.rows
        prof = cProfile.Profile() if args.profile and last else None
        if prof:
            prof.enable()
        idx.add_batch(np.arange(s, min(args.rows, s + cs.HNSW_ADD_STEP)),
                      corpus[s:s + cs.HNSW_ADD_STEP])
        if prof:
            prof.disable()
            out = io.StringIO()
            pstats.Stats(prof, stream=out).sort_stats("tottime").print_stats(25)
            print(out.getvalue(), file=sys.stderr)
        marks.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    launches = device_beam.fused_search.launches
    store_corpus, valid, _ = idx.store.snapshot()
    gt = cs.cosine_truth(store_corpus, valid, queries)
    rec = cs.recall(idx.search(queries, cs.K).ids, gt)
    fused_ms = cs.host_p(lambda: idx.search(queries, cs.K), 20)
    idx._device_beam = None
    host_rec = cs.recall(idx.search(queries, cs.K).ids, gt)
    host_ms = cs.host_p(lambda: idx.search(queries, cs.K), 3)
    print(json.dumps({
        "rows": args.rows, "build_s": build_s,
        "build_s_at_each_step": marks, "step_s": seconds,
        "b2_launches_build": launches, "recall_at_10": rec,
        "search_p50_ms": float(np.percentile(fused_ms, 50)),
        "host_walk_recall_at_10": host_rec,
        "host_walk_p50_ms": float(np.percentile(host_ms, 50)),
        "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
