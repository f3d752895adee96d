"""Where the fused HNSW walk's (B2) time goes, on one card.

    python3 probe_device_beam.py [--row raw|bq|sq|pq|rq] [--ef EF]
                                 [--against FILE.cu] [--copies a,b]
                                 [--rows N] [--iters 10]

On a graph of ``--rows`` nodes with 32 random neighbours each (seeded on
the card; the walk's memory pattern at the scale of a cell, whose HNSW ids
are random too, without its build), B = 256 queries and the search's
``max_steps``, it times ``fused_search_cuda`` (CUDA events around
``--iters`` launches back to back, so the host's part of a launch is
hidden) for ``weaviate_tpu_torch/csrc/device_beam.cu`` as it is
(``as_is``), held against the plain version (the share of equal ids),
unfiltered and filtered (45% allowed, a kept track of 32, expand 1). The
rows, by ``--row``, at their cells' widths (random rows and codes made on
the card from a seed):

- ``raw`` (phase ``hnsw``): 1,200,000 unit 25-d float32 rows, cosine at
  bf16, ef 64;
- ``bq`` (phase ``hnsw_quant``): 262,144 rows of 768 sign bits (24 packed
  words and a popcount a row), ef 128 (the index pads ef 96 to 128);
- ``sq`` (phase ``quant_db``): 100,000 rows of 768 SQ codes, cosine, ef
  128 (the index pads ef 96 to 128);
- ``pq`` (phase ``hnsw_pq``, config 3): 32,768 rows of 96 PQ codes into
  96 x 256 bf16 centroids of 16 dimensions, l2-squared, ef 128;
- ``rq`` (phase ``quant``'s HNSW + RQ): 32,768 rows of 768 RQ codes with
  their lower and step, cosine, ef 128.

``--ef`` walks at another beam width than the cell's (``--row raw --ef
128`` separates the beam's pad from the row type). A copy with clock64 counters (``counters``) splits a warp's cycles into
the upper descent (the PQ table's build and the entry point included), a
hop's adjacency round, its gather (flags, compaction, marks and, for code
rows, the staged rows' copies and scoring), the rank of its new entries
and the merge; for code rows also the cycles of the row copies (issue to
wait) and of the scoring from shared memory, each summed over every call
(the upper descent's few included) and divided by the hops, and the PQ
table's build a walk. ``--copies`` also builds copies with one constant
changed (``COPIES``: the lanes a staged code row is scored by), each timed
and held against ``as_is``.
``--against FILE.cu`` also builds another version of the kernel source (a
file with the same C interface, e.g. one unpacked from another commit into
git-ignored ``_chipcheck/``) as the copy ``against``, held against
``as_is`` and timed in turns with it (as_is, against, against, as_is),
since times of two calls (machines) are not comparable.

The counters copy is made by replacing exact lines of the source; when the
source no longer holds one, the probe stops and names it (a CPU test
applies the edits). Builds go to ``weaviate_tpu_torch/_build/probe_beam/``.
Prints one JSON line per copy, then the card's name and power limit. Needs
a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
SOURCE = ROOT / "weaviate_tpu_torch" / "csrc" / "device_beam.cu"
OUT = ROOT / "weaviate_tpu_torch" / "_build" / "probe_beam"

M0, B = 32, 256
# --row: (rows, D, ef) at the cell's widths
ROWS = {"raw": (1_200_000, 25, 64), "bq": (262_144, 768, 128),
        "sq": (100_000, 768, 128),
        "pq": (32_768, 1536, 128), "rq": (32_768, 768, 128)}
PQ_SEGMENTS, PQ_CENTROIDS = 96, 256

# clock64 counters, summed over warps: [0] upper descent, [1] adjacency
# rounds, [2] gathers, [3] ranks of the new entries, [4] merges (the
# read-ahead issued), [5] the whole walk, [6] hops; code rows: [7] the row
# copies (issue to wait), [8] the scoring from shared memory, [9] the PQ
# table's build; a layer-0 hop's parts, summed over warps: [10] the
# gather's loads and speculative scoring, [11] its compaction and marks,
# [12] the rank's widening, cumulative from the rank's end: [13] the
# read-ahead issued, [15] the beam merged;
# within a hop's gather: [16] the ids read and the flags' loads issued,
# [17] the speculative scoring (its rows' loads and sums), [18] the flags'
# wait and the accepted test; [19] BQ hops with at most kFewNew landing
# entries
NCOUNT = 20
COUNTERS = [
    ("namespace {\n",
     "__device__ unsigned long long g_probe[20];\n"
     "__device__ __forceinline__ void probe_add(int i, long long v) {\n"
     "  if ((threadIdx.x & 31) == 0)\n"
     "    atomicAdd(&g_probe[i], (unsigned long long)v);\n}\n"
     "namespace {\n"),
    ("  const int ef = p.ef, kk = p.keep_k, m0 = p.m0;\n",
     "  const int ef = p.ef, kk = p.keep_k, m0 = p.m0;\n"
     "  const long long tk0 = clock64();\n"
     "  long long tpr[5] = {0, 0, 0, 0, 0}, tq = 0;\n"),
    ("  // -- layer-0 best-first beam ----",
     "  tpr[0] = clock64() - tk0;\n  // -- layer-0 best-first beam ----"),
    ("    const int node = src_id[first];\n",
     "    tq = clock64();\n    const int node = src_id[first];\n"),
    ("    if (lane == 0) src_exp[first] = 1;\n    __syncwarp();\n",
     "    if (lane == 0) src_exp[first] = 1;\n    __syncwarp();\n"
     "    tpr[1] += clock64() - tq; tq = clock64();\n"),
    ("    expansions += 1;\n\n    if (track && p.expand > 0) {",
     "    expansions += 1;\n    tpr[2] += clock64() - tq; tq = clock64();\n"
     "\n    if (track && p.expand > 0) {"),
    ("      }\n    }\n    __syncwarp();\n    // the best new entry is the next",
     "      }\n    }\n    __syncwarp();\n"
     "    tpr[3] += clock64() - tq; tq = clock64();\n"
     "    // the best new entry is the next"),
    ("    buf ^= 1;\n    __syncwarp();\n  }\n",
     "    buf ^= 1;\n    __syncwarp();\n    tpr[4] += clock64() - tq;\n  }\n"),
    ("  const int spec = SPEC ?",
     "  if (lane == 0) {\n"
     "    for (int i = 0; i < 5; ++i)\n"
     "      atomicAdd(&g_probe[i], (unsigned long long)tpr[i]);\n"
     "    atomicAdd(&g_probe[5], (unsigned long long)(clock64() - tk0));\n"
     "    atomicAdd(&g_probe[6], (unsigned long long)expansions);\n"
     "  }\n"
     "  const int spec = SPEC ?"),
    ("const char* device_beam_error_string(int code) {",
     "int probe_counters(unsigned long long* out) {\n"
     "  unsigned long long zero[20] = {};\n"
     "  cudaMemcpyFromSymbol(out, g_probe, sizeof(zero));\n"
     "  return int(cudaMemcpyToSymbol(g_probe, zero, sizeof(zero)));\n}\n"
     "const char* device_beam_error_string(int code) {"),
    ("    const int nr = min(p.stage_rows, count - base);\n",
     "    const int nr = min(p.stage_rows, count - base);\n"
     "    long long tc = clock64();\n"),
    ("    __syncwarp();  // every staged row has landed\n",
     "    __syncwarp();  // every staged row has landed\n"
     "    probe_add(7, clock64() - tc);\n    tc = clock64();\n"),
    ("    __syncwarp();  // the chunk is scored before the stage is reused\n",
     "    __syncwarp();  // the chunk is scored before the stage is reused\n"
     "    probe_add(8, clock64() - tc);\n"),
    ("  if (ROW == kPqRow && p.table) build_table(p, w);\n",
     "  if (ROW == kPqRow && p.table) {\n"
     "    const long long tb = clock64();\n    build_table(p, w);\n"
     "    probe_add(9, clock64() - tb);\n  }\n"),
    ("                      int count, int& loaded) {\n"
     "  const int lane = threadIdx.x & 31;\n",
     "                      int count, int& loaded) {\n"
     "  const int lane = threadIdx.x & 31;\n"
     "  long long tg0 = clock64();\n"),
    ("  __syncwarp();\n  const int start = count;\n",
     "  __syncwarp();\n  if (mode == kHop) probe_add(10, clock64() - tg0);\n"
     "  tg0 = clock64();\n  const int start = count;\n"),
    ("  __syncwarp();\n  if constexpr (ROW == kSqRow || ROW == kRqRow || "
     "ROW == kPqRow) {\n",
     "  __syncwarp();\n  if (mode == kHop) probe_add(11, clock64() - tg0);\n"
     "  if constexpr (ROW == kSqRow || ROW == kRqRow || ROW == kPqRow) {\n"),
    ("    if constexpr (SPEC && ROW == kBqRow)\n      score_bq_lane(",
     "    long long ts = clock64();\n"
     "    if (mode == kHop) probe_add(16, ts - tg0);\n"
     "    if constexpr (SPEC && ROW == kBqRow)\n      score_bq_lane("),
    ("    const bool ok = nb >= 0 && pres && !((word >> (nb & 31)) & 1u);\n",
     "    if (mode == kHop) probe_add(17, clock64() - ts);\n"
     "    ts = clock64();\n"
     "    const bool ok = nb >= 0 && pres && !((word >> (nb & 31)) & 1u);\n"
     "    if (mode == kHop) probe_add(18, (ok ? 1 : 0) + clock64() - ts);\n"),
    ("    int nna = 0;\n    if (ROW == kBqRow && nn <= 32) {\n",
     "    probe_add(12, clock64() - tq);\n"
     "    int nna = 0;\n    if (ROW == kBqRow && nn <= 32) {\n"),
    ("    // merge into the other buffers: the stable order of [old | new], a new",
     "    probe_add(13, clock64() - tq);\n"
     "    // merge into the other buffers: the stable order of [old | new], a new"),
    ("    if (ROW == kBqRow && nn <= kFewNew) {\n",
     "    if (ROW == kBqRow && nn <= kFewNew) {\n      probe_add(19, 1);\n"),
    ("    beam_n = min(ef, beam_n + nn);\n    if (track) {",
     "    probe_add(15, clock64() - tq);\n"
     "    beam_n = min(ef, beam_n + nn);\n    if (track) {"),
]
# copies with one constant changed
COPIES = {
    "code_g2": [("constexpr int kCodeG = 4;", "constexpr int kCodeG = 2;")],
    "code_g8": [("constexpr int kCodeG = 4;", "constexpr int kCodeG = 8;")],
}
PARTS = ("upper_descent", "adjacency_round", "gather", "rank", "merge",
         "walk")
CODE_PARTS = {7: "row_copies", 8: "scoring", 10: "gather_loads",
              11: "gather_compaction", 12: "rank_widening",
              13: "merge_read_ahead", 15: "merge_beam", 16: "gather_ids_flags",
              17: "gather_spec_scoring", 18: "gather_flags_wait",
              19: "few_landing_share"}


def edited(edits) -> str:
    src = SOURCE.read_text()
    for old, new in edits:
        if old not in src:
            raise SystemExit(f"probe: the source no longer holds {old!r}")
        src = src.replace(old, new)
    return src


def build(copies: dict[str, str]) -> dict[str, Path]:
    """Builds each named source, one nvcc each, all started together."""
    from weaviate_tpu_torch import _build

    OUT.mkdir(parents=True, exist_ok=True)
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    procs, libs = {}, {}
    for name, src in copies.items():
        cu, so = OUT / f"{name}.cu", OUT / f"lib{name}.so"
        cu.write_text(src)
        procs[name] = subprocess.Popen(
            [_build.nvcc(), *flags, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        libs[name] = so
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"probe: nvcc failed for {name}:\n{log[-4000:]}")
    return libs


def inputs(row: str, rows: int):
    """(scorer, queries, operands, adjacency, present, eps, allow) on the
    card, the rows of type ``row``."""
    from weaviate_tpu_torch.ops import device_beam as db
    from weaviate_tpu_torch.ops.distance import normalize

    _, d, _ = ROWS[row]
    gen = torch.Generator(device="cuda").manual_seed(0)
    if row == "bq":
        # random packed sign bits; the queries are the first rows with the
        # low 12 bits of each word flipped at random
        w = (d + 31) // 32
        packed = torch.randint(-2**31, 2**31 - 1, (rows, w), device="cuda",
                               generator=gen, dtype=torch.int32)
        pop = torch.zeros(rows, device="cuda")
        for i in range(32):
            pop += ((packed >> i) & 1).sum(1).float()
        q = (packed[:B] ^ torch.randint(0, 1 << 12, (B, w), device="cuda",
                                        generator=gen, dtype=torch.int32))
        adj = torch.randint(0, rows, (rows, M0), device="cuda",
                            generator=gen, dtype=torch.int32)
        present = torch.ones(rows, dtype=torch.bool, device="cuda")
        eps = torch.randint(0, rows, (B,), device="cuda", generator=gen,
                            dtype=torch.int32)
        allow = torch.rand(rows, device="cuda", generator=gen) < 0.45
        return (db.BQScorer(d), q.contiguous(), (packed, pop), adj, present,
                eps, allow)
    c = normalize(torch.randn(rows, d, device="cuda", generator=gen))
    adj = torch.randint(0, rows, (rows, M0), device="cuda", generator=gen,
                        dtype=torch.int32)
    present = torch.ones(rows, dtype=torch.bool, device="cuda")
    q = normalize(c[:B] + 0.08 * torch.randn(B, d, device="cuda",
                                             generator=gen)).contiguous()
    eps = torch.randint(0, rows, (B,), device="cuda", generator=gen,
                        dtype=torch.int32)
    allow = torch.rand(rows, device="cuda", generator=gen) < 0.45
    if row == "raw":
        scorer, operands = db.RawScorer("cosine", "bf16"), (c.contiguous(),)
    elif row == "pq":
        # codes and codebooks drawn at random: a walk's bytes and rounds do
        # not depend on what the centroids hold
        m = PQ_SEGMENTS
        codes = torch.randint(0, PQ_CENTROIDS, (rows, m), device="cuda",
                              generator=gen, dtype=torch.uint8)
        cb = (0.25 * torch.randn(m, PQ_CENTROIDS, d // m, device="cuda",
                                 generator=gen)).to(torch.bfloat16)
        norms = (cb.float() ** 2).sum(-1)  # [m, centroids]
        dsq = norms.gather(1, codes.long().t()).sum(0).contiguous()
        scorer, operands = db.PQScorer("l2-squared"), (codes, cb, dsq)
    else:
        # codes of the unit rows on a fixed grid of [-1, 1], the SQ decode
        # and RQ's per-row lower and step
        step = 2.0 / 255.0
        codes = ((c + 1.0) / step).round().clamp(0, 255).to(torch.uint8)
        dec = codes.float() * step - 1.0
        dsq = (dec * dec).sum(1).contiguous()
        if row == "sq":
            scorer = db.SQScorer("cosine")
            operands = (codes.contiguous(), dsq, -1.0, step)
        else:
            lower = torch.full((rows,), -1.0, device="cuda")
            steps = torch.full((rows,), step, device="cuda")
            scorer = db.RQScorer("cosine")
            operands = (codes.contiguous(), lower, steps, dsq)
    return scorer, q, operands, adj, present, eps, allow


def launch_ms(fn, iters: int) -> float:
    """Device ms a launch: events around ``iters`` launches back to back."""
    for _ in range(3):
        fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--row", choices=tuple(ROWS), default="raw")
    ap.add_argument("--rows", type=int, default=None)
    ap.add_argument("--ef", type=int, default=None,
                    help="the beam width (default: the cell's)")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--against", default=None)
    ap.add_argument("--copies", default="",
                    help=f"comma-separated, of {sorted(COPIES)}")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from weaviate_tpu_torch.ops import device_beam as db

    rows = args.rows or ROWS[args.row][0]
    ef = args.ef or ROWS[args.row][2]
    copies = {"as_is": SOURCE.read_text(), "counters": edited(COUNTERS)}
    for name in filter(None, args.copies.split(",")):
        copies[name] = edited(COPIES[name])
    if args.against:
        copies["against"] = Path(args.against).read_text()
    libs = {name: db.declare(ctypes.CDLL(str(path)))
            for name, path in build(copies).items()}
    scorer, q, ops, adj, present, eps, allow = inputs(args.row, rows)
    up = db._empty_upper("cuda")
    steps = 4 * ef + 64
    walk = (scorer, q, ops, adj, present, eps, *up, ef, steps)
    kw = dict(allow=allow, keep_k=32, expand=1)
    ref = None
    for name, lib in libs.items():
        db._library = lambda lib=lib: lib
        stats = torch.zeros((B, len(db.STATS)), dtype=torch.int32,
                            device="cuda")
        ids, _ = db.fused_search_cuda(*walk, stats=stats)
        ms = launch_ms(lambda: db.fused_search_cuda(*walk), args.iters)
        hops = int(stats[:, 0].max())
        hops_median = float(stats[:, 0].float().median())
        out = {"copy": name, "row": args.row, "rows": rows,
               "dims": ROWS[args.row][1], "b": B, "ef": ef,
               "launch_ms": ms, "hops_max": hops,
               "hops_mean": float(stats[:, 0].float().mean()),
               "hops_median": hops_median,
               "us_per_hop": ms * 1e3 / max(1, hops),
               "us_per_hop_median": ms * 1e3 / max(1.0, hops_median),
               "scored_mean": float(stats[:, 1].float().mean()),
               "speculative_rows_mean": float(stats[:, 4].float().mean()),
               "read_ahead_lost_mean": float(stats[:, 5].float().mean())}
        if ref is None:
            ref = ids
        else:
            out["ids_equal_share"] = float((ids == ref).float().mean())
        if name == "as_is":
            # held against the plain version, unfiltered and filtered
            for tag, extra in (("", {}), ("filtered_", kw)):
                got = db.fused_search_cuda(*walk, **extra)
                want = db._fused_search(*walk, **extra)
                out[f"{tag}ids_equal_plain_share"] = float(torch.cat(
                    [(g == w_).float().flatten()
                     for g, w_ in zip(got[::2], want[::2])]).mean())
                live = (got[0] == want[0]) & (want[0] >= 0)
                out[f"{tag}max_abs_err_plain"] = float(
                    (got[1] - want[1]).abs()[live].max()) if bool(
                        live.any()) else 0.0
            out["filtered_launch_ms"] = launch_ms(
                lambda: db.fused_search_cuda(*walk, **kw), args.iters)
        if name == "counters":
            lib.probe_counters.argtypes = [ctypes.c_void_p]
            cnt = (ctypes.c_ulonglong * NCOUNT)()
            torch.cuda.synchronize()
            lib.probe_counters(cnt)  # reset
            db.fused_search_cuda(*walk)
            torch.cuda.synchronize()
            lib.probe_counters(cnt)
            per_hop = {part: cnt[i] / max(1, cnt[6])
                       for i, part in enumerate(PARTS)}
            per_hop.update({part: cnt[i] / max(1, cnt[6])
                            for i, part in CODE_PARTS.items()})
            out["cycles_per_hop"] = per_hop
            out["table_cycles_per_walk"] = cnt[9] / B
            out["hops_counted"] = cnt[6]
        print(json.dumps(out), flush=True)
    if args.against:
        turns = []
        for name in ("as_is", "against", "against", "as_is"):
            db._library = lambda lib=libs[name]: lib
            turns.append((name, launch_ms(
                lambda: db.fused_search_cuda(*walk), args.iters)))
        print(json.dumps({"turns": turns}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
