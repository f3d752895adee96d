"""Where the fused HNSW walk's (B2) time goes, on one card.

    python3 probe_device_beam.py [--against FILE.cu] [--rows 1200000]
                                 [--iters 10]

On a graph of ``--rows`` nodes with 32 random neighbours each (seeded on
the card; the walk's memory pattern at the scale of phase ``hnsw``, whose
HNSW ids are random too, without its four-minute build), unit 25-d rows,
cosine at bf16, B = 256 queries (rows + noise), ef 64 and the search's
``max_steps``, it times ``fused_search_cuda`` (CUDA events around
``--iters`` launches back to back, so the host's part of a launch is
hidden) for ``weaviate_tpu_torch/csrc/device_beam.cu`` as it is
(``as_is``), held against the plain version (the share of equal ids),
unfiltered and filtered (45% allowed, a kept track of 32, expand 1). A
copy of it with clock64 counters (``counters``) splits a warp's cycles
into the upper descent, a hop's adjacency round, its gather (flags, rows,
compaction, marks), the rank of its new entries and the merge.
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

D, M0, B, EF = 25, 32, 256, 64

# clock64 counters, summed over warps: [0] upper descent, [1] adjacency
# rounds, [2] gathers, [3] ranks of the new entries, [4] merges (the
# read-ahead issued), [5] the whole walk, [6] hops
COUNTERS = [
    ("namespace {\n", "__device__ unsigned long long g_probe[8];\nnamespace {\n"),
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
    ("      nna += __popc(__ballot_sync(kFull, al));\n    }\n    __syncwarp();\n",
     "      nna += __popc(__ballot_sync(kFull, al));\n    }\n    __syncwarp();\n"
     "    tpr[3] += clock64() - tq; tq = clock64();\n"),
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
     "  unsigned long long zero[8] = {};\n"
     "  cudaMemcpyFromSymbol(out, g_probe, sizeof(zero));\n"
     "  return int(cudaMemcpyToSymbol(g_probe, zero, sizeof(zero)));\n}\n"
     "const char* device_beam_error_string(int code) {"),
]
PARTS = ("upper_descent", "adjacency_round", "gather", "rank", "merge",
         "walk")


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


def inputs(rows: int):
    """(queries, corpus, adjacency, present, eps, allow) on the card."""
    from weaviate_tpu_torch.ops.distance import normalize

    gen = torch.Generator(device="cuda").manual_seed(0)
    c = normalize(torch.randn(rows, D, device="cuda", generator=gen))
    adj = torch.randint(0, rows, (rows, M0), device="cuda", generator=gen,
                        dtype=torch.int32)
    present = torch.ones(rows, dtype=torch.bool, device="cuda")
    q = normalize(c[:B] + 0.08 * torch.randn(B, D, device="cuda",
                                             generator=gen)).contiguous()
    eps = torch.randint(0, rows, (B,), device="cuda", generator=gen,
                        dtype=torch.int32)
    allow = torch.rand(rows, device="cuda", generator=gen) < 0.45
    return q, c.contiguous(), adj, present, eps, allow


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
    ap.add_argument("--rows", type=int, default=1_200_000)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--against", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from weaviate_tpu_torch.ops import device_beam as db

    copies = {"as_is": SOURCE.read_text(), "counters": edited(COUNTERS)}
    if args.against:
        copies["against"] = Path(args.against).read_text()
    libs = {name: db.declare(ctypes.CDLL(str(path)))
            for name, path in build(copies).items()}
    q, c, adj, present, eps, allow = inputs(args.rows)
    up = db._empty_upper("cuda")
    scorer = db.RawScorer("cosine", "bf16")
    steps = 4 * EF + 64
    ref = None
    for name, lib in libs.items():
        db._library = lambda lib=lib: lib
        stats = torch.zeros((B, len(db.STATS)), dtype=torch.int32,
                            device="cuda")
        ids, _ = db.fused_search_cuda(scorer, q, (c,), adj, present, eps, *up,
                                      EF, steps, stats=stats)
        ms = launch_ms(lambda: db.fused_search_cuda(
            scorer, q, (c,), adj, present, eps, *up, EF, steps), args.iters)
        hops = int(stats[:, 0].max())
        out = {"copy": name, "rows": args.rows, "b": B, "ef": EF,
               "launch_ms": ms, "hops_max": hops,
               "hops_mean": float(stats[:, 0].float().mean()),
               "us_per_hop": ms * 1e3 / max(1, hops),
               "speculative_rows_mean": float(stats[:, 4].float().mean()),
               "read_ahead_lost_mean": float(stats[:, 5].float().mean())}
        if ref is None:
            ref = ids
        else:
            out["ids_equal_share"] = float((ids == ref).float().mean())
        if name == "as_is":
            # held against the plain version, unfiltered and filtered
            kw = dict(allow=allow, keep_k=32, expand=1)
            for tag, extra in (("", {}), ("filtered_", kw)):
                got = db.fused_search_cuda(scorer, q, (c,), adj, present, eps,
                                           *up, EF, steps, **extra)
                want = db._fused_search(scorer, q, (c,), adj, present, eps,
                                        *up, EF, steps, **extra)
                out[f"{tag}ids_equal_plain_share"] = float(torch.cat(
                    [(g == w_).float().flatten()
                     for g, w_ in zip(got[::2], want[::2])]).mean())
            out["filtered_launch_ms"] = launch_ms(lambda: db.fused_search_cuda(
                scorer, q, (c,), adj, present, eps, *up, EF, steps, **kw),
                args.iters)
        if name == "counters":
            lib.probe_counters.argtypes = [ctypes.c_void_p]
            cnt = (ctypes.c_ulonglong * 8)()
            torch.cuda.synchronize()
            lib.probe_counters(cnt)  # reset
            db.fused_search_cuda(scorer, q, (c,), adj, present, eps, *up, EF,
                                 steps)
            torch.cuda.synchronize()
            lib.probe_counters(cnt)
            out["cycles_per_hop"] = {
                part: cnt[i] / max(1, cnt[6]) for i, part in enumerate(PARTS)}
            out["hops_counted"] = cnt[6]
        print(json.dumps(out), flush=True)
    if args.against:
        turns = []
        for name in ("as_is", "against", "against", "as_is"):
            db._library = lambda lib=libs[name]: lib
            turns.append((name, launch_ms(lambda: db.fused_search_cuda(
                scorer, q, (c,), adj, present, eps, *up, EF, steps),
                args.iters)))
        print(json.dumps({"turns": turns}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
