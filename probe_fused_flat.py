"""Where the fused flat kernel's time goes, on one card.

    python3 probe_fused_flat.py [--shapes] [--copies a,b] [--against DIR]
                                [--iters 20]

At the main path's shapes (a seeded randn 1,048,576 x 768 float32 device
corpus, 1% masked, B = 256, k = 10, block 2048, fold 16) it times
``block_topk_cuda`` (CUDA events, median) for copies of
``weaviate_tpu_torch/csrc/fused_flat.cu`` built with one setting changed
(cluster size, ring depth, consumer warps, stages per join, the legacy
variant everywhere, a 16-query tile) or one part switched off (the corpus
copies, the products, the fold: such a copy gives wrong answers and is only
timed), and counts with clock64 how a CTA's cycles split into set-up, the
ring loop, the consumer warps' waits for data, the producer warp's waits
and the extraction. Every copy that should be right is held against the
plain version. ``--shapes`` times the copies over ``SHAPES`` instead (other
k, fold, batch and width on the same number of rows), and ``--copies``
picks copies by name. With ``--against DIR`` it also times the kernel of
the checkout at DIR, in turns with this one (DIR, this, this, DIR), each in
its own process.

A copy is made by replacing exact lines of the source; when the source no
longer holds one, the probe stops and names it (the CPU tests apply every
copy's edits). Builds go to ``weaviate_tpu_torch/_build/probe/``. Prints
one JSON line per measurement, then the card's name and power limit. Needs
a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
SOURCE = ROOT / "weaviate_tpu_torch" / "csrc" / "fused_flat.cu"
OUT = ROOT / "weaviate_tpu_torch" / "_build" / "probe"

N, D, B, K, BLOCK, FOLD = 1 << 20, 768, 256, 10, 2048, 16

# (old, new) replacements of each copy; the names say what changes
PLANS = "      int cs = MAX_CLUSTER;"
STAGES = "    for (int st = 8; st >= 3 && aligned && ring_folds(folds); --st) {"
CONSUMERS = "constexpr int CWARPS = 8;"
JOINS = "constexpr int JOIN = 4;"
EDITS = {
    "as_is": [],
    "cluster_1": [(PLANS, "      int cs = 1;")],
    "cluster_4": [(PLANS, "      int cs = 4;")],
    "stages_4": [(STAGES, "    for (int st = 4; st >= 3 && aligned && ring_folds(folds); --st) {")],
    "legacy": [(STAGES, "    for (int st = 8; st >= 3 && false; --st) {")],
    "query_tile_16": [("  const int qts[] = {64, 32, 16};",
                       "  const int qts[] = {16};")],
    "consumers_4": [(CONSUMERS, "constexpr int CWARPS = 4;")],
    "join_2": [(JOINS, "constexpr int JOIN = 2;")],
    "join_8": [(JOINS, "constexpr int JOIN = 8;")],
    "no_copies": [(
        "      mbar_expect_tx(full + slot, RT * KS * int(sizeof(T)));\n"
        "      tma_load(",
        "      mbar_expect_tx(full + slot, 0);\n      if (0) tma_load(")],
    "no_products": [(
        "      if (kc % JOIN == 0)\n"
        "        stage_mma<T, QT, true>(acc, part, A, L.ldq, R, ncol, lane);\n"
        "      else\n"
        "        stage_mma<T, QT, false>(acc, part, A, L.ldq, R, ncol, lane);\n",
        "      (void)A, (void)R;\n")],
    "no_fold": [("            if (d < bval[r * L.vp + j]) {",
                 "            if (0) {")],
}
# copies that give wrong answers by design, so are only timed
ABLATIONS = ("no_copies", "no_products", "no_fold")
# --shapes: (name, B, D, k, fold) on N rows, block 2048
SHAPES = [
    ("main", 256, 768, 10, 16),
    ("k32_fold8", 256, 768, 32, 8),
    ("k32_fold4", 256, 768, 32, 4),
    ("k64_fold4", 256, 768, 64, 4),
    ("k10_fold2", 256, 768, 10, 2),
    ("b1", 1, 768, 10, 16),
    ("b16", 16, 768, 10, 16),
    ("d99_legacy", 256, 99, 10, 16),
]
# clock64 counters: [0] consumer waits for data, [1] consumer ring loop,
# [2] producer waits on consumed, [3] producer waits on empty, [4] producer
# loop, [5] set-up, [6] extraction (summed over warps)
COUNTERS = [
    ("namespace {\n", "__device__ unsigned long long g_probe[8];\nnamespace {\n"),
    ("  using W = Warps<QT>;\n  extern __shared__",
     "  using W = Warps<QT>;\n  const long long tk0 = clock64();\n"
     "  extern __shared__"),
    ("  int slot = 0, phase = 0, t = 0, kc = 0;\n",
     "  int slot = 0, phase = 0, t = 0, kc = 0;\n"
     "  long long tc = 0, te = 0, t0 = clock64();\n"),
    ("      mbar_wait(consumed + slot, phase ^ 1);\n",
     "      long long w = clock64(); mbar_wait(consumed + slot, phase ^ 1);"
     " tc += clock64() - w;\n"),
    ("      mbar_wait(empty + slot, phase ^ 1);\n",
     "      w = clock64(); mbar_wait(empty + slot, phase ^ 1);"
     " te += clock64() - w;\n"),
    ("    if (++slot == stages) slot = 0, phase ^= 1;\n  }\n}",
     "    if (++slot == stages) slot = 0, phase ^= 1;\n  }\n"
     "  if (lane == 0) { atomicAdd(&g_probe[2], tc); atomicAdd(&g_probe[3], te);"
     " atomicAdd(&g_probe[4], clock64() - t0); }\n}"),
    ("  consumer_sync();\n\n  // This thread's accumulators",
     "  consumer_sync();\n  if (lane == 0) atomicAdd(&g_probe[5], clock64() - tk0);\n"
     "  long long tw = 0, tl = clock64();\n\n  // This thread's accumulators"),
    ("      mbar_wait(full + slot, phase);\n",
     "      long long w = clock64(); mbar_wait(full + slot, phase);"
     " tw += clock64() - w;\n"),
    ("  }\n  consumer_sync();\n\n  if (folds <= 128)",
     "  }\n  if (lane == 0) { atomicAdd(&g_probe[0], tw);"
     " atomicAdd(&g_probe[1], clock64() - tl); }\n  consumer_sync();\n\n"
     "  if (folds <= 128)"),
    ("  if (folds <= 128)\n    extract_rounds_regs",
     "  const long long tx = clock64();\n  if (folds <= 128)\n    extract_rounds_regs"),
    ("                   out_v, out_i, CWARPS, warp, lane);\n  cluster_sync();",
     "                   out_v, out_i, CWARPS, warp, lane);\n"
     "  if (lane == 0) atomicAdd(&g_probe[6], clock64() - tx);\n"
     "  cluster_sync();"),
    ("const char* fused_flat_error_string(int err) {",
     "int probe_counters(unsigned long long* out) {\n"
     "  unsigned long long zero[8] = {};\n"
     "  cudaMemcpyFromSymbol(out, g_probe, sizeof(zero));\n"
     "  return int(cudaMemcpyToSymbol(g_probe, zero, sizeof(zero)));\n}\n"
     "const char* fused_flat_error_string(int err) {"),
]


def edited(edits) -> str:
    src = SOURCE.read_text()
    for old, new in edits:
        if old not in src:
            raise SystemExit(f"probe: the source no longer holds {old!r}")
        src = src.replace(old, new)
    return src


def consumer_warps(src: str) -> int:
    return int(re.search(r"constexpr int CWARPS = (\d+);", src).group(1))


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


def inputs(b: int = B, d: int = D):
    gen = torch.Generator(device="cuda").manual_seed(0)
    c = torch.randn(N, d, device="cuda", generator=gen)
    sq = (c * c).sum(1)
    m = torch.rand(N, device="cuda", generator=gen) > 0.01
    q = (c[:b] + 0.1 * torch.randn(b, d, device="cuda", generator=gen))
    return q.contiguous(), c, sq, m


def median_ms(fn, iters: int) -> float:
    for _ in range(3):
        fn()
    ts = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return sorted(ts)[len(ts) // 2]


def shapes(all_shapes: bool):
    return SHAPES if all_shapes else SHAPES[:1]


def time_checkout(root: str, iters: int, all_shapes: bool) -> None:
    """Times the kernel of the checkout at ``root`` (its own build)."""
    sys.path.insert(0, root)
    from weaviate_tpu_torch.ops import fused_flat as ff

    for shape, b, d, k, fold in shapes(all_shapes):
        q, c, sq, m = inputs(b, d)
        out = {"checkout": root, "shape": shape}
        try:
            out["kernel_ms"] = median_ms(
                lambda: ff.block_topk_cuda(q, c, sq, m, k, BLOCK, fold), iters)
        except (RuntimeError, ValueError) as e:
            out["error"] = str(e)
        print(json.dumps(out), flush=True)
        del q, c, sq, m


def cycles(lib, run, plan: dict, cwarps: int) -> dict:
    """A CTA's clock64 cycles from the ``counters`` copy, per part."""
    lib.probe_counters.argtypes = [ctypes.c_void_p]
    cnt = (ctypes.c_ulonglong * 8)()
    run()
    torch.cuda.synchronize()
    lib.probe_counters(cnt)  # reset
    run()
    torch.cuda.synchronize()
    lib.probe_counters(cnt)
    ctas = (-(-B // plan["query_tile"])) * (N // BLOCK)
    warps = ctas * cwarps
    return {"setup": cnt[5] / warps, "ring_loop": cnt[1] / warps,
            "waiting_for_data": cnt[0] / warps, "extraction": cnt[6] / warps,
            "producer_loop": cnt[4] / ctas,
            "producer_waiting_on_consumers": cnt[2] / ctas,
            "producer_waiting_on_cluster": cnt[3] / ctas}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", default=None)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--shapes", action="store_true")
    ap.add_argument("--copies", default=None)
    ap.add_argument("--time-checkout", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe: no CUDA device", file=sys.stderr)
        return 2
    if args.time_checkout:
        time_checkout(args.time_checkout, args.iters, args.shapes)
        return 0
    sys.path.insert(0, str(ROOT))
    from weaviate_tpu_torch.ops import fused_flat as ff

    names = args.copies.split(",") if args.copies else [*EDITS, "counters"]
    copies = {name: edited(COUNTERS if name == "counters" else EDITS[name])
              for name in names}
    libs = {name: ff.declare(ctypes.CDLL(str(path)))
            for name, path in build(copies).items()}
    for shape, b, d, k, fold in shapes(args.shapes):
        q, c, sq, m = inputs(b, d)
        pv, pi = ff.block_topk_reference(q, c, sq, m, k, BLOCK, fold)
        for name, lib in libs.items():
            ff._library = lambda lib=lib: lib
            run = lambda: ff.block_topk_cuda(q, c, sq, m, k, BLOCK, fold)
            variant, plan = ff.kernel_variant(q, c, k, BLOCK, fold)
            out = {"copy": name, "shape": shape, "variant": variant,
                   "plan": plan}
            if name not in ABLATIONS:
                kv, ki = run()
                out["outside_tolerance"] = int(
                    ((kv - pv).abs() > 1e-2 + 1e-4 * pv.abs()).sum())
                out["ids_equal_share"] = float((ki == pi).float().mean())
            if name == "counters" and shape == "main":
                out["cycles_per_cta"] = cycles(lib, run, plan,
                                               consumer_warps(copies[name]))
            out["kernel_ms"] = median_ms(run, args.iters)
            print(json.dumps(out), flush=True)
        del q, c, sq, m, pv, pi
    if args.against:
        extra = ["--shapes"] if args.shapes else []
        for root in (args.against, str(ROOT), str(ROOT), args.against):
            subprocess.run([sys.executable, __file__, "--time-checkout", root,
                            "--iters", str(args.iters), *extra], check=True,
                           timeout=600)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
