"""Where the quantized scans' (Q1-Q4) time goes, and how often a sound
or a faulty Q2 gives the plain version's ids, on one card.

    python3 probe_quantized.py [--iters 5] [--scans bq,sq,pq,rq]
                               [--copies as_is,no_select,...]
                               [--against DIR]
    python3 probe_quantized.py --merge [--scans ...] [--against DIR]
    python3 probe_quantized.py --agreement

At phase ``quant``'s and ``pq``'s shapes (B = 256; Q1 over 10,002,432 x
768 bits with fetch 320; Q2 over 552,960 x 768 codes with fetch 200,
cosine; Q3 over config 3's 1,000,000 rows of 96 codes into 96 x 256
centroids of 16, fetch 40, l2-squared; Q4 over the tenant's 550,000 x 768
codes, fetch 200, cosine) on seeded random codes made on the card (Q1's
queries are rows with 20 low bits of each word flipped; 1% of the rows
masked), it times one scan launch (``bq_scan_cuda`` / ``sq_scan_cuda`` /
``pq_scan_cuda`` / ``rq_scan_cuda`` into the search's own lists, CUDA
events, the median of ``--iters``) for copies of
``weaviate_tpu_torch/csrc/quantized.cu``, each with one part switched off
(Q1 is ``bq_scan_kernel``; Q2-Q4 are ``wg_scan_kernel``):

- ``as_is``: the source as it is;
- ``no_select``: no selection (no key is below a threshold: nothing is
  taken, appended or compacted; the lists are only padded);
- ``no_mma``: the tensor-core products left out (Q1: one integer add a
  fragment in place of the 1-bit ``mma``; Q2-Q4: no ``wgmma``);
- ``no_epilogue`` (Q2-Q4): no tile ends (no keys and no selection);
- ``no_widen`` (Q2, Q4): the codes not widened to bf16 (the products read
  stale tiles);
- ``no_loads`` (Q2-Q4): no row operands staged and no query blocks copied
  after the first steps;
- ``no_decode`` (Q3): no centroid gathers (the products read stale
  tiles);
- ``no_window`` (Q3): no copies of the rows' codes (the gathers read stale
  codes);
- ``counters`` (Q2-Q4): the selection's counters, written into the lists'
  tails and printed: lists compacted, a consumer thread's cycles waiting
  for compactions at tile ends, in its tile ends and in all, and each
  helper warp's cycles compacting (``COUNTERS``);
- ``int8`` (Q1): Q1's other exact product route, an int8 ``mma.m16n8k32``
  on the bits widened to {0,1} bytes in registers, in place of the 1-bit
  ``mma`` (the one copy that is a kernel too: it gives Q1's answers).

Each scan times the copies that apply to it (``APPLIES``), or those of
``--copies``. The other copies give wrong answers by design. The copies
are made by replacing exact text of the source; when the source no longer
holds it, the probe stops and names it (``tests/test_torch_quantized.py``
applies the edits on the CPU). Builds go to
``weaviate_tpu_torch/_build/probe_q/``. Prints one JSON line per copy.

``--against DIR`` also times another checkout's scans (its
``ops/quantized.py`` and its kernel source, built beside this one's) in
turns with this one's on the same inputs, and prints their times and the
id agreement of the two merged answers; for the copies asked for, it also
times the earlier template ``code_scan_kernel`` with the same part
switched off (``CODE_SCAN_COPIES``, for a checkout of commit 202d8c9:
``git archive 202d8c9 | tar -x -C _chipcheck/parent``).

``--merge`` times the merge alone (``merge_partials``, one launch) at the
four scans' shapes (the lists ``scan_plan`` gives each scan above: [splits,
256, fetch]) on the lists a scan launch of the source as it is leaves on
those operands: each split's taken entries first, in row order, then
padding. It prints the lists' fill (entries taken a split and a query,
whether any taken entry follows padding), the merge's time for the source
as it is and for copies with one part switched off (``MERGE_COPIES``),
``torch.topk`` over the same keys, and with ``--against`` the other
checkout's merge in turns with this one's and its copies
(``AGAINST_MERGE_COPIES``, for the merge of commit 33d8133).

``--agreement`` runs ``chip_smoke.py``'s Q1/Q2 grid (``quant_kernel_grid``,
same seed, so the same rows and queries) once for each of these Q2s, with
its id-agreement floors lifted so that each reads out:

- ``kernel``: kernel Q2 as it is;
- ``fp64_sum``: bf16(q) . c summed in float64, a sound Q2 that sums in
  another order;
- ``q_6bit``: the queries rounded to 6 stored mantissa bits, one fewer than
  bf16, a Q2 of lower precision;
- ``bf16_truncated``: the queries cut to bf16 (rounded toward zero) where
  the kernel rounds to nearest, a Q2 of the same precision with a bias;
- ``high_row_first``: the plain product, ties resolved by the higher row, a
  Q2 whose selection is not stable.

The variants other than ``kernel`` are torch programs on the plain
version's epilogue and chunked top-k. Prints one JSON line per Q2: the
grid's and the edges' id agreement, or the check of ``compare`` that
refused it.

Either mode then prints the card's name and power limit. Needs a CUDA
card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SOURCE = ROOT / "weaviate_tpu_torch" / "csrc" / "quantized.cu"
OUT = ROOT / "weaviate_tpu_torch" / "_build" / "probe_q"

B, D = 256, 768
BQ_ROWS, BQ_FETCH = 10_002_432, 320
SQ_ROWS, SQ_FETCH = 552_960, 200
PQ_ROWS, PQ_D, PQ_M, PQ_FETCH = 1_000_000, 1536, 96, 40
RQ_ROWS, RQ_FETCH = 550_000, 200

COPIES = {
    "as_is": [],
    "no_select": [
        ("      select_tile<kBqR, HammingKeys>(",
         "      if (false) select_tile<kBqR, HammingKeys>("),
        # no key is below a threshold of 0: nothing is taken, appended or
        # compacted
        ("        const uint32_t th = lds_u32(&s.thr[ql]);\n"
         "        const float qs",
         "        const uint32_t th = 0u;\n"
         "        const float qs"),
    ],
    "no_mma": [
        ('      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "\n'
         '      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\\n"',
         '      "add.s32 %0, %0, %8; add.s32 %1, %1, %9; '
         'add.s32 %2, %2, %4; add.s32 %3, %3, %5;"'),
        ("      wgmma_m64n256k16(acc, wg_desc(abase + ks * 256, 128, 1024),",
         "      if (false) wgmma_m64n256k16(acc, wg_desc(abase + ks * 256, "
         "128, 1024),"),
    ],
    # the helpers and the last wait skip the tile ends, which never come
    "no_epilogue": [
        ("    if (kc != chunks - 1) continue;\n", "    continue;\n"),
        ("      mbar_wait(&s.ep_done, t & 1);\n", "      break;\n"),
        ("  mbar_wait(&s.sel_done, (tiles - 1) & 1);\n", ""),
    ],
    "no_widen": [
        ("      widen(st + 1);\n", ""),
    ],
    # no row operands after the first steps and no query blocks after the
    # first ring (Q3 at config 3 stages one code span a tile: only the
    # first)
    "no_loads": [
        ("    if (st + kWgAhead < steps) prep(st + kWgAhead);\n", ""),
        ("    mbar_wait(&s.full[stage], (st / kWgQStages) & 1);\n",
         "    if (st < kWgQStages) "
         "mbar_wait(&s.full[stage], (st / kWgQStages) & 1);\n"),
        ("      for (int st = 0; st < steps; ++st) {\n        if constexpr",
         "      for (int st = 0; st < min(steps, kWgQStages); ++st) {\n"
         "        if constexpr"),
    ],
    "no_decode": [
        ("        copy_piece(a + (kk >> 3) * 64 + (kk & 7), src, ok, piece);",
         "        if (false) copy_piece(a + (kk >> 3) * 64 + (kk & 7), src, "
         "ok, piece);"),
    ],
    # the spans expect no bytes: the gathers read stale codes
    "no_window": [
        ("          if (bytes[j])\n", "          if (false)\n"),
        ("        if (lane == 0) mbar_expect_tx(&s.span_full[buf], total);",
         "        if (lane == 0) mbar_expect_tx(&s.span_full[buf], 0u);"),
    ],
}
# the same parts switched off in the earlier template of Q2-Q4
# (`code_scan_kernel`), for the split of the scans before their redesign:
# ``--against`` a checkout of that source (commit 202d8c9)
CODE_SCAN_COPIES = {
    "no_select": [("    select_tile<kSqR, OrderKeys>(",
                   "    if (false) select_tile<kSqR, OrderKeys>(")],
    "no_mma": [('      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32'
                ' "\n      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, '
                '{%0,%1,%2,%3};\\n"',
                '      "add.f32 %0, %0, 0f3F800000; add.f32 %1, %1, '
                '0f3F800000; add.f32 %2, %2, 0f3F800000; add.f32 %3, %3, '
                '0f3F800000;"')],
    "no_epilogue": [("    if (kc != chunks - 1) continue;\n",
                     "    continue;\n")],
    "no_widen": [("    if (step + 1 < steps) widen_step(step + 1);\n", "")],
    "no_loads": [("    if (step + kSqStages - 1 < steps) "
                  "load_step(step + kSqStages - 1);\n", "")],
    "no_decode": [("      if (step + 1 < steps) decode_step(step + 1);\n",
                   "")],
    "no_window": [("      for (int c = tid; c < kSqR * kPqWords; "
                   "c += kThreads) {",
                   "      for (int c = tid; c < 0; c += kThreads) {")],
}

# the merge's parts switched off (``--merge``); each copy gives wrong
# answers by design, and reads no list entry out of place
MERGE_COPIES = {
    # no radix passes: the first taken places (at most k) survive
    "no_hist": [("  if (total > k) {\n    uint32_t todo = 0;",
                 "  if (false) {\n    uint32_t todo = 0;"),
                ("      if (key[u] != kNone && take)\n",
                 "      if (key[u] != kNone && take && place < k)\n"),
                ("  const int n = min(total, k);\n",
                 "  const int n = min(n_surv, k);\n")],
    # no collect: the survivors are the first k places, key 0
    "no_collect": [("  __syncthreads();  // n_surv is zeroed\n"
                    "  for (int g = tid; g < groups; g += kMThreads) {",
                    "  __syncthreads();  // n_surv is zeroed\n"
                    "  for (int i = tid; i < k; i += kMThreads)\n"
                    "    surv[i] = i < 4 * groups ? i : 0;\n"
                    "  for (int g = tid; g < 0; g += kMThreads) {")],
    # no sort: the survivors written in the order they were collected
    "no_sort": [("    rank[m] = 0;\n", "    rank[m] = e;\n"),
                ("rank[m] += (v.x < mine[m]) + (v.y < mine[m]);",
                 "rank[m] += 0 * ((v.x < mine[m]) + (v.y < mine[m]));"),
                ("    for (int m = 0; m < E; ++m) rank[m] += v < mine[m];",
                 "    for (int m = 0; m < E; ++m) rank[m] += 0 * (v < mine[m]);")],
}
# clock64 counters of the merge, summed over CTAs (thread 0's cycles):
# [0] the taken counts and places, [1] the staging, [2] the keys' AND and
# OR, [3] the select's passes, [4] the select (its passes and the
# collect), [5] the rank and the writes, [6] passes, [7] CTAs
MERGE_PARTS = ("counts", "staging", "and_or", "passes", "select",
               "rank_write")
MERGE_COUNTERS = [
    ("namespace {\n",
     "__device__ unsigned long long g_merge[8];\nnamespace {\n"),
    ("  // each split's taken count, then its first place (a multiple of 4)\n",
     "  long long t0 = clock64(), t1;\n"
     "  // each split's taken count, then its first place (a multiple of 4)\n"),
    ("  const int groups = places / 4;\n",
     "  t1 = clock64();\n  if (tid == 0) atomicAdd(&g_merge[0], t1 - t0);\n"
     "  t0 = t1;\n  const int groups = places / 4;\n"),
    ("  // the bits every taken key holds (AND) and any holds (OR)\n",
     "  t1 = clock64();\n  if (tid == 0) atomicAdd(&g_merge[1], t1 - t0);\n"
     "  t0 = t1;\n  // the bits every taken key holds (AND) and any holds (OR)\n"),
    ("  if (staged)\n    select_survivors<true>(L, groups,",
     "  t1 = clock64();\n  if (tid == 0) atomicAdd(&g_merge[2], t1 - t0);\n"
     "  t0 = t1;\n  if (staged)\n    select_survivors<true>(L, groups,"),
    ("  if (tid == 0) *n_surv = 0;\n",
     "  if (tid == 0) *n_surv = 0;\n  long long ts0 = clock64();\n"),
    ("      if (whole || shift == 0) {  // at shift 0 every bin is one value",
     "      if (tid == 0) atomicAdd(&g_merge[6], 1ull);\n"
     "      if (whole || shift == 0) {  // at shift 0 every bin is one value"),
    ("  __syncthreads();  // n_surv is zeroed\n",
     "  if (tid == 0) atomicAdd(&g_merge[3], clock64() - ts0);\n"
     "  ts0 = clock64();\n  __syncthreads();  // n_surv is zeroed\n"),
    ("  const int n = min(total, k);\n",
     "  t1 = clock64();\n"
     "  if (tid == 0) atomicAdd(&g_merge[4], t1 - t0);\n"
     "  t0 = t1;\n  const int n = min(total, k);\n"),
    ("    rank_write<kMaxK / kMThreads>(surv, n, L, out_d, out_i, k);\n}\n",
     "    rank_write<kMaxK / kMThreads>(surv, n, L, out_d, out_i, k);\n"
     "  if (tid == 0) atomicAdd(&g_merge[5], clock64() - t0);\n"
     "  if (tid == 0) atomicAdd(&g_merge[7], 1ull);\n}\n"),
    ('const char* quantized_error_string(int code) {',
     "int merge_counters(unsigned long long* out) {\n"
     "  unsigned long long zero[8] = {};\n"
     "  cudaMemcpyFromSymbol(out, g_merge, sizeof(zero));\n"
     "  return int(cudaMemcpyToSymbol(g_merge, zero, sizeof(zero)));\n}\n"
     'const char* quantized_error_string(int code) {'),
]

# the same parts of the merge of commit 33d8133, a radix select over every
# slot (``--merge --against`` a checkout of that commit)
AGAINST_MERGE_COPIES = {
    # no radix passes: the k-th key stays 0, so the collect keeps nothing
    "no_hist": [("  for (int shift = 24; shift >= 0; shift -= 8) {\n"
                 "    for (int i = tid; i < kBins; i += kThreads) hist[i] = 0;",
                 "  for (int shift = 24; shift >= 32; shift -= 8) {\n"
                 "    for (int i = tid; i < kBins; i += kThreads) hist[i] = 0;")],
    "no_collect": [("  for (int base = 0; base < total; "
                    "base += kThreads * kItems) {",
                    "  for (int base = 0; base < 0; "
                    "base += kThreads * kItems) {")],
    "no_sort": [("  for (int size = 2; size <= p; size <<= 1) {",
                 "  for (int size = 2; size <= 1; size <<= 1) {")],
}

# counters of the code scans' selection, written by each CTA into the tail
# of its first query's list (past the k entries the merge reads): the
# lists compacted, a consumer thread's cycles waiting for compactions at
# tile ends, in its tile ends' keys and appends, in all, and each helper
# warp's cycles compacting (all cycles / 1024)
COUNTERS = {
    "compactions": 1, "consumer_wait_kcycles": 2, "consumer_total_kcycles": 3,
    "helper0_kcycles": 4, "helper1_kcycles": 5, "helper2_kcycles": 6,
    "consumer_epilogue_kcycles": 8,
}
COPIES["counters"] = [
    ("  int span_off = 0;  // Q3: the staged span's offset of this thread's "
     "row\n",
     "  int span_off = 0;  // Q3: the staged span's offset of this thread's "
     "row\n  long long c_wait = 0, c_epi = 0, c_start = clock64(), c0 = 0;"
     "\n"),
    ("    if (t > 0) {\n      const int lim = ld_volatile(&s.tail);\n",
     "    c0 = clock64();\n    if (t > 0) {\n"
     "      const int lim = ld_volatile(&s.tail);\n"),
    ("      mbar_wait(&s.sel_done, (t - 1) & 1);\n    }\n",
     "      mbar_wait(&s.sel_done, (t - 1) & 1);\n    }\n"
     "    c_wait += clock64() - c0;\n    c0 = clock64();\n"),
    ("    if (lane == 0) mbar_arrive(&s.ep_done);\n    named_bar(3, 256);\n"
     "  }\n",
     "    if (lane == 0) mbar_arrive(&s.ep_done);\n    named_bar(3, 256);\n"
     "    c_epi += clock64() - c0;\n  }\n"),
    ("  mbar_wait(&s.sel_done, (tiles - 1) & 1);\n"
     "  wg_finish(s, lk, lr, base0, q0, b, cap, k);\n}",
     "  mbar_wait(&s.sel_done, (tiles - 1) & 1);\n"
     "  wg_finish(s, lk, lr, base0, q0, b, cap, k);\n"
     "  if (ct == 0) {\n"
     "    lk[base0 + cap - 1] = ld_volatile(&s.done);\n"
     "    lk[base0 + cap - 2] = (uint32_t)(c_wait >> 10);\n"
     "    lk[base0 + cap - 3] = (uint32_t)((clock64() - c_start) >> 10);\n"
     "    lk[base0 + cap - 8] = (uint32_t)(c_epi >> 10);\n  }\n}"),
    ("    const int hl = (warp - 1) * 32 + lane;  // 0 .. 95\n",
     "    const int hl = (warp - 1) * 32 + lane;  // 0 .. 95\n"
     "    long long h_busy = 0;\n"),
    ("      wg_drain(s, ld_volatile(&s.tail), lk, lr, base0, cap, k);\n",
     "      const long long h0 = clock64();\n"
     "      wg_drain(s, ld_volatile(&s.tail), lk, lr, base0, cap, k);\n"
     "      h_busy += clock64() - h0;\n"),
    ("    wg_wait_done(s, ld_volatile(&s.tail));\n",
     "    if (lane == 0) lk[base0 + cap - 4 - (warp - 1)] = "
     "(uint32_t)(h_busy >> 10);\n"
     "    wg_wait_done(s, ld_volatile(&s.tail));\n"),
]


def read_counters(lists) -> dict:
    """The ``counters`` copy's values of each split, as their mean and
    largest over the splits."""
    keys = lists[0][:, 0, :].long() & 0xFFFFFFFF
    cap = keys.shape[1]
    out = {}
    for name, at in COUNTERS.items():
        v = keys[:, cap - at].double()
        out[name] = {"mean": float(v.mean()), "max": float(v.max())}
    return out


# Q1's int8 product: a 32-bit word is one k32 step, nibble tig and nibble
# 4 + tig of each row's word widened to bytes in the slots of A and of B
INT8_HELPERS = r"""
__device__ __forceinline__ void mma_u8(int* c, const uint32_t* a, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t nibble_bytes(uint32_t w, int i) {
  return (((w >> (4 * i)) & 0xfu) * 0x00204081u) & 0x01010101u;
}

"""
B1_PRODUCT = """      for (int kb = 0; kb < wpad; kb += 8) {
        uint32_t a[4][4];
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          const uint32_t* qa = qs + (wm * 64 + mt * 16 + gid) * ws + kb + tig;
          a[mt][0] = qa[0];
          a[mt][1] = qa[8 * ws];
          a[mt][2] = qa[4];
          a[mt][3] = qa[8 * ws + 4];
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const uint32_t* xb = xs + (wn * 16 + nt * 8 + gid) * ws + kb + tig;
          const uint32_t b0 = xb[0], b1 = xb[4];
#pragma unroll
          for (int mt = 0; mt < 4; ++mt) mma_b1(acc[mt][nt], a[mt], b0, b1);
        }
      }
"""
INT8_PRODUCT = """      for (int j = 0; j < w; ++j) {
        uint32_t a[4][4];
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          const uint32_t* qa = qs + (wm * 64 + mt * 16 + gid) * ws + j;
          const uint32_t lo = qa[0], hi = qa[8 * ws];
          a[mt][0] = nibble_bytes(lo, tig);
          a[mt][1] = nibble_bytes(hi, tig);
          a[mt][2] = nibble_bytes(lo, 4 + tig);
          a[mt][3] = nibble_bytes(hi, 4 + tig);
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const uint32_t xw = xs[(wn * 16 + nt * 8 + gid) * ws + j];
          const uint32_t b0 = nibble_bytes(xw, tig);
          const uint32_t b1 = nibble_bytes(xw, 4 + tig);
#pragma unroll
          for (int mt = 0; mt < 4; ++mt) mma_u8(acc[mt][nt], a[mt], b0, b1);
        }
      }
"""
COPIES["int8"] = [
    ("// A stage of Q1's ring, in words:",
     INT8_HELPERS + "// A stage of Q1's ring, in words:"),
    (B1_PRODUCT, INT8_PRODUCT),
]
# the name the other checkout's kernel builds under (``--against``)
AGAINST = "against"
# the copies of `code_scan_kernel` each scan times
CODE_SCAN_APPLIES = {
    "no_select": ("sq", "pq", "rq"), "no_mma": ("sq", "pq", "rq"),
    "no_epilogue": ("sq", "pq", "rq"), "no_widen": ("sq", "rq"),
    "no_loads": ("sq", "pq", "rq"), "no_decode": ("pq",),
    "no_window": ("pq",)}
# the copies each scan times
APPLIES = {
    "bq": ("as_is", "no_select", "no_mma", "int8"),
    "sq": ("as_is", "no_select", "no_mma", "no_epilogue", "no_widen",
           "no_loads", "counters"),
    "pq": ("as_is", "no_select", "no_mma", "no_epilogue", "no_loads",
           "no_decode", "no_window", "counters"),
    "rq": ("as_is", "no_select", "no_mma", "no_epilogue", "no_widen",
           "no_loads", "counters"),
}


def edited(edits, source: Path = SOURCE) -> str:
    src = source.read_text()
    for old, new in edits:
        if old not in src:
            raise SystemExit(f"probe: the source no longer holds {old!r}")
        src = src.replace(old, new)
    return src


def build(sources: dict) -> dict[str, ctypes.CDLL]:
    """Each source text compiled with the port's flags, one nvcc each,
    together."""
    from weaviate_tpu_torch import _build
    from weaviate_tpu_torch.ops import quantized

    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        src = OUT / f"{name}.cu"
        src.write_text(text)
        lib = OUT / f"lib{name}.so"
        procs[name] = (subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"probe: nvcc failed for {name}:\n{log}")
        if name == "as_is":
            print(log, file=sys.stderr, flush=True)
        libs[name] = (lib if name.startswith(AGAINST)
                      else quantized.declare(ctypes.CDLL(str(lib))))
    return libs


def round_mantissa(x: torch.Tensor, bits: int) -> torch.Tensor:
    """float32 ``x`` rounded (half away from zero) to ``bits`` stored
    mantissa bits."""
    drop = 23 - bits
    i = x.contiguous().view(torch.int32)
    return ((i + (1 << (drop - 1))) & ~((1 << drop) - 1)).view(torch.float32)


def sq_variant(round_q, acc=torch.float32, high_row_first=False):
    """A Q2 with ``sq_search_cuda``'s arguments: the product of
    ``round_q(queries)`` and the codes summed in ``acc``, the plain
    version's epilogue and chunked top-k; ``high_row_first`` reverses the
    rows, so ties go to the higher row."""
    from weaviate_tpu_torch.ops import quantized

    def fn(queries, codes, dsq, a, s, mask, metric, k):
        n, b = codes.shape[0], queries.shape[0]
        if high_row_first:
            codes, dsq = codes.flip(0), dsq.flip(0)
            mask = None if mask is None else mask.flip(0)
        q_sum = torch.sum(queries, dim=-1)
        q_sq = torch.sum(queries * queries, dim=-1)
        qr = round_q(queries).to(acc)

        def score(start, size):
            ip = (qr @ codes[start:start + size].to(acc).T).float()
            return quantized._sq_epilogue(ip, q_sum, q_sq,
                                          dsq[start:start + size][None, :],
                                          a, s, metric)

        d, i = quantized._chunked_topk(score, n, b, k, 131072, mask,
                                       codes.device)
        if high_row_first:
            i = torch.where(i >= 0, n - 1 - i, i)
        return d, i

    return fn


def agreement(seed: int) -> None:
    """``--agreement``: the Q1/Q2 grid once for each Q2 of the module
    note."""
    import chip_smoke
    from weaviate_tpu_torch.ops import quantized

    bf16 = lambda q: q.to(torch.bfloat16).float()  # noqa: E731
    variants = {
        "kernel": quantized.sq_search_cuda,
        "fp64_sum": sq_variant(bf16, torch.float64),
        "q_6bit": sq_variant(lambda q: round_mantissa(q, 6)),
        "bf16_truncated": sq_variant(
            lambda q: (q.contiguous().view(torch.int32) & ~0xFFFF)
            .view(torch.float32)),
        "high_row_first": sq_variant(bf16, high_row_first=True),
    }
    kernel = quantized.sq_search_cuda
    floors = chip_smoke.MIN_ID_AGREEMENT, chip_smoke.MIN_ID_AGREEMENT_Q2_EDGES
    chip_smoke.MIN_ID_AGREEMENT = chip_smoke.MIN_ID_AGREEMENT_Q2_EDGES = 0.0
    try:
        for name, fn in variants.items():
            quantized.sq_search_cuda = fn
            try:
                out = chip_smoke.quant_kernel_grid(seed)
                row = {k: out[k] for k in (
                    "q2_id_agreement", "q2_edge_id_agreement",
                    "q2_max_abs_err", "q2_same", "q2_total", "q2_edge_same",
                    "q2_edge_total")}
            except AssertionError as e:
                row = {"refused_by_compare": str(e)}
            print(json.dumps({"q2": name, **row}), flush=True)
    finally:
        quantized.sq_search_cuda = kernel
        (chip_smoke.MIN_ID_AGREEMENT,
         chip_smoke.MIN_ID_AGREEMENT_Q2_EDGES) = floors


def bq_data(gen, dev):
    """Q1's operands: random packed rows, queries near the first rows."""
    w = D // 32
    packed = torch.randint(-2**31, 2**31 - 1, (BQ_ROWS, w),
                           dtype=torch.int32, device=dev, generator=gen)
    bits = torch.zeros(BQ_ROWS, dtype=torch.int64, device=dev)
    for i in range(32):
        bits += ((packed.long() >> i) & 1).sum(1)
    qp = packed[:B] ^ torch.randint(0, 1 << 20, (B, w), dtype=torch.int32,
                                    device=dev, generator=gen)
    mask = torch.rand(BQ_ROWS, generator=gen, device=dev) >= 0.01
    return {"q": qp, "packed": packed, "pop": bits.float(), "mask": mask}


def sq_data(gen, dev):
    """Q2's operands: random codes, cosine."""
    from weaviate_tpu_torch.ops.distance import normalize

    return {"codes": torch.randint(0, 256, (SQ_ROWS, D), dtype=torch.uint8,
                                   device=dev, generator=gen),
            "dsq": torch.rand(SQ_ROWS, device=dev, generator=gen),
            "q": normalize(torch.randn(B, D, device=dev, generator=gen)),
            "mask": torch.rand(SQ_ROWS, generator=gen, device=dev) >= 0.01}


def pq_data(gen, dev):
    """Q3's operands at config 3's shape: random codes into random bf16
    codebooks and the decoded rows' squared norms."""
    dsub = PQ_D // PQ_M
    codes = torch.randint(0, 256, (PQ_ROWS, PQ_M), dtype=torch.uint8,
                          device=dev, generator=gen)
    cb = torch.randn(PQ_M, 256, dsub, device=dev,
                     generator=gen).to(torch.bfloat16)
    norms = (cb.float() ** 2).sum(-1)  # [m, 256]
    seg = torch.arange(PQ_M, device=dev)
    dsq = torch.cat([norms[seg, codes[s:s + 100_000].long()].sum(1)
                     for s in range(0, PQ_ROWS, 100_000)])
    return {"codes": codes, "cb": cb, "dsq": dsq,
            "q": torch.randn(B, PQ_D, device=dev, generator=gen),
            "mask": torch.rand(PQ_ROWS, generator=gen, device=dev) >= 0.01}


def rq_data(gen, dev):
    """Q4's operands at the tenant's shape: random codes with each row's
    lower and step, cosine."""
    from weaviate_tpu_torch.ops.distance import normalize

    return {"codes": torch.randint(0, 256, (RQ_ROWS, D), dtype=torch.uint8,
                                   device=dev, generator=gen),
            "lower": -0.1 - 0.02 * torch.rand(RQ_ROWS, device=dev,
                                              generator=gen),
            "step": 0.2 / 255 + 0.0001 * torch.rand(RQ_ROWS, device=dev,
                                                    generator=gen),
            "dsq": torch.rand(RQ_ROWS, device=dev, generator=gen),
            "q": normalize(torch.randn(B, D, device=dev, generator=gen)),
            "mask": torch.rand(RQ_ROWS, generator=gen, device=dev) >= 0.01}


SCAN_DATA = {"bq": bq_data, "sq": sq_data, "pq": pq_data, "rq": rq_data}
FETCH = {"bq": BQ_FETCH, "sq": SQ_FETCH, "pq": PQ_FETCH, "rq": RQ_FETCH}


def scan_launch(kind: str, quantized, x: dict):
    """One scan launch of ``kind`` through the module ``quantized`` (its
    plan and wrapper) on the operands ``x``; returns a function that
    launches it and returns the lists it fills."""
    n = (x["packed"] if kind == "bq" else x["codes"]).shape[0]
    fetch = FETCH[kind]
    plan = quantized.device_plan(kind, B, n, fetch, x["q"].device)
    lists = quantized._lists(plan, B, x["q"].device)
    if kind == "bq":
        args = (x["q"], x["packed"], x["pop"], x["mask"], D, fetch)
        scan = quantized.bq_scan_cuda
    else:
        qb, q_sum, q_sq = quantized.sq_query_terms(x["q"])
        if kind == "sq":
            args = (qb, x["codes"], x["dsq"], x["mask"], q_sum, q_sq, 0.001,
                    0.01, "cosine", fetch)
            scan = quantized.sq_scan_cuda
        elif kind == "pq":
            args = (qb, x["codes"], x["cb"], x["dsq"], x["mask"], q_sq,
                    "l2-squared", fetch)
            scan = quantized.pq_scan_cuda
        else:
            args = (qb, x["codes"], x["lower"], x["step"], x["dsq"],
                    x["mask"], q_sum, q_sq, "cosine", fetch)
            scan = quantized.rq_scan_cuda

    def fn():
        scan(*args, plan, *lists)
        return lists

    return fn


def other_checkout(root: Path, lib: Path):
    """Another checkout's ``ops/quantized.py``, loaded beside this one's, on
    its own kernel library ``lib``."""
    import importlib.util

    from weaviate_tpu_torch.ops import quantized

    spec = importlib.util.spec_from_file_location(
        "quantized_against",
        root / "weaviate_tpu_torch" / "ops" / "quantized.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    cdll = mod.declare(ctypes.CDLL(str(lib)))
    mod._library = lambda: cdll
    mod._sm_count = quantized._sm_count
    return mod


def list_fill(lists, k: int) -> dict:
    """Entries taken in the first ``k`` of each list [splits, B, cap]: a
    split's mean and largest, a query's mean and largest over its splits,
    and whether every list holds its taken entries before its padding."""
    from weaviate_tpu_torch.ops import quantized

    taken = lists[0][..., :k] != quantized.NONE_KEY
    split = taken.sum(-1).float()
    query = split.sum(0)
    return {"split_mean": float(split.mean()), "split_max": int(split.max()),
            "query_mean": float(query.mean()), "query_max": int(query.max()),
            "slots_a_query": taken.shape[0] * k,
            "taken_then_padding": bool(
                (taken[..., :-1] | ~taken[..., 1:]).all())}


def back_to_back(fn, iters: int = 50) -> float:
    """Device ms a call of ``fn`` with ``iters`` calls between two events:
    the host's part of a call is hidden where the device is slower."""
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


def launch_only(lib, lists, k: int):
    """The merge's C entry point alone on preallocated outputs (no
    wrapper): what the kernel takes where the host keeps ahead."""
    splits, b, cap = lists[0].shape
    out_d = torch.empty((b, k), dtype=torch.float32, device="cuda")
    out_i = torch.empty((b, k), dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = (lists[0].data_ptr(), lists[1].data_ptr(), out_d.data_ptr(),
            out_i.data_ptr())
    return lambda: lib.topk_merge(*ptrs, splits, b, cap, k, stream)


def merge_probe(args, timed) -> None:
    """``--merge``: the merge alone on the lists of each scan, its copies,
    ``torch.topk``, and the other checkout's merge in turns."""
    from weaviate_tpu_torch.ops import quantized

    sources = {"as_is": SOURCE.read_text(),
               "merge_counters": edited(MERGE_COUNTERS)}
    sources.update({name: edited(edits)
                    for name, edits in MERGE_COPIES.items()})
    if args.against is not None:
        other_src = (args.against / "weaviate_tpu_torch" / "csrc"
                     / "quantized.cu")
        sources[AGAINST] = other_src.read_text()
        for name, edits in AGAINST_MERGE_COPIES.items():
            sources[f"{AGAINST}_{name}"] = edited(edits, other_src)
    libs = build(sources)
    other = (other_checkout(args.against, libs[AGAINST])
             if args.against is not None else None)
    if other is not None:
        for name in AGAINST_MERGE_COPIES:
            libs[f"{AGAINST}_{name}"] = other.declare(
                ctypes.CDLL(str(libs[f"{AGAINST}_{name}"])))
    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda").manual_seed(3)
    own = libs["as_is"]
    for kind in args.scans.split(","):
        k = FETCH[kind]
        quantized._library = lambda: own
        data = SCAN_DATA[kind](gen, dev)
        lists = [t.clone() for t in scan_launch(kind, quantized, data)()]
        del data
        torch.cuda.empty_cache()
        want = quantized.merge_partials_plain(*lists, k)
        got = quantized.merge_partials(*lists, k)
        if not all(map(torch.equal, got, want)):
            raise SystemExit(f"probe: the merge differs from its plain "
                             f"version at {kind}'s lists")
        run = lambda: quantized.merge_partials(*lists, k)  # noqa: E731
        row = {"merge": kind, "shape": list(lists[0].shape[:2]) + [k],
               "fill": list_fill(lists, k), "as_is_ms": timed(run),
               "back_to_back_ms": back_to_back(run),
               "launch_only_ms": back_to_back(launch_only(own, lists, k))}
        for name in MERGE_COPIES:
            quantized._library = lambda lib=libs[name]: lib
            row[f"{name}_ms"] = timed(run)
        # the counters copy: one launch, each part's cycles a CTA
        lib = libs["merge_counters"]
        lib.merge_counters.argtypes = [ctypes.c_void_p]
        cnt = (ctypes.c_ulonglong * 8)()
        quantized._library = lambda: lib
        torch.cuda.synchronize()
        lib.merge_counters(cnt)  # reset
        run()
        torch.cuda.synchronize()
        lib.merge_counters(cnt)
        ctas = max(1, cnt[7])
        row["cycles_a_cta"] = {part: cnt[i] / ctas
                               for i, part in enumerate(MERGE_PARTS)}
        row["passes_a_cta"] = cnt[6] / ctas
        quantized._library = lambda: own
        splits, b = lists[0].shape[:2]
        flat = lists[0][..., :k].permute(1, 0, 2).reshape(b, splits * k)
        signed = torch.bitwise_xor(flat, -(1 << 31))
        row["torch_topk_ms"] = timed(lambda: torch.topk(
            signed, k, dim=1, largest=False, sorted=True))
        if other is not None:
            theirs = lambda: other.merge_partials(*lists, k)  # noqa: E731
            if not all(map(torch.equal, theirs(), want)):
                raise SystemExit(f"probe: the other checkout's merge differs "
                                 f"from the plain version at {kind}'s lists")
            row["turns_ms"] = [("as_is", timed(run)),
                               (AGAINST, timed(theirs)),
                               (AGAINST, timed(theirs)),
                               ("as_is", timed(run))]
            row["against_launch_only_ms"] = back_to_back(launch_only(
                other._library(), lists, k))
            base_lib = other._library
            for name in AGAINST_MERGE_COPIES:
                other._library = lambda lib=libs[f"{AGAINST}_{name}"]: lib
                row[f"{AGAINST}_{name}_ms"] = timed(theirs)
            other._library = base_lib
        print(json.dumps(row), flush=True)
        del lists, flat, signed, want, got
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--agreement", action="store_true",
                    help="read Q2's id agreement, sound and faulty")
    ap.add_argument("--merge", action="store_true",
                    help="time the merge alone on the scans' lists")
    ap.add_argument("--seed", type=int, default=0,
                    help="chip_smoke.py's --seed, for --agreement")
    ap.add_argument("--scans", default="bq,sq,pq,rq",
                    help="the scans to time, of bq, sq, pq and rq")
    ap.add_argument("--copies", default="",
                    help="the copies to time (default: every one that "
                         "applies to a scan)")
    ap.add_argument("--against", type=Path, default=None,
                    help="another checkout whose scans are timed in turns "
                         "with this one's")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_quantized: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from weaviate_tpu_torch.ops import quantized

    if args.agreement:
        agreement(args.seed)
        print(chip_smoke.card(), flush=True)
        return 0
    if args.merge:
        merge_probe(args, lambda fn: float(np.median(
            chip_smoke.cuda_ms(fn, max(args.iters, 20), 3))))
        print(chip_smoke.card(), flush=True)
        return 0
    scans = args.scans.split(",")
    wanted = set(args.copies.split(",")) if args.copies else set(COPIES)
    names = sorted({n for kind in scans for n in APPLIES[kind]} & wanted
                   | {"as_is"})
    sources = {name: edited(COPIES[name]) for name in names}
    theirs = []  # the other checkout's copies: `code_scan_kernel`'s parts
    if args.against is not None:
        other_src = (args.against / "weaviate_tpu_torch" / "csrc"
                     / "quantized.cu")
        sources[AGAINST] = other_src.read_text()
        theirs = [n for n in names if n in CODE_SCAN_COPIES]
        for name in theirs:
            sources[f"{AGAINST}_{name}"] = edited(CODE_SCAN_COPIES[name],
                                                  other_src)
    libs = build(sources)
    other = (other_checkout(args.against, libs[AGAINST])
             if args.against is not None else None)
    for name in theirs:
        libs[f"{AGAINST}_{name}"] = other.declare(
            ctypes.CDLL(str(libs[f"{AGAINST}_{name}"])))
    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda").manual_seed(3)
    ms = {name: {} for name in names}

    def timed(fn):
        return float(np.median(chip_smoke.cuda_ms(fn, args.iters, 1)))

    for kind in scans:
        data = SCAN_DATA[kind](gen, dev)
        fn = scan_launch(kind, quantized, data)
        for name in APPLIES[kind]:
            if name in ms:
                quantized._library = lambda lib=libs[name]: lib
                ms[name][kind] = timed(fn)
        if "counters" in ms and kind in ms["counters"]:
            quantized._library = lambda lib=libs["counters"]: lib
            print(json.dumps({"scan": kind, "counters":
                              read_counters(fn())}), flush=True)
        quantized._library = lambda lib=libs["as_is"]: lib
        if kind == "bq" and "int8" in ms:
            # the int8 route is a kernel too: its partials equal the 1-bit
            # one's
            partials = {}
            for name in ("as_is", "int8"):
                quantized._library = lambda lib=libs[name]: lib
                partials[name] = [t[..., :BQ_FETCH].clone() for t in fn()]
            quantized._library = lambda lib=libs["as_is"]: lib
            if not all(map(torch.equal, partials["as_is"],
                           partials["int8"])):
                raise SystemExit("probe: the int8 copy's partials differ "
                                 "from the 1-bit product's")
        if other is not None:
            # in turns, this and the other checkout on the same operands;
            # their merged answers' id agreement beside the times
            fo = scan_launch(kind, other, data)
            this_ms = [timed(fn)]
            other_ms = [timed(fo), timed(fo)]
            this_ms.append(timed(fn))
            ids = quantized.merge_partials(*fn(), FETCH[kind])[1]
            other_ids = other.merge_partials(*fo(), FETCH[kind])[1]
            print(json.dumps({
                "scan": kind, "this_ms": this_ms, "against_ms": other_ms,
                "id_agreement": float((ids == other_ids).float().mean())}),
                flush=True)
            # the earlier template with a part switched off, same inputs
            copies, own = {}, other._library
            for name in theirs:
                if kind in CODE_SCAN_APPLIES[name]:
                    other._library = lambda lib=libs[f"{AGAINST}_{name}"]: lib
                    copies[name] = timed(fo)
            other._library = own
            if copies:
                print(json.dumps({"scan": kind, "against_copies_ms": copies}),
                      flush=True)
            del fo
        del fn, data
        torch.cuda.empty_cache()
    for name, times in ms.items():
        print(json.dumps({"copy": name, "scan_ms": times}), flush=True)
    print(chip_smoke.card(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
