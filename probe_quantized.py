"""Where the quantized scans' (Q1, Q2) time goes, and how often a sound
or a faulty Q2 gives the plain version's ids, on one card.

    python3 probe_quantized.py [--iters 5]
    python3 probe_quantized.py --agreement

At phase ``quant``'s shapes (B = 256; Q1 over 10,002,432 x 768 bits with
fetch 320, Q2 over 552,960 x 768 codes with fetch 200, cosine) on seeded
random codes made on the card (Q1's queries are rows with 20 low bits of
each word flipped; 1% of the rows masked), it times one scan launch
(``bq_scan_cuda`` / ``sq_scan_cuda`` into the search's own lists, CUDA
events, the median of ``--iters``) for copies of
``weaviate_tpu_torch/csrc/quantized.cu``, each with one part switched off:

- ``as_is``: the source as it is;
- ``no_select``: no epilogue selection (no tile's candidates enter a
  list; the lists are only padded at the end of a split);
- ``no_mma``: the tensor-core products replaced by one integer (Q1) or
  float (Q2) add a fragment;
- ``no_epilogue`` (Q2): no keys and no selection at a tile's end;
- ``no_widen`` (Q2): the codes not widened to bf16 (the products read
  stale tiles);
- ``no_loads`` (Q2): no ring loads after the first steps;
- ``int8`` (Q1): Q1's other exact product route, an int8 ``mma.m16n8k32``
  on the bits widened to {0,1} bytes in registers, in place of the 1-bit
  ``mma`` (the one copy that is a kernel too: it gives Q1's answers).

The other copies give wrong answers by design. The
copies are made by replacing exact text of the source; when the source no
longer holds it, the probe stops and names it
(``tests/test_torch_quantized.py`` applies the edits on the CPU). Builds go
to ``weaviate_tpu_torch/_build/probe_q/``. Prints one JSON line per copy.

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

COPIES = {
    "as_is": [],
    "no_select": [
        ("      select_tile<kBqR, HammingKeys>(",
         "      if (false) select_tile<kBqR, HammingKeys>("),
        ("    select_tile<kSqR, OrderKeys>(",
         "    if (false) select_tile<kSqR, OrderKeys>("),
    ],
    "no_mma": [
        ('      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "\n'
         '      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\\n"',
         '      "add.s32 %0, %0, %8; add.s32 %1, %1, %9; '
         'add.s32 %2, %2, %4; add.s32 %3, %3, %5;"'),
        ('      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "\n'
         '      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\\n"',
         '      "add.f32 %0, %0, 0f3F800000; add.f32 %1, %1, 0f3F800000; '
         'add.f32 %2, %2, 0f3F800000; add.f32 %3, %3, 0f3F800000;"'),
    ],
    "no_epilogue": [
        ("    if (kc != chunks - 1) continue;\n", "    continue;\n"),
    ],
    "no_widen": [
        ("    if (step + 1 < steps) widen_step(step + 1);\n", ""),
    ],
    "no_loads": [
        ("    if (step + kSqStages - 1 < steps) "
         "load_step(step + kSqStages - 1);\n", ""),
    ],
}
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
# the copies that touch only Q2's kernel, and only Q1's
SQ_ONLY = ("no_epilogue", "no_widen", "no_loads")
BQ_ONLY = ("int8",)


def edited(edits) -> str:
    src = SOURCE.read_text()
    for old, new in edits:
        if old not in src:
            raise SystemExit(f"probe: the source no longer holds {old!r}")
        src = src.replace(old, new)
    return src


def build(names) -> dict[str, ctypes.CDLL]:
    """Each copy compiled with the port's flags, one nvcc each, together."""
    from weaviate_tpu_torch import _build
    from weaviate_tpu_torch.ops import quantized

    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        src = OUT / f"{name}.cu"
        src.write_text(edited(COPIES[name]))
        lib = OUT / f"lib{name}.so"
        procs[name] = (subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"probe: nvcc failed for {name}:\n{log}")
        libs[name] = quantized.declare(ctypes.CDLL(str(lib)))
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--agreement", action="store_true",
                    help="read Q2's id agreement, sound and faulty")
    ap.add_argument("--seed", type=int, default=0,
                    help="chip_smoke.py's --seed, for --agreement")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_quantized: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from weaviate_tpu_torch.ops import quantized
    from weaviate_tpu_torch.ops.distance import normalize

    if args.agreement:
        agreement(args.seed)
        print(chip_smoke.card(), flush=True)
        return 0
    libs = build(COPIES)
    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda").manual_seed(3)
    ms = {name: {} for name in COPIES}

    def time_copies(tag, fn, names):
        for name in names:
            quantized._library = lambda lib=libs[name]: lib
            ms[name][tag] = float(np.median(chip_smoke.cuda_ms(
                fn, args.iters, 1)))

    w = D // 32
    packed = torch.randint(-2**31, 2**31 - 1, (BQ_ROWS, w),
                           dtype=torch.int32, device=dev, generator=gen)
    bits = torch.zeros(BQ_ROWS, dtype=torch.int64, device=dev)
    for i in range(32):
        bits += ((packed.long() >> i) & 1).sum(1)
    pop = bits.float()
    del bits
    qp = packed[:B] ^ torch.randint(0, 1 << 20, (B, w), dtype=torch.int32,
                                    device=dev, generator=gen)
    mask = torch.rand(BQ_ROWS, generator=gen, device=dev) >= 0.01
    plan = quantized.device_plan("bq", B, BQ_ROWS, BQ_FETCH, dev)
    lists = quantized._lists(plan, B, dev)
    time_copies("bq", lambda: quantized.bq_scan_cuda(
        qp, packed, pop, mask, D, BQ_FETCH, plan, *lists),
        [n for n in COPIES if n not in SQ_ONLY])
    # the int8 route is a kernel too: its partials equal the 1-bit one's
    partials = {}
    for name in ("as_is", "int8"):
        quantized._library = lambda lib=libs[name]: lib
        quantized.bq_scan_cuda(qp, packed, pop, mask, D, BQ_FETCH, plan,
                               *lists)
        partials[name] = [t[..., :BQ_FETCH].clone() for t in lists]
    if not all(map(torch.equal, partials["as_is"], partials["int8"])):
        raise SystemExit("probe: the int8 copy's partials differ from the "
                         "1-bit product's")
    del packed, pop, qp, mask, lists, partials
    torch.cuda.empty_cache()
    codes = torch.randint(0, 256, (SQ_ROWS, D), dtype=torch.uint8,
                          device=dev, generator=gen)
    dsq = torch.rand(SQ_ROWS, device=dev, generator=gen)
    q = normalize(torch.randn(B, D, device=dev, generator=gen))
    mask = torch.rand(SQ_ROWS, generator=gen, device=dev) >= 0.01
    qb, q_sum, q_sq = quantized.sq_query_terms(q)
    plan = quantized.device_plan("sq", B, SQ_ROWS, SQ_FETCH, dev)
    lists = quantized._lists(plan, B, dev)
    time_copies("sq", lambda: quantized.sq_scan_cuda(
        qb, codes, dsq, mask, q_sum, q_sq, 0.001, 0.01, "cosine", SQ_FETCH,
        plan, *lists), [n for n in COPIES if n not in BQ_ONLY])
    for name, times in ms.items():
        print(json.dumps({"copy": name, "scan_ms": times}), flush=True)
    print(chip_smoke.card(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
