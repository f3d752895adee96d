"""Drive the PyTorch/CUDA port's flat vector-search path on one card.

    python3 chip_smoke.py [--seed 0]

Phases, each printing one JSON line with its seconds; any failure exits
non-zero without the final line:

1. env     — card name and power limit, torch and CUDA versions, the time to
             build every kernel from ``weaviate_tpu_torch/csrc``.
2. kernels — each kernel against its plain PyTorch version on the card over
             a grid of shapes, masks and edge cases.
3. main    — ``FlatIndex`` at full width: 1,000,000 seeded 768-d vectors,
             1% deleted, 256 queries, k = 10 through the fused-kernel route;
             recall@10 against the exact float32 ground truth, launch counts,
             kernel / plain / search / exact-path times, device memory.
4. warm    — demote the index to host RAM, search there, promote, search
             again: the answers agree.

Then one ``{"kernels": [...]}`` line, the card's name and power limit, and
last ``{"ok": true, "device": {...}}``. Needs a CUDA card; exits non-zero
without one.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from weaviate_tpu_torch import _build
from weaviate_tpu_torch.index.flat import FlatIndex
from weaviate_tpu_torch.ops import fused_flat
from weaviate_tpu_torch.ops.distance import MASK_DISTANCE, flat_search
from weaviate_tpu_torch.schema.config import FlatIndexConfig

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, bf16 FLOP/s
HBM_BYTES_S = 3.35e12
BF16_FLOP_S = 989e12

# kernel vs plain: float32 sums of the same bf16 products in another order
ATOL, RTOL = 1e-2, 1e-4
MIN_ID_AGREEMENT = 0.999

ROWS, DIMS, BATCH, K = 1_000_000, 768, 256, 10
# the kernel variant the main path's shapes take
MAIN_VARIANT = "cluster"
INGEST_BATCH = 65536


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
    logs = _build.build(fused_flat.KERNEL)
    build_s = time.perf_counter() - t0
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "error" in line or "spill" in line:
                print(f"[nvcc {name}] {line.strip()}", file=sys.stderr)
    return {"card": card(), "torch": torch.__version__,
            "cuda": torch.version.cuda, "build_s": build_s}


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
            "tolerance": {"atol": ATOL, "rtol": RTOL}}


def recall(ids: np.ndarray, gt: np.ndarray) -> float:
    k = gt.shape[1]
    return float(np.mean([len(set(ids[r]) & set(gt[r])) / k
                          for r in range(len(gt))]))


def phase_main(seed: int, state: dict) -> dict:
    torch.cuda.reset_peak_memory_stats()
    idx = FlatIndex(DIMS, FlatIndexConfig(
        distance="l2-squared", precision="bf16", flat_approx_recall=0.99))
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    head = None
    for s in range(0, ROWS, INGEST_BATCH):
        n = min(INGEST_BATCH, ROWS - s)
        vecs = rng.standard_normal((n, DIMS), dtype=np.float32)
        if head is None:
            head = vecs[:BATCH].copy()
        idx.add_batch(np.arange(s, s + n), vecs)
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
    state.update(idx=idx, exact32=exact32, queries=queries, res=res)
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
    )
    for name, fn in phases:
        t0 = time.perf_counter()
        out = fn()
        if name == "env":
            state["card"] = out["card"]
        emit({"phase": name, "seconds": time.perf_counter() - t0, **out})
    emit({"kernels": [state["kernel"]]})
    print(card(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
