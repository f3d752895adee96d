"""Where B7a's and B7b's time goes, and the multi-target walks', on one
card.

    python3 probe_rerank.py [--iters 50] [--parts b7a,b7b,walks]
                            [--against DIR]

B7a (``rerank_topk_cuda``, ``csrc/rerank.cu``) at the two shapes of
``chip_smoke.py``'s phase ``rerank``: the multivector path (B 1, C 64, T
256, D 128, Tq 32; documents of 40-180 kept tokens) and the HNSW rerank
tier (B 64, C 32, T 4, Tq 4); B7b (``mt_join_topk_cuda``, ``mt_join_kernel``
of ``csrc/device_beam.cu``) at the multi-target path's (B 1, two targets
of 768 and 256 dims, fetch 64). Their inputs are captured as
``chip_smoke.py`` captures them: the user's entry point driven on a
smaller corpus of the same widths (MV_DOCS documents, HNSW_ROWS rows,
MT_ROWS objects), the kernel wrapper's arguments taken from its last call.
For each shape it prints:

- ``device_ms``: the device time a call, with the stream held by a spin
  kernel while ``--iters`` calls are enqueued, so the host's part is not
  in it (``held`` says the enqueue ended before the spin did);
- ``host_ms``: the host time a call takes to enqueue (the wrapper's
  Python, its allocations and the C entry point);
- ``back_to_back_ms``: CUDA events around calls back to back, what a
  caller sees (the larger of the two above);
- the same ``device_ms`` for copies of the source with one part switched
  off (``COPIES``; another checkout's ``AGAINST_COPIES``): the scoring,
  and the last step's rank (B7a) or join and rank (B7b), B7a's products,
  fold and token copies, B7b's rank and dedup;
- ``steps_ns``: one call of the ``stamps`` copy, which reads the global
  timer at each step of the launch's first CTA (and of B7a's last CTA of
  query 0), each step's ns after the one before.

The launch floor: an empty kernel launched through the same ctypes path
(alone, and in clusters of 8 set at launch or compiled in), and the
wrapper's own pieces alone (``torch.cuda.current_stream``, the
raw stream handle of ``ops/launch.py``, one ``torch.empty``), each by host
time.

``--parts walks``: the two B = 1 B2 launches of a multi-target search
(``fused_search_cuda``, one a target), each split into device time, host
part and back to back as above, with the walk's hops (the kernel's
layer-0 expansions, ``stats``) and its ``max_steps``.

``--against DIR`` times another checkout's wrappers and kernels (its
``ops/rerank.py``, ``ops/device_beam.py``, ``csrc/rerank.cu`` and
``csrc/device_beam.cu``, built beside this one's) in turns with this
one's on the same inputs (this, other, this), and checks that their ids
are equal and their distances within the grids' tolerances. Unpack the
parent with ``git archive HEAD | tar -x -C _chipcheck/parent``. Builds go
to ``weaviate_tpu_torch/_build/probe_r/``. Prints one JSON line per
measurement, and the card's name and power limit last.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

import probe_common as common
from probe_common import Capture, build, host_ms, queued, stream

ROOT = Path(__file__).resolve().parent
CSRC = ROOT / "weaviate_tpu_torch" / "csrc"
SOURCES = {"rerank": CSRC / "rerank.cu",
           "device_beam": CSRC / "device_beam.cu"}
OUT = ROOT / "weaviate_tpu_torch" / "_build" / "probe_r"
AGAINST = "against"
# the captured paths' corpora: the phase's widths at a smaller depth
MV_DOCS, MV_DIMS, MV_TQ, MV_TOKENS = 4096, 128, 32, (40, 180)
HNSW_ROWS, HNSW_TOKENS, HNSW_BATCH = 32_768, 4, 64
MT_ROWS, MT_DIMS = 32_768, {"a": 768, "b": 256}
MT_SEARCHES = 8

# the probe's own entry points, appended to every copy: those of
# probe_common.py and an empty kernel in clusters of 8
APPENDED = common.APPENDED + r"""
// an empty kernel in clusters of 8: launched with the cluster a launch
// attribute (cudaLaunchKernelEx), or compiled into the kernel
__global__ void probe_empty_ex_kernel() {}
__global__ void __cluster_dims__(8, 1, 1) probe_empty_dims_kernel() {}
extern "C" int probe_empty_cluster_ex(void* stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(8, 1, 1);
  cfg.blockDim = dim3(32, 1, 1);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 8;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, probe_empty_ex_kernel);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}
extern "C" int probe_empty_cluster_dims(void* stream) {
  probe_empty_dims_kernel<<<8, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
"""

# copies of each source with one part switched off
COPIES = {
    "rerank": {
        # no tile of products: every maximum stays -inf, every score 0
        "no_score": [
            ("        tile<RG>(p, s, r0, col0, min(kCols, n_list - col0));",
             "        ;")],
        # the last CTA of a query writes nothing: no rank
        "no_rank": [
            ("  if (!s_last) return;", "  if (!s_last || p.c > 0) return;")],
        # the tiles staged and folded, but no product taken
        "no_fma": [
            ("  for (int kk = k0; kk < k0 + SLICE; kk += 4) {",
             "  for (int kk = k0; kk < k0; kk += 4) {")],
        # the products taken, no maximum folded
        "no_fold": [
            ("  for (int e = threadIdx.x; e < nrow << lgw; e += kThreads) {",
             "  for (int e = threadIdx.x; e < 0; e += kThreads) {")],
        # no candidate token copied (16-byte path): the tile reads what the
        # shared memory holds
        "no_loads": [
            ("      else\n        cp_async16(dst, src + k);",
             "      else if (r < kRows)\n        cp_async16(dst, src + k);")],
    },
    "device_beam": {
        # no (member, target) pair is scored
        "no_score": [
            ("    for (int e0 = 0; e0 < pairs; e0 += groups) {",
             "    for (int e0 = 0; e0 < 0; e0 += groups) {")],
        # nothing after the scores: no join, no rank, no output
        "no_join": [
            ("  mt_cluster_sync();\n  if (rank != 0) return;",
             "  mt_cluster_sync();\n  if (rank != 0 || p.fetch > 0) return;")],
        # the join but no rank: nothing written but the padding
        "no_rank": [
            ("  for (int e0 = 0; e0 < vn * g; e0 += nt) {",
             "  for (int e0 = 0; e0 < 0; e0 += nt) {")],
        # every live slot a member: no dedup (the same id scored twice)
        "no_dedup": [
            ("    for (int j = 0; j < u; ++j) dup |= ids[j] == id;",
             "    for (int j = 0; j < 0; ++j) dup |= ids[j] == id;")],
    },
}
# a copy that stamps the global timer (ns) at its steps, read back by
# ``probe_stamps``: CTA 0 (a cluster's first CTA) through the launch, and
# for B7a the last CTA of query 0 through its rank
STAMPS_DECL = r"""namespace cg = cooperative_groups;
__device__ long long g_stamps[16];
__device__ __forceinline__ long long probe_now() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
extern "C" int probe_stamps(long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, g_stamps,
                                               sizeof(g_stamps)));
}
"""


def _stamp(k: int, cond: str) -> str:
    return f"  if ({cond}) g_stamps[{k}] = probe_now();\n"


_A0 = "threadIdx.x == 0 && blockIdx.x == 0 && blockIdx.y == 0"
_ALAST = "threadIdx.x == 0 && s.qi == 0"
_B0 = "threadIdx.x == 0 && blockIdx.x == 0"
COPIES["rerank"]["stamps"] = [
    ("namespace cg = cooperative_groups;\n", STAMPS_DECL),
    ("  s.ncand = min(p.cpb, p.c - s.c0);\n",
     "  s.ncand = min(p.cpb, p.c - s.c0);\n" + _stamp(0, _A0)),
    ("  __syncthreads();\n  s.nq = s_n;\n",
     "  __syncthreads();\n" + _stamp(1, _A0) + "  s.nq = s_n;\n"),
    ("    khi = (int)((long long)total_kept * (s.blk + 1) / p.nblk);\n  }\n"
     "  __syncthreads();\n",
     "    khi = (int)((long long)total_kept * (s.blk + 1) / p.nblk);\n  }\n"
     "  __syncthreads();\n" + _stamp(2, _A0)),
    ("  if (p.nblk > 1 && tid == 0) kept[0] = total_kept;\n",
     _stamp(3, _A0) + "  if (p.nblk > 1 && tid == 0) kept[0] = total_kept;\n"),
    ("  if (p.nblk > 1) cluster_sync();\n  const bool first",
     "  if (p.nblk > 1) cluster_sync();\n" + _stamp(4, _A0)
     + "  const bool first"),
    ("  if (p.nblk > 1) cluster_sync();  // the others' memory stays until "
     "read\n",
     "  if (p.nblk > 1) cluster_sync();  // the others' memory stays until "
     "read\n" + _stamp(5, _A0)),
    ("  if (!s_last) return;\n  __threadfence();\n",
     "  if (!s_last) return;\n  __threadfence();\n" + _stamp(6, _ALAST)),
    ("      p.out_d[(size_t)s.qi * p.out_k + rank] = ok ? -v : kMask;\n"
     "    }\n  }\n}\n",
     "      p.out_d[(size_t)s.qi * p.out_k + rank] = ok ? -v : kMask;\n"
     "    }\n  }\n  __syncthreads();\n" + _stamp(7, _ALAST) + "}\n"),
]
COPIES["device_beam"]["stamps"] = [
    ("namespace cg = cooperative_groups;\n", STAMPS_DECL),
    ("  const int qi = blockIdx.x / R, rank = blockIdx.x - qi * R;\n",
     "  const int qi = blockIdx.x / R, rank = blockIdx.x - qi * R;\n"
     + _stamp(0, _B0)),
    ("    if (lane == 0) s_red[warp][i] = v;\n  }\n  __syncthreads();\n",
     "    if (lane == 0) s_red[warp][i] = v;\n  }\n  __syncthreads();\n"
     + _stamp(1, _B0)),
    ("    valid[u] = !dup;\n  }\n  __syncthreads();\n",
     "    valid[u] = !dup;\n  }\n  __syncthreads();\n" + _stamp(2, _B0)),
    ("  const int vn = s_valid_n;\n",
     "  const int vn = s_valid_n;\n" + _stamp(3, _B0)),
    ("  // every CTA's table slices are built before any lookup\n"
     "  mt_cluster_sync();\n",
     "  // every CTA's table slices are built before any lookup\n"
     "  mt_cluster_sync();\n" + _stamp(4, _B0)),
    ("  // the distances in the first CTA; the others' tables read to the "
     "end\n  mt_cluster_sync();\n",
     _stamp(5, _B0) + "  // the distances in the first CTA; the others' "
     "tables read to the end\n  mt_cluster_sync();\n" + _stamp(6, _B0)),
    ("    comb[v] = c;\n  }\n  __syncthreads();\n",
     "    comb[v] = c;\n  }\n  __syncthreads();\n" + _stamp(7, _B0)),
    ("    oid[r] = -1;\n    od[r] = kMask;\n  }\n}\n",
     "    oid[r] = -1;\n    od[r] = kMask;\n  }\n  __syncthreads();\n"
     + _stamp(8, _B0) + "}\n"),
]
# what each stamp follows
STAMP_NAMES = {
    "rerank": ["start", "candidates_and_query_tokens", "kept_count",
               "windows_and_tiles", "cluster_barrier", "combine_and_score",
               "last_cta_after_ticket", "rank"],
    "device_beam": ["start", "union_presence_queries", "dedup",
                    "members", "cluster_barrier", "scoring",
                    "distances_barrier", "join", "rank"],
}

# the same parts of the kernels before their redesign (commit b6a40c8: a
# warp a candidate, a CTA a query's join), for --against
AGAINST_COPIES = {
    "rerank": {
        "no_score": [
            ("      s = score_candidate(p, qi, id, qs, qmean, stage, csum);",
             "      s = static_cast<float>(ci);")],
        "no_rank": [
            ("  if (!s_last) return;", "  if (!s_last || p.c > 0) return;")],
    },
    "device_beam": {
        "no_score": [
            ("  for (int e = warp; e < T * U; e += nw) {",
             "  for (int e = warp; e < 0; e += nw) {")],
        "no_join": [
            ("    if (lane == 0) dist[t * U + u] = mt_finish(g, acc, s_qa[t], "
             "s_qb[t], ids[u]);\n  }\n  __syncthreads();\n",
             "    if (lane == 0) dist[t * U + u] = mt_finish(g, acc, s_qa[t], "
             "s_qb[t], ids[u]);\n  }\n  __syncthreads();\n"
             "  if (p.fetch > 0) return;\n")],
    },
}


def copies_of(kernel: str, text: str) -> dict:
    """The copies of ``kernel``'s source that apply to ``text``: this
    version's (COPIES), else the other's (AGAINST_COPIES)."""
    return common.copies_of((COPIES.get(kernel), AGAINST_COPIES.get(kernel)),
                            text, APPENDED, f"{kernel}.cu")


def load(mod, path: Path) -> ctypes.CDLL:
    return common.load(mod, path,
                       probe_empty_cluster_ex=[ctypes.c_void_p],
                       probe_empty_cluster_dims=[ctypes.c_void_p])


def other_checkout(root: Path) -> dict:
    """Another checkout's ``ops/rerank.py`` and ``ops/device_beam.py``,
    loaded beside this one's (their ``_library`` set by the caller)."""
    mods = {}
    for name in ("rerank", "device_beam"):
        mods[name] = common.load_module(
            root / "weaviate_tpu_torch" / "ops" / f"{name}.py",
            f"{name}_against")
    # the captured calls hold this checkout's scorers: the other module
    # takes them as its own
    from weaviate_tpu_torch.ops import device_beam

    theirs = mods["device_beam"]
    kinds = {cls.__name__: v for cls, v in theirs._ROW_KINDS.items()}
    for name in kinds:
        setattr(theirs, name, getattr(device_beam, name))
    theirs._ROW_KINDS = {getattr(device_beam, n): v for n, v in kinds.items()}
    return mods


def floor(lib, iters: int) -> dict:
    """The launch floor through ctypes (an empty kernel) and the wrappers'
    common pieces alone, by host time."""
    from weaviate_tpu_torch.ops.launch import raw_stream

    return {"empty": queued(lib, lambda: lib.probe_empty(stream()), iters),
            "empty_cluster_ex": queued(
                lib, lambda: lib.probe_empty_cluster_ex(stream()), iters),
            "empty_cluster_dims": queued(
                lib, lambda: lib.probe_empty_cluster_dims(stream()), iters),
            "current_stream_host_ms": host_ms(
                lambda: torch.cuda.current_stream().cuda_stream, 200),
            "raw_stream_host_ms": host_ms(lambda: raw_stream(0), 200),
            "torch_empty_host_ms": host_ms(
                lambda: torch.empty(64, dtype=torch.int32, device="cuda"),
                200)}


# ---------------------------------------------------------------------------
# the captured inputs
# ---------------------------------------------------------------------------


def unit(x: np.ndarray) -> np.ndarray:
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def multivector_inputs(seed: int) -> tuple:
    """B7a's arguments on the multivector path: MV_DOCS documents of 40-180
    unit 128-d tokens in a ``DB`` collection at MUVERA's defaults, one
    search of MV_TQ tokens jittered from a document's."""
    import chip_smoke as cs
    from weaviate_tpu_torch.ops import rerank

    rng = np.random.default_rng(seed + 41)
    lens = rng.integers(MV_TOKENS[0], MV_TOKENS[1] + 1, MV_DOCS)
    docs = [unit(rng.standard_normal((n, MV_DIMS))) for n in lens]
    root = tempfile.mkdtemp(prefix="probe_rerank_mv_")
    try:
        db = cs.DB(root)
        col = db.create_collection(cs.CollectionConfig(
            name="Colbert", properties=[cs.Property("bucket",
                                                    cs.DataType.INT)],
            vector_config=cs.MultiVectorIndexConfig(
                ksim=4, dproj=16, repetitions=10, rescore_limit=0,
                initial_capacity=MV_DOCS)))
        uuids = cs._uuids(rng, MV_DOCS)
        for s in range(0, MV_DOCS, 1024):
            col.put_batch([cs.StorageObject(
                uuid=uuids[i], collection="Colbert", vector=docs[i],
                properties={"bucket": i % 100})
                for i in range(s, min(MV_DOCS, s + 1024))])
        d0 = docs[int(rng.integers(MV_DOCS))]
        q = d0[rng.choice(len(d0), MV_TQ, replace=False)] \
            + 0.5 / MV_DIMS ** 0.5 * rng.standard_normal((MV_TQ, MV_DIMS))
        with Capture(rerank, "rerank_topk_cuda") as cap:
            col.vector_search(unit(q), cs.K)
        a, _ = cap.calls[-1]
        out = tuple(x.clone() if torch.is_tensor(x) else x for x in a)
        db.close()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


def hnsw_tier_inputs(seed: int) -> tuple:
    """B7a's arguments on the HNSW rerank tier: bench_rerank's rows at
    HNSW_ROWS, 4 tokens a row, a batch of HNSW_BATCH searches reranked by
    one query's 4 tokens."""
    import chip_smoke as cs
    from weaviate_tpu_torch.ops import rerank

    rng = np.random.default_rng(seed + 13)
    n, d = HNSW_ROWS, MV_DIMS
    centres = rng.standard_normal((max(8, n // 2000), d)).astype(np.float32)
    corpus = (centres[rng.integers(0, len(centres), n)]
              + 0.3 * rng.standard_normal((n, d))).astype(np.float32)
    tok = (corpus[:, None, :] + 0.15 * rng.standard_normal(
        (n, HNSW_TOKENS, d))).astype(np.float32)
    q_tokens = (tok[0] + 0.05 * rng.standard_normal(
        (HNSW_TOKENS, d))).astype(np.float32)
    idx = cs.HNSWIndex(d, cs.HNSWIndexConfig(
        distance="l2-squared", ef_construction=96, max_connections=16, ef=96,
        device_beam=True, flat_search_cutoff=0, insert_batch=4096,
        initial_capacity=n,
        rerank=cs.RerankModuleConfig(module="rerank-maxsim",
                                     max_tokens=HNSW_TOKENS)))
    idx.add_batch(np.arange(n, dtype=np.int64), corpus)
    idx.set_tokens(np.arange(n, dtype=np.int64), tok)
    bq = np.repeat(q_tokens.mean(0, keepdims=True), HNSW_BATCH, axis=0)
    with Capture(rerank, "rerank_topk_cuda") as cap:
        idx.search(bq, cs.K, rerank=cs.RerankRequest(cs.MaxSimRerank(),
                                                     q_tokens))
    a, _ = cap.calls[-1]
    return tuple(x.clone() if torch.is_tensor(x) else x for x in a)


def multitarget_inputs(seed: int) -> tuple:
    """B7b's arguments and the two walks' of a multi-target search:
    bench_multitarget's 2t corpus at MT_ROWS objects, MT_SEARCHES searches
    under ``sum``; the last search's calls."""
    import chip_smoke as cs
    from weaviate_tpu_torch.ops import device_beam

    rng = np.random.default_rng(seed + 29)
    vecs = {t: rng.standard_normal((MT_ROWS, dd)).astype(np.float32)
            for t, dd in MT_DIMS.items()}
    root = tempfile.mkdtemp(prefix="probe_rerank_mt_")
    try:
        db = cs.DB(root)
        hnsw = dict(distance="l2-squared", ef=64, ef_construction=64)
        col = db.create_collection(cs.CollectionConfig(
            name="Multi2t", vector_config=cs.HNSWIndexConfig(**hnsw),
            named_vectors={t: cs.HNSWIndexConfig(**hnsw, device_beam=True,
                                                 initial_capacity=MT_ROWS)
                           for t in MT_DIMS}))
        for lo in range(0, MT_ROWS, 4096):
            col.put_batch([cs.StorageObject(
                uuid=f"{i:08x}-0000-0000-0000-000000000000",
                collection="Multi2t",
                named_vectors={t: vecs[t][i] for t in MT_DIMS})
                for i in range(lo, min(MT_ROWS, lo + 4096))])
        rows = rng.choice(MT_ROWS, MT_SEARCHES, replace=False)
        with Capture(device_beam, "mt_join_topk_cuda") as join, \
                Capture(device_beam, "fused_search_cuda") as walks:
            for r in rows:
                q = {t: vecs[t][r] + 0.05 * rng.standard_normal(
                    dd).astype(np.float32) for t, dd in MT_DIMS.items()}
                col.multi_target_search(q, k=cs.K, combination="sum")
        a, _ = join.calls[-1]
        w = walks.calls[-len(MT_DIMS):]
        torch.cuda.synchronize()
        db.close()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return a, w


# ---------------------------------------------------------------------------
# the probes
# ---------------------------------------------------------------------------


def turns(kernel: str, mods: dict, call, iters: int, same) -> dict:
    """``call(mod)`` timed for this checkout's wrapper and copies, then the
    other's (its copies too), then this one again; ``same(a, b)`` compares
    two outputs."""
    line = {}
    outs = {}
    order = ["this"] + ([AGAINST, "this"] if AGAINST in mods else [])
    for i, who in enumerate(order):
        mod, libs = mods[who][kernel]
        mod._library = lambda lib=libs["as_is"]: lib
        outs.setdefault(who, [t.clone() for t in call(mod)])
        key = who if i < 2 else "this_again"
        line[key] = queued(libs["as_is"], lambda: call(mod), iters)
        if i < 2:
            for copy, lib in libs.items():
                if copy == "as_is":
                    continue
                mod._library = lambda lib=lib: lib
                line[key][copy] = queued(lib, lambda: call(mod),
                                         iters)["device_ms"]
                if copy == "stamps":
                    line[key]["steps_ns"] = stamps(lib, kernel,
                                                   lambda: call(mod))
            mod._library = lambda lib=libs["as_is"]: lib
    if AGAINST in outs:
        line["same_as_against"] = same(outs["this"], outs[AGAINST])
    return line


def stamps(lib, kernel: str, fn) -> dict:
    """One call of the ``stamps`` copy: each step's ns after the one
    before it (STAMP_NAMES)."""
    buf = (ctypes.c_longlong * 16)()
    fn()
    torch.cuda.synchronize()
    lib.probe_stamps.argtypes = [ctypes.c_void_p]
    err = lib.probe_stamps(ctypes.addressof(buf))
    if err:
        raise SystemExit(f"probe: probe_stamps failed ({err})")
    names = STAMP_NAMES[kernel]
    return {names[k]: buf[k] - buf[k - 1] for k in range(1, len(names))}


def same_b7a(a, b) -> dict:
    ids_equal = bool(torch.equal(a[0], b[0]))
    err = float((a[1] - b[1]).abs().max())
    return {"ids_equal": ids_equal, "max_abs_diff": err}


def b7a_probe(args, mods) -> None:
    shapes = (("multivector", multivector_inputs(args.seed)),
              ("hnsw_tier", hnsw_tier_inputs(args.seed)))
    for name, a in shapes:
        cand, tokens, tmask, q, qm, module, out_k = a
        rows = cand.clamp(min=0).long()
        kept = tmask[rows].sum(-1)
        line = {"b7a": name, "b": int(cand.shape[0]),
                "c": int(cand.shape[1]), "t": int(tokens.shape[1]),
                "d": int(tokens.shape[2]), "tq": int(q.shape[1]),
                "out_k": out_k, "kept_tokens": [int(kept.min()),
                                                int(kept.max())]}
        line.update(turns("rerank", mods, lambda mod: mod.rerank_topk_cuda(
            *a[:6], out_k), args.iters, same_b7a))
        print(json.dumps(line), flush=True)


def b7b_probe(args, mods, mt) -> None:
    a, _ = mt
    fetch, join = a[6], a[7]
    line = {"b7b": "multitarget_2t", "b": int(a[4][0].shape[0]),
            "targets": len(a[0]), "fetch": fetch, "join": join}
    line.update(turns("device_beam", mods,
                      lambda mod: mod.mt_join_topk_cuda(*a), args.iters,
                      same_b7a))
    print(json.dumps(line), flush=True)


def walks_probe(args, mods, mt) -> None:
    """Each target's walk of the last search: device time, host part, back
    to back and its hops."""
    from weaviate_tpu_torch.ops import device_beam

    _, walks = mt
    mod, libs = mods["this"]["device_beam"]
    mod._library = lambda: libs["as_is"]
    for t, (a, kw) in zip(MT_DIMS, walks):
        stats = torch.zeros((a[1].shape[0], len(device_beam.STATS)),
                            dtype=torch.int32, device="cuda")
        mod.fused_search_cuda(*a, **{**kw, "stats": stats})
        torch.cuda.synchronize()
        st = dict(zip(device_beam.STATS, stats[0].tolist()))
        t_ = queued(libs["as_is"], lambda: mod.fused_search_cuda(*a, **kw),
                    args.iters)
        hops = max(1, st["expansions"])
        print(json.dumps({
            "walk": t, "dims": MT_DIMS[t], "b": int(a[1].shape[0]),
            "ef": kw.get("ef", a[8] if len(a) > 8 else None),
            "max_steps": kw.get("max_steps", a[9] if len(a) > 9 else None),
            "stats": st, **t_,
            "device_us_a_hop": t_["device_ms"] * 1e3 / hops}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--parts", default="b7a,b7b,walks")
    ap.add_argument("--against", type=Path, default=None,
                    help="another checkout whose B7a and B7b are timed in "
                         "turns with this one's")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_rerank: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from weaviate_tpu_torch.ops import device_beam, rerank

    parts = args.parts.split(",")
    sources = {}
    for kernel, path in SOURCES.items():
        text = path.read_text()
        sources[f"{kernel}__as_is"] = text + APPENDED
        sources.update({f"{kernel}__{n}": t
                        for n, t in copies_of(kernel, text).items()})
        if args.against is not None:
            other = (args.against / "weaviate_tpu_torch" / "csrc"
                     / path.name).read_text()
            sources[f"{AGAINST}_{kernel}__as_is"] = other + APPENDED
            sources.update({f"{AGAINST}_{kernel}__{n}": t
                            for n, t in copies_of(kernel, other).items()})
    paths = build(sources, OUT)
    own = {"rerank": rerank, "device_beam": device_beam}
    mods = {"this": {}, AGAINST: {}}
    theirs = other_checkout(args.against) if args.against else {}
    for name, path in paths.items():
        who = AGAINST if name.startswith(AGAINST + "_") else "this"
        kernel, copy = name.split("__")
        kernel = kernel[len(AGAINST) + 1:] if who == AGAINST else kernel
        mod = (theirs if who == AGAINST else own)[kernel]
        mods[who].setdefault(kernel, (mod, {}))[1][copy] = load(mod, path)
    if not mods[AGAINST]:
        del mods[AGAINST]
    lib = mods["this"]["rerank"][1]["as_is"]
    print(json.dumps({"floor": floor(lib, args.iters)}), flush=True)
    # the captures run on this checkout's kernels as the path runs them
    rerank._library = lambda: mods["this"]["rerank"][1]["as_is"]
    device_beam._library = lambda: mods["this"]["device_beam"][1]["as_is"]
    if "b7a" in parts:
        b7a_probe(args, mods)
    if "b7b" in parts or "walks" in parts:
        mt = multitarget_inputs(args.seed)
        if "b7b" in parts:
            b7b_probe(args, mods, mt)
        if "walks" in parts:
            walks_probe(args, mods, mt)
    print(cs.card(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
