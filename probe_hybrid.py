"""Where B6a's and B6b's time goes, and the filtered keyword leg's, on one
card.

    python3 probe_hybrid.py [--iters 50] [--parts b6a,b6b,leg]
                            [--against DIR]

B6a (``sparse_topk_cuda``, ``csrc/hybrid.cu``) at phase ``hybrid``'s
widest 45%-filter leg (an 8,192-doc tenant of ``chip_smoke.py``'s Zipf
postings, the widest of the phase's query pool, k 20) and at a
550,000-doc tenant (``chip_smoke.py``'s ``b6_sparse_grid`` data: k 10 and
k 100 unfiltered, k 10 at 45% and with min-match 2). For each shape it
prints:

- ``device_ms``: the device time a call, with the stream held by a spin
  kernel while ``--iters`` calls are enqueued, so the host's part is not
  in it (``held`` says the enqueue ended before the spin did);
- ``host_ms``: the host time a call takes to enqueue (the wrapper's
  Python, its allocations and the C entry point);
- ``back_to_back_ms``: CUDA events around calls back to back, what a
  caller sees (the larger of the two above);
- the same ``device_ms`` for copies of the source with one part switched
  off (``COPIES``; the other checkout's ``AGAINST_COPIES``): the segment
  pass, the per-CTA selection, the last CTA's merge.

The launch floor: an empty kernel launched through the same ctypes path
(``probe_empty``, appended to every copy), a memset of one int, and
``cudaFuncSetAttribute`` alone, each by host time and device time.

B6b: ``fuse_topk`` at config 5's shape (two legs of 20, k 10) split into
its uploads (``Tensor.to``), its launch (``fusion_topk_cuda``) and its
downloads (``Tensor.cpu``), counted and timed on the host, beside the
kernel's device time.

The leg (``--parts leg``): a collection of LEG_TENANTS tenants built as
phase ``hybrid`` builds them, and its 256 filtered keyword legs
(``bucket < 45``, fetch 20) through ``Collection.bm25_search``, once with
``device_scoring`` (B6a) and once without (WAND), on the same requests:
each request's host time, and the device route split by step (the
filter's allow list, ``_weighted_query_terms``, ``PostingList.arrays``,
``DocLengths.gather``, the live mask, the operands' packing, the upload,
the launch, the read-back, the object reads).

``--parts phase --against DIR`` runs ``chip_smoke.py``'s phase ``hybrid``
of this checkout and of the other in turns (this, other, other, this),
each in a process of its own, and prints each run's passes (p50, p99,
legs), recall@10 and the main path's B6a and B6b entries.

``--against DIR`` times another checkout's wrappers and kernel (its
``ops/sparse.py``, ``ops/fusion.py`` and ``csrc/hybrid.cu``, built beside
this one's) in turns with this one's on the same inputs, and checks that
their pages are equal. Unpack the parent with ``git archive HEAD | tar -x
-C _chipcheck/parent``. Builds go to ``weaviate_tpu_torch/_build/
probe_h/``. Prints one JSON line per measurement, and the card's name and
power limit last.
"""

from __future__ import annotations

import argparse
import ctypes
import inspect
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

import probe_common as common
from probe_common import build, queued, stream

ROOT = Path(__file__).resolve().parent
SOURCE = ROOT / "weaviate_tpu_torch" / "csrc" / "hybrid.cu"
OUT = ROOT / "weaviate_tpu_torch" / "_build" / "probe_h"
AGAINST = "against"
K1, B = 1.2, 0.75
LEG_TENANTS = 4
LEG_FETCH = 20

# the probe's own entry points, appended to every copy: those of
# probe_common.py, a memset of one int and the shared-memory attribute
# alone
APPENDED = common.APPENDED + r"""
extern "C" int probe_memset(void* p, void* stream) {
  return static_cast<int>(
      cudaMemsetAsync(p, 0, sizeof(int), static_cast<cudaStream_t>(stream)));
}
extern "C" int probe_attr() {
  return static_cast<int>(cudaFuncSetAttribute(
      probe_empty_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      65536));
}
"""

# copies of this source with one part of B6a switched off, or one
# constant changed
COPIES = {
    # no entry is added (the segments' ranges are still searched): no doc
    # is touched, so none is kept
    "no_scatter": [
        ("      for (int b0 = s0; b0 < s1; b0 += kSegBatch) {",
         "      for (int b0 = s0; b0 < s0; b0 += kSegBatch) {")],
    # each CTA writes its first kept keys, not its k best
    "no_select": [
        ("  int taken;\n  if (c <= kRankMax) {",
         "  int taken;\n  if (true) {\n    taken = min(c, p.k);\n"
         "    for (int j = tid; j < taken; j += kSparseThreads) "
         "part[j] = work[j];\n  } else if (c <= kRankMax) {")],
    # the last CTA writes nothing: no merge
    "no_merge": [
        ("  if (!s_last) return;", "  if (!s_last || p.k > 0) return;")],
    # the segments' ranges not searched (every range empty)
    "no_search": [
        ("        const int from = warp_lower_bound(p.rows, a, b, lo);\n"
         "        const int to = warp_lower_bound(p.rows, from, b, lo + n);",
         "        const int from = a, to = a;")],
    # up to 128 or 32 keys (not 512) ranked by counting, more selected
    "rank_128": [("constexpr int kRankMax = 512;",
                  "constexpr int kRankMax = 128;")],
    "rank_32": [("constexpr int kRankMax = 512;",
                 "constexpr int kRankMax = 32;")],
}
# the same parts of the earlier B6a (commit 0e77736: a bitonic sort a CTA
# and a pairwise merge), for --against
AGAINST_COPIES = {
    "no_scatter": [
        ("    for (int s0 = 0; s0 < p.n_seg; s0 += kSparseThreads) {",
         "    for (int s0 = 0; s0 < 0; s0 += kSparseThreads) {")],
    "no_select": [
        ("  if (c > 1) bitonic_sort(work, n2);\n  unsigned long long* part",
         "  unsigned long long* part")],
    "no_merge": [
        ("  if (!s_last) return;", "  if (!s_last || p.k > 0) return;")],
}


def copies_of(text: str) -> dict:
    """The copies that apply to ``text``: this source's, else those of
    commit 0e77736's kernel (AGAINST_COPIES)."""
    return common.copies_of((COPIES, AGAINST_COPIES), text, APPENDED,
                            "the source")


def load(mod, path: Path) -> ctypes.CDLL:
    return common.load(mod, path,
                       probe_memset=[ctypes.c_void_p, ctypes.c_void_p])


def other_checkout(root: Path):
    """Another checkout's ``ops/sparse.py`` and ``ops/fusion.py``, loaded
    beside this one's (their ``_library`` set by the caller)."""
    mods = {}
    for name in ("sparse", "fusion"):
        mods[name] = common.load_module(
            root / "weaviate_tpu_torch" / "ops" / f"{name}.py",
            f"{name}_against")
    mods["fusion"].sparse = mods["sparse"]
    return mods["sparse"], mods["fusion"]


def floor(lib, iters: int) -> dict:
    """The launch floor through ctypes: an empty kernel, a one-int memset
    and the shared-memory attribute alone."""
    buf = torch.zeros(1, dtype=torch.int32, device="cuda")
    out = {"empty": queued(lib, lambda: lib.probe_empty(stream()), iters),
           "memset": queued(lib, lambda: lib.probe_memset(buf.data_ptr(),
                                                          stream()), iters)}
    t0 = time.perf_counter()
    for _ in range(iters):
        lib.probe_attr()
    out["set_attribute_host_ms"] = (time.perf_counter() - t0) * 1e3 / iters
    return out


# ---------------------------------------------------------------------------
# B6a
# ---------------------------------------------------------------------------


def operands(post: dict, terms, dl, avgdl: float, k: int, share,
             gen) -> dict:
    """One query's B6a operands in both layouts: per segment (this
    interface: rows, tf, dl an entry; weight, avgdl, group a segment) and
    per entry (commit 0e77736's: weight, avgdl and group an entry too)."""
    import chip_smoke as cs

    op = cs.sparse_inputs(post, terms, dl, avgdl, k, share, gen)
    lens = torch.diff(op["seg"]).long()
    n = op["entries"]
    p_len = op["rows"].numel()
    for seg_key, key, pad in (("seg_w", "w", 0.0), ("seg_avgdl", "avgdl", 1.0),
                              ("seg_grp", "grp", 0)):
        if seg_key not in op:  # every segment holds an entry
            op[seg_key] = op[key][op["seg"][:-1].long()].contiguous()
        if key not in op:
            full = torch.full((p_len,), pad, dtype=op[seg_key].dtype,
                              device="cuda")
            full[:n] = torch.repeat_interleave(op[seg_key], lens)
            op[key] = full
    return op


def b6a_call(mod, op: dict, k: int, mm: int):
    """``mod``'s B6a wrapper on ``op``, in its own interface."""
    from weaviate_tpu_torch.ops.fusion import bucket

    extra = (op["seg_grp" if "seg_grp" in inspect.signature(
        mod.sparse_topk_cuda).parameters else "grp"],
        bucket(op["groups"], floor=2), mm) if mm else ()
    if "seg_w" in inspect.signature(mod.sparse_topk_cuda).parameters:
        return mod.sparse_topk_cuda(
            op["rows"], op["tf"], op["dl"], op["seg"], op["seg_w"],
            op["seg_avgdl"], op["allow"], k, K1, B, *extra)
    return mod.sparse_topk_cuda(op["rows"], op["tf"], op["dl"], op["w"],
                                op["avgdl"], op["allow"], op["seg"], k, K1,
                                B, *extra)


def b6a_shapes(seed: int) -> list:
    """(name, operands, k, min-match): phase ``hybrid``'s widest 45% leg,
    and the 550,000-doc tenant's modes."""
    import chip_smoke as cs

    gen = torch.Generator(device="cuda").manual_seed(seed + 21)
    shapes = []
    post = cs.zipf_postings(cs.HYBRID_DOCS, 1000)
    pool = cs.query_pool(post["df"], cs.HYBRID_REQUESTS, 5)
    widest = max(pool, key=lambda t: sum(int(post["df"][x]) for x in t))
    dl = post["dl"]
    shapes.append(("hybrid_widest_45pct", operands(
        post, widest, dl, float(dl.mean()), LEG_FETCH, 0.45, gen),
        LEG_FETCH, 0))
    post = cs.zipf_postings(cs.MS_TENANT_DOCS, seed + 5)
    terms = cs.query_pool(post["df"], cs.B6A_QUERIES, seed + 7)[0]
    dl = post["dl"]
    avgdl = float(dl.mean())
    for name, share, k, mm in (("550k_k10", None, 10, 0),
                               ("550k_k100", None, 100, 0),
                               ("550k_45pct_k10", 0.45, 10, 0),
                               ("550k_min_match_2_k10", None, 10, 2)):
        shapes.append((name, operands(post, terms, dl, avgdl, k, share, gen),
                       k, mm))
    return shapes


def b6a_probe(args, mods, libs) -> None:
    """Each shape: this wrapper (and the other checkout's, in turns) with
    the source as it is and each copy."""
    shapes = b6a_shapes(args.seed)
    for name, op, k, mm in shapes:
        line = {"b6a": name, "entries": op["entries"],
                "space": int(op["allow"].numel()), "k": k, "min_match": mm}
        pages = {}
        for who, (mod, mlibs) in mods.items():
            mod._library = lambda lib=mlibs["as_is"]: lib
            pages[who] = [t.clone() for t in b6a_call(mod, op, k, mm)]
            line[who] = queued(mlibs["as_is"],
                               lambda: b6a_call(mod, op, k, mm), args.iters)
            for copy, lib in mlibs.items():
                if copy == "as_is":
                    continue
                mod._library = lambda lib=lib: lib
                line[who][copy] = queued(
                    lib, lambda: b6a_call(mod, op, k, mm),
                    args.iters)["device_ms"]
            mod._library = lambda lib=mlibs["as_is"]: lib
            if who == AGAINST:  # this one again, after the other
                mod0, l0 = mods["this"]
                line["this_again"] = queued(
                    l0["as_is"], lambda: b6a_call(mod0, op, k, mm),
                    args.iters)
        if AGAINST in pages:
            line["pages_equal"] = all(
                torch.equal(x.view(torch.int32), y.view(torch.int32))
                for x, y in zip(pages["this"], pages[AGAINST]))
        print(json.dumps(line), flush=True)


# ---------------------------------------------------------------------------
# B6b
# ---------------------------------------------------------------------------


class Timers:
    """Wraps ``(owner, attribute)`` callables while installed, summing
    each one's host seconds and calls."""

    def __init__(self, targets: dict, sync: tuple = ()):
        self.targets, self.sync = targets, set(sync)
        self.s = {name: 0.0 for name in targets}
        self.n = {name: 0 for name in targets}

    def __enter__(self):
        self.real = {}
        for name, (owner, attr) in self.targets.items():
            fn = getattr(owner, attr)
            self.real[name] = fn

            def timed(*a, _fn=fn, _name=name, **kw):
                t0 = time.perf_counter()
                out = _fn(*a, **kw)
                if _name in self.sync:
                    torch.cuda.synchronize()
                self.s[_name] += time.perf_counter() - t0
                self.n[_name] += 1
                return out

            if hasattr(fn, "launches"):  # a kernel wrapper counts on itself
                timed.launches = fn.launches
            setattr(owner, attr, timed)
        return self

    def __exit__(self, *exc):
        for name, (owner, attr) in self.targets.items():
            if hasattr(self.real[name], "launches"):
                self.real[name].launches = getattr(owner, attr).launches
            setattr(owner, attr, self.real[name])

    def per_call(self, calls: int) -> dict:
        return {name: {"ms": self.s[name] * 1e3 / calls,
                       "calls": self.n[name] / calls} for name in self.s}


def fusion_sets(seed: int, n: int):
    """n config-5 fusion requests: two legs of LEG_FETCH keys drawn from
    40, scores descending."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        slots, scores = [], []
        for _leg in range(2):
            pick = rng.choice(40, LEG_FETCH, replace=False)
            slots.append(pick.tolist())
            scores.append(np.sort(rng.normal(size=LEG_FETCH))[::-1].tolist())
        out.append((slots, scores, len(set(slots[0]) | set(slots[1]))))
    return out


def b6b_probe(args, mods, libs) -> None:
    reqs = fusion_sets(args.seed, 200)
    for who, (mod, mlibs) in mods.items():
        fusion = mod.fusion
        mod._library = lambda lib=mlibs["as_is"]: lib
        for slots, scores, uni in reqs[:3]:
            fusion.fuse_topk(slots, scores, [0.5, 0.5], 10,
                             "relativeScoreFusion", uni, device="cuda")
        torch.cuda.synchronize()
        with Timers({"upload": (torch.Tensor, "to"),
                     "download": (torch.Tensor, "cpu"),
                     "launch": (fusion, "fusion_topk_cuda")}) as t:
            t0 = time.perf_counter()
            for slots, scores, uni in reqs:
                fusion.fuse_topk(slots, scores, [0.5, 0.5], 10,
                                 "relativeScoreFusion", uni, device="cuda")
            whole = (time.perf_counter() - t0) * 1e3 / len(reqs)
        # the kernel alone at the shape fuse_topk gives config 5
        slots = torch.full((2, 32), -1, dtype=torch.int32, device="cuda")
        slots[:, :LEG_FETCH] = torch.tensor(reqs[0][0], dtype=torch.int32)
        sc = torch.zeros((2, 32), device="cuda")
        sc[:, :LEG_FETCH] = torch.tensor(reqs[0][1], dtype=torch.float32)
        w = torch.full((2,), 0.5, device="cuda")
        kern = queued(mlibs["as_is"], lambda: fusion.fusion_topk_cuda(
            slots, sc, w, 10, 64), args.iters)
        print(json.dumps({"b6b": who, "shape": [2, 32, 64, 10],
                          "fuse_topk_ms": whole, "parts": t.per_call(
                              len(reqs)), "kernel": kern}), flush=True)


# ---------------------------------------------------------------------------
# the filtered keyword leg
# ---------------------------------------------------------------------------


def leg_probe(args) -> None:
    """The 45%-filtered keyword legs of phase ``hybrid``'s requests on
    LEG_TENANTS tenants, on the device (B6a) and on WAND, split by step."""
    import shutil
    import tempfile

    import chip_smoke as cs
    from weaviate_tpu_torch.core.shard import Shard
    from weaviate_tpu_torch.inverted.columnar import ColumnarProps
    from weaviate_tpu_torch.inverted import index as index_module
    from weaviate_tpu_torch.inverted.index import InvertedIndex
    from weaviate_tpu_torch.inverted.postings import DocLengths, PostingList
    from weaviate_tpu_torch.ops import sparse

    rng = np.random.default_rng(args.seed + 13)
    tenants = []
    for t in range(LEG_TENANTS):
        post = cs.zipf_postings(cs.HYBRID_DOCS, 1000 + t)
        texts, _ = cs.tenant_texts(post)
        tenants.append({"name": f"tenant{t}", "texts": texts,
                        "bucket": rng.integers(0, 100, cs.HYBRID_DOCS),
                        "uuids": cs._uuids(rng, cs.HYBRID_DOCS)})
    pool = cs.query_pool(cs.zipf_postings(cs.HYBRID_DOCS, 1000)["df"],
                         cs.HYBRID_REQUESTS, 5)
    texts = [" ".join(f"t{r}" for r in terms) for terms in pool]
    root = tempfile.mkdtemp(prefix="probe_hybrid_")
    db = cs.DB(root)
    try:
        col = db.create_collection(cs.CollectionConfig(
            name="Msmarco",
            properties=[cs.Property("body", cs.DataType.TEXT),
                        cs.Property("bucket", cs.DataType.INT)],
            multi_tenancy=cs.MultiTenancyConfig(enabled=True)))
        for ten in tenants:
            col.add_tenant(ten["name"])
            col.put_batch([cs.StorageObject(
                uuid=ten["uuids"][i], collection="Msmarco",
                properties={"body": ten["texts"][i],
                            "bucket": int(ten["bucket"][i])})
                for i in range(cs.HYBRID_DOCS)], tenant=ten["name"])
        flt = cs.Where.lt("bucket", cs.BEAM_FILTER_BUCKETS)

        def legs(device: bool) -> list:
            ms, pages = [], []
            for i, text in enumerate(texts):
                t0 = time.perf_counter()
                pages.append([o.uuid for o, _ in col.bm25_search(
                    text, LEG_FETCH, flt=flt,
                    tenant=tenants[i % LEG_TENANTS]["name"],
                    device_scoring=device)])
                ms.append((time.perf_counter() - t0) * 1e3)
            return ms, pages

        for device in (True, False):  # warm both routes
            legs(device)
        steps = {
            "allow_list": (Shard, "allow_list"),
            "weighted_terms": (InvertedIndex, "_weighted_query_terms"),
            "posting_arrays": (PostingList, "arrays"),
            "doc_lengths_gather": (DocLengths, "gather"),
            "live_mask": (ColumnarProps, "live_mask"),
            "operands": (index_module, "sparse_operands"),
            "dispatch": (InvertedIndex, "_device_sparse_single"),
            "launch": (sparse, "sparse_topk_cuda"),
            "upload": (torch.Tensor, "to"),
            "read_back": (torch.Tensor, "cpu"),
            "device_search": (InvertedIndex, "bm25_device_search"),
            "wand_search": (InvertedIndex, "bm25_search"),
            "object_reads": (Shard, "get_by_docid"),
        }
        steps = {name: target for name, target in steps.items()
                 if hasattr(*target)}
        out = {"tenants": LEG_TENANTS, "docs": cs.HYBRID_DOCS,
               "legs": len(texts), "fetch": LEG_FETCH}
        for rnd in range(2):  # device, WAND, WAND, device
            for device in ((True, False) if rnd == 0 else (False, True)):
                with Timers(steps) as t:
                    ms, pages = legs(device)
                key = "device" if device else "wand"
                out.setdefault(key, []).append({
                    "p50_ms": float(np.median(ms)),
                    "p99_ms": float(np.percentile(ms, 99)),
                    "mean_ms": float(np.mean(ms)),
                    "steps": {n: v for n, v in t.per_call(len(texts)).items()
                              if v["calls"]}})
                out[f"{key}_pages"] = pages
        same = sum(a == b for a, b in zip(out.pop("device_pages"),
                                          out.pop("wand_pages")))
        out["pages_equal"] = f"{same}/{len(texts)}"
        print(json.dumps({"leg": out}), flush=True)
    finally:
        db.close()
        shutil.rmtree(root, ignore_errors=True)


# phase `hybrid` of a checkout, in a process of its own, as one JSON line:
# each pass's p50 / p99 and legs, recall@10, and the main path's B6a and
# B6b entries of the kernels line
PHASE = """
import json, sys
sys.path.insert(0, ".")
import chip_smoke as cs
state = {"card": cs.card()}
out = cs.phase_hybrid(0, state)
keep = ("passes", "recall_at_10", "b6a", "b6b", "ingest_s", "close_s")
print(json.dumps({k: out[k] for k in keep}))
"""


def phase_turns(other: Path) -> None:
    """``--parts phase``: phase ``hybrid`` of this checkout and of
    ``other`` in turns (this, other, other, this), each run a process of
    its own in its checkout's root."""
    for who, root in (("this", ROOT), (AGAINST, other), (AGAINST, other),
                      ("this", ROOT)):
        run = subprocess.run([sys.executable, "-c", PHASE], cwd=root,
                             capture_output=True, text=True)
        if run.returncode:
            raise SystemExit(f"probe: phase hybrid failed in {root}:\n"
                             f"{run.stderr[-4000:]}")
        print(json.dumps({"phase": who, **json.loads(
            run.stdout.strip().splitlines()[-1])}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--parts", default="b6a,b6b,leg")
    ap.add_argument("--against", type=Path, default=None,
                    help="another checkout whose B6a and B6b are timed in "
                         "turns with this one's")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_hybrid: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from weaviate_tpu_torch.ops import fusion, sparse

    parts = args.parts.split(",")
    if "phase" in parts:
        if args.against is None:
            raise SystemExit("probe: --parts phase needs --against")
        phase_turns(args.against)
        print(cs.card(), flush=True)
        return 0
    sources = {f"as_is": SOURCE.read_text() + APPENDED}
    sources.update(copies_of(SOURCE.read_text()))
    if args.against is not None:
        other = (args.against / "weaviate_tpu_torch" / "csrc"
                 / "hybrid.cu").read_text()
        sources[f"{AGAINST}_as_is"] = other + APPENDED
        sources.update({f"{AGAINST}_{n}": t
                        for n, t in copies_of(other).items()})
    paths = build(sources, OUT)
    sparse.fusion = fusion
    mods = {"this": (sparse, {n: load(sparse, p) for n, p in paths.items()
                              if not n.startswith(AGAINST)})}
    if args.against is not None:
        o_sparse, o_fusion = other_checkout(args.against)
        o_sparse.fusion = o_fusion
        mods[AGAINST] = (o_sparse, {
            n[len(AGAINST) + 1:]: load(o_sparse, p)
            for n, p in paths.items() if n.startswith(AGAINST)})
    lib = mods["this"][1]["as_is"]
    print(json.dumps({"floor": floor(lib, args.iters)}), flush=True)
    if "b6a" in parts:
        b6a_probe(args, mods, paths)
    if "b6b" in parts:
        b6b_probe(args, mods, paths)
    if "leg" in parts:
        sparse._library = lambda: lib
        leg_probe(args)
    print(cs.card(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
