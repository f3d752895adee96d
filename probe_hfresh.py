"""Where B9a's time goes, on one card.

    python3 probe_hfresh.py [--iters 50] [--rows 16384] [--against DIR]
    python3 probe_hfresh.py --phase [--rounds 1] --against DIR

B9a (``posting_topk_cuda``, ``csrc/hfresh.cu``) at the shape of
``chip_smoke.py``'s phase ``hfresh``: its inputs are captured as the phase
makes them (config 4's generator at ``--rows`` rows in an HFresh
collection at its defaults through ``DB``, the phase's 256 queries, one
``vector_search_batch``), the kernel wrapper's arguments taken from the
search's call. It prints, one JSON line each:

- ``structure``: the batch's probes: postings probed, queries a posting,
  rows a posting, the probed postings' entries, the kept (query, row)
  pairs and the unique rows they read;
- for the kernel as it is and for copies of its source with one part
  switched off or one constant changed (``COPIES``): ``device_ms``, the
  device time a call with the stream held by a spin kernel while
  ``--iters`` calls are enqueued (``held`` says the enqueue ended before
  the spin did); for the kernel as it is also ``host_ms``, the host time
  a call takes to enqueue, and ``back_to_back_ms``, CUDA events around
  calls back to back; a copy with other tiles is checked against the
  kernel as it is;
- ``operands_host_ms``: the host time of ``ops/hfresh.py
  posting_operands`` on the batch's probes with their upload, and
  ``table_host_ms`` that of ``posting_table`` on the index's postings
  (where the checkout has them); ``search_p50_ms``, the host time of the
  whole search;
- ``floor``: an empty kernel launched through the same ctypes path.

``--against DIR`` times another checkout's wrapper and kernel as they are
(its ``ops/hfresh.py`` and ``csrc/hfresh.cu``, built beside this one's,
given the same queries, corpus, valid bits, candidates and mask) in turns
with this one's (this, other, this) and checks that the two agree
(columns equal but at near ties, distances within ``chip_smoke.py``'s
B9a tolerance). Unpack the parent with ``git archive HEAD | tar -x -C
_chipcheck/parent``. Builds go to ``weaviate_tpu_torch/_build/probe_f/``.

``--phase --against DIR`` runs the HFresh drive of ``chip_smoke.py``'s
phase ``hfresh`` (its ingest, its searches and B9a's entry, without the
geo index) of this checkout and of the other in turns (this, other,
other, this; ``--rounds`` times), each in a process of its own, and
prints each run's search p50/p99, recall@10, B9a's times and
``step_on_path_ms_median``: the
median over the drive's searches of the time from the index's
``store.snapshot()`` (where both versions start B9a's step: the
candidates' and the posting operands' host work and uploads) to the end
of the kernel call, by CUDA events; then each side's runs of it and of
the search p50, and the rounds' pairs (this against the other run next
to it) in which this checkout's step is the shorter.

The card's name and power limit come last.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

import probe_common as common
from probe_common import Capture, build, queued, stream

ROOT = Path(__file__).resolve().parent
SOURCE = ROOT / "weaviate_tpu_torch" / "csrc" / "hfresh.cu"
OUT = ROOT / "weaviate_tpu_torch" / "_build" / "probe_f"
AGAINST = "against"

_SELECT = "  void* args[] = {&p};\n"
_SCORE = "    e = launch_dependent(reinterpret_cast<const void*>(fn), grid,"
# copies of the source with one part switched off or one constant changed
COPIES = {
    # no inverse and no scoring: the select reads what the scratch holds
    "no_score": [("  if (score) {", "  if (score && a.b < 0) {")],
    # the inverse and the scoring pass
    "no_select": [(_SELECT, _SELECT + "  if (a.b > 0) return 0;\n")],
    # the inverse alone
    "invert_only": [
        (_SELECT, _SELECT + "  if (a.b > 0) return 0;\n"),
        (_SCORE, "    if (a.b < 0)\n  " + _SCORE)],
    # every launch waiting for the one before it to end
    "no_pdl": [
        ("  attr[0].val.programmaticStreamSerializationAllowed = 1;",
         "  attr[0].val.programmaticStreamSerializationAllowed = 0;")],
    # the products and reductions without the rows' reads (row 0's
    # slice, L1-resident, for every row)
    "no_rows": [
        ("                             p.corpus + static_cast<size_t>(rid[r])"
         " * d + i))",
         "                             p.corpus + i))")],
    # the products without the column's binary search (a key is written
    # only where column 0 holds the row)
    "no_search": [
        ("        while (lo < hi) {", "        while (lo < hi && p.n < 0) {")],
    # tiles of 16 queries by 16 rows (2 a warp), of 4 by 64 (8 a warp):
    # the inverse counts its tiles with the copy's constants
    "tile16": [
        ("constexpr int kTileQueries = 8;",
         "constexpr int kTileQueries = 16;"),
        ("constexpr int kWarpRows = 4;", "constexpr int kWarpRows = 2;")],
    "tile4": [
        ("constexpr int kTileQueries = 8;",
         "constexpr int kTileQueries = 4;"),
        ("constexpr int kWarpRows = 4;", "constexpr int kWarpRows = 8;")],
}
# the copies whose results must equal the kernel's as it is
SAME = ("tile16", "tile4")


def copies_of(text: str) -> dict:
    """This source's copies (``COPIES``), each with the probe's entry
    points appended."""
    return common.copies_of((COPIES,), text, common.APPENDED, "hfresh.cu")


def load(mod, path: Path):
    return common.load(mod, path)


def other_checkout(root: Path):
    """Another checkout's ``ops/hfresh.py``, loaded beside this one's (its
    ``_library`` set by the caller)."""
    return common.load_module(
        root / "weaviate_tpu_torch" / "ops" / "hfresh.py", "hfresh_against")


def structure(posts, args) -> dict:
    """The batch's probe structure and the kernel's work on it."""
    from weaviate_tpu_torch.ops import hfresh

    q, corpus, valid, cand, mask = args[:5]
    probe = posts.probe.cpu().numpy()
    sizes = posts.table.off.diff().cpu().numpy()
    used, per = np.unique(probe, return_counts=True)
    lens = sizes[used]
    keep = mask & valid[cand.long()]
    return {"b": int(q.shape[0]), "cmax": int(cand.shape[1]),
            "d": int(q.shape[1]), "nprobe": int(probe.shape[1]),
            "postings": int(len(sizes)), "postings_probed": int(len(used)),
            "queries_a_posting": {"mean": float(per.mean()),
                                  "median": float(np.median(per)),
                                  "max": int(per.max())},
            "rows_a_posting": {"mean": float(lens.mean()),
                               "max": int(lens.max())},
            "probed_entries": int(lens.sum()),
            "probe_pairs": int((lens * per).sum()),
            "tiles": int((-(-per // hfresh.TILE_QUERIES)
                          * -(-lens // hfresh.TILE_ROWS)).sum()),
            "kept_pairs": int(keep.sum()),
            "unique_rows": int(torch.unique(cand[keep]).numel())}


def capture(rows: int, seed: int) -> tuple:
    """Phase ``hfresh``'s B9a call: its arguments, the ``posting_operands``
    and ``posting_table`` arguments of the search, and the search's host
    p50."""
    import chip_smoke as cs
    from weaviate_tpu_torch.index import hfresh as hfresh_index
    from weaviate_tpu_torch.ops import hfresh

    data = cs.clustered(rows, cs.QUANT_DIMS, cs.HF_CENTRES, cs.HF_NOISE,
                        seed + 47)
    host = data.cpu().numpy()
    del data
    rng = np.random.default_rng(seed + 47)
    queries = host[:cs.BATCH] + 0.05 * rng.standard_normal(
        (cs.BATCH, cs.QUANT_DIMS)).astype(np.float32)
    uuids = cs._uuids(rng, rows)
    root = tempfile.mkdtemp(prefix="probe_hfresh_")
    try:
        db = cs.DB(root)
        col = db.create_collection(cs.CollectionConfig(
            name="Hfresh", properties=[cs.Property("bucket",
                                                   cs.DataType.INT)],
            vector_config=cs.HFreshIndexConfig(distance="cosine")))
        for s in range(0, rows, cs.HF_STEP):
            col.put_batch([cs.StorageObject(
                uuid=uuids[i], collection="Hfresh", vector=host[i],
                properties={"bucket": i % 100})
                for i in range(s, min(rows, s + cs.HF_STEP))])
        with Capture(hfresh_index, "posting_table") as table:
            col.vector_search_batch(queries, cs.K)
        ms = []
        for _ in range(cs.HF_REPS):
            t0 = time.perf_counter()
            col.vector_search_batch(queries, cs.K)
            ms.append((time.perf_counter() - t0) * 1e3)
        with Capture(hfresh, "posting_topk_cuda") as cap, \
                Capture(hfresh_index, "posting_operands") as ops:
            col.vector_search_batch(queries, cs.K)
        a, kw = cap.calls[-1]
        args = tuple(x.clone() if torch.is_tensor(x) else x for x in a)
        torch.cuda.synchronize()
        db.close()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return args, kw, ops.calls[-1][0], table.calls[-1][0], float(
        np.median(ms))


def operands_ms(ops, table, iters: int) -> dict:
    """Host ms of ``posting_operands`` on the batch's probes and of
    ``posting_table`` on the index's postings, as the search calls them
    (with their uploads to the card)."""
    from weaviate_tpu_torch.ops import hfresh

    return {name: common.host_ms(lambda fn=fn, a=a: fn(*a), iters)
            for name, fn, a in (
                ("operands_host_ms", hfresh.posting_operands, ops),
                ("table_host_ms", hfresh.posting_table, table))}


def agree(a, b, q, corpus, valid, cand, mask, metric) -> dict:
    """Two outputs of B9a: distances within the grid's tolerance, columns
    equal but at near ties."""
    import chip_smoke as cs
    from weaviate_tpu_torch.ops import hfresh

    (ad, ac), (bd, bc) = a, b
    tol = cs.B9_ATOL + cs.B9_RTOL * bd.abs()
    err = (ad - bd).abs()
    diff = ac != bc
    near = True
    if bool(diff.any()):
        full = hfresh.gather_distance(q, corpus, cand, metric, "fp32")
        full = torch.where(mask & valid[cand.long()], full,
                           cs.MASK_DISTANCE)
        own = torch.gather(full, 1, ac.long())
        near = not bool(((own - bd).abs() > tol)[diff].any())
    return {"distances_within_tolerance": not bool((err > tol).any()),
            "max_abs_diff": float(err.max()), "columns_differ":
            int(diff.sum()), "only_near_ties": near}


PHASE = """
import json, shutil, sys, tempfile
sys.path.insert(0, ".")
import numpy as np, torch
import chip_smoke as cs
rows = cs.clustered(cs.HF_ROWS, cs.QUANT_DIMS, cs.HF_CENTRES, cs.HF_NOISE, 47)
host = rows.cpu().numpy()
rng = np.random.default_rng(47)
queries = host[:cs.BATCH] + 0.05 * rng.standard_normal(
    (cs.BATCH, cs.QUANT_DIMS)).astype(np.float32)
truth = cs.exact_truth(rows, cs.normalize(torch.from_numpy(queries).cuda()),
                       "cosine")
del rows
uuids = cs._uuids(rng, cs.HF_ROWS)
# a CUDA event where each search's B9a step starts (the store's
# snapshot) and where its call ends
from weaviate_tpu_torch.index import store
from weaviate_tpu_torch.ops import hfresh
marks, snapshot, call = [], store.DeviceVectorStore.snapshot, \
    hfresh.posting_topk_cuda


def mark(kind):
    e = torch.cuda.Event(enable_timing=True)
    e.record()
    marks.append((kind, e))


def snapped(self):
    mark("step")
    return snapshot(self)


def called(*a, **kw):
    out = call(*a, **kw)
    mark("call")
    return out


called.launches = call.launches
store.DeviceVectorStore.snapshot = snapped
hfresh.posting_topk_cuda = called
root = tempfile.mkdtemp(prefix="probe_hfresh_phase_")
try:
    out = cs._drive_hfresh({"card": cs.card()}, root, host, queries, truth,
                           uuids)
finally:
    shutil.rmtree(root, ignore_errors=True)
torch.cuda.synchronize()
steps, start = [], None
for kind, e in marks:
    if kind == "step":
        start = e
    elif start is not None:
        steps.append(start.elapsed_time(e))
        start = None
b9a = {k: v for k, v in out["b9a"].items()
       if k.endswith(("_ms", "_median")) or k in ("ms", "launches")}
# the drive's searches: the calls after the warm one
b9a["step_on_path_ms_median"] = float(np.median(steps[1:1 + cs.HF_REPS]))
print(json.dumps({"p50_ms": out["p50_ms"], "p99_ms": out["p99_ms"],
                  "recall_at_10": out["recall_at_10"], "b9a": b9a}))
"""


def phase_turns(other: Path, rounds: int) -> None:
    """``--phase``: the HFresh drive of this checkout and of ``other`` in
    turns (this, other, other, this; ``rounds`` times), each run a process
    of its own in its checkout's root (seed 0, as ``chip_smoke.py`` runs
    it), then a summary of the runs."""
    runs = {"this": [], AGAINST: []}
    for who, root in (("this", ROOT), (AGAINST, other), (AGAINST, other),
                      ("this", ROOT)) * rounds:
        run = subprocess.run([sys.executable, "-c", PHASE], cwd=root,
                             capture_output=True, text=True)
        if run.returncode:
            raise SystemExit(f"probe: the HFresh drive failed in {root}:\n"
                             f"{run.stderr[-4000:]}")
        out = json.loads(run.stdout.strip().splitlines()[-1])
        runs[who].append(out)
        print(json.dumps({"phase": who, **out}), flush=True)
    step = {w: [r["b9a"]["step_on_path_ms_median"] for r in rs]
            for w, rs in runs.items()}
    print(json.dumps({
        "steps_ms": step,
        "p50_ms": {w: [r["p50_ms"] for r in rs] for w, rs in runs.items()},
        "pairs_this_shorter": int(sum(
            a < b for a, b in zip(step["this"], step[AGAINST]))),
        "pairs": len(step["this"])}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rows", type=int, default=16_384)
    ap.add_argument("--against", type=Path, default=None,
                    help="another checkout whose B9a is timed in turns "
                         "with this one's")
    ap.add_argument("--phase", action="store_true",
                    help="the HFresh drive of both checkouts in turns "
                         "(needs --against)")
    ap.add_argument("--rounds", type=int, default=1,
                    help="rounds of --phase's four turns")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_hfresh: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs

    if args.phase:
        if args.against is None:
            ap.error("--phase needs --against")
        phase_turns(args.against.resolve(), args.rounds)
        print(cs.card(), flush=True)
        return 0
    from weaviate_tpu_torch.ops import hfresh

    text = SOURCE.read_text()
    sources = {"this__as_is": text + common.APPENDED}
    sources.update({f"this__{n}": t for n, t in copies_of(text).items()})
    if args.against is not None:
        sources[f"{AGAINST}__as_is"] = (
            args.against / "weaviate_tpu_torch" / "csrc" / "hfresh.cu"
        ).read_text() + common.APPENDED
    paths = build(sources, OUT)
    mods = {"this": (hfresh, {})}
    if args.against is not None:
        mods[AGAINST] = (other_checkout(args.against), {})
    for name, path in paths.items():
        who, copy = name.split("__")
        mods[who][1][copy] = load(mods[who][0], path)
    lib = mods["this"][1]["as_is"]
    hfresh._library = lambda: lib
    print(json.dumps({"floor": queued(
        lib, lambda: lib.probe_empty(stream()), args.iters)}), flush=True)

    a, kw, ops, table, p50 = capture(args.rows, args.seed)
    q, corpus, valid, cand, mask, k, metric, posts = a[:8]
    print(json.dumps({"structure": structure(posts, a), "k": k,
                      "metric": metric, "search_p50_ms": p50,
                      **operands_ms(ops, table, 20)}), flush=True)

    def call(mod):
        if mod is hfresh:
            return mod.posting_topk_cuda(*a, **kw)
        return mod.posting_topk_cuda(q, corpus, valid, cand, mask, k,
                                     metric)

    outs = {}
    order = ["this"] + ([AGAINST, "this"] if AGAINST in mods else [])
    for i, who in enumerate(order):
        mod, libs = mods[who]
        mod._library = lambda lib=libs["as_is"]: lib
        outs.setdefault(who, [t.clone() for t in call(mod)])
        res = queued(libs["as_is"], lambda: call(mod), args.iters)
        if i < 2:
            for copy, clib in libs.items():
                if copy == "as_is":
                    continue
                mod._library = lambda clib=clib: clib
                res[copy] = queued(clib, lambda: call(mod),
                                   args.iters)["device_ms"]
                if copy in SAME:
                    res[copy + "_agrees"] = agree(
                        call(mod), outs[who], q, corpus, valid, cand, mask,
                        metric)
            mod._library = lambda lib=libs["as_is"]: lib
        print(json.dumps({"b9a": who if i < 2 else "this_again", **res}),
              flush=True)
    if AGAINST in outs:
        print(json.dumps({"same_as_against": agree(
            outs["this"], outs[AGAINST], q, corpus, valid, cand, mask,
            metric)}), flush=True)
    print(cs.card(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
