"""Why BQ flat recall falls at bench_bq's scale: recall@10 against rows a
cluster and the rescore limit.

    python3 probe_bq_recall.py [--device cuda] [--centres 32]
                               [--per-centre 305,1220,2441]
                               [--rescore 320,1280,2560] [--queries 32]

``bench.py bench_bq``'s rows (768-d, unit rows, noise 0.45 around seeded
normal centres; queries = the first rows + 0.05 noise) hold 2,441 rows a
centre at 10,000,000 rows over 4,096 centres. This builds the same rows at
``--centres`` centres and each ``--per-centre`` count, a
``make_flat(768, FlatIndexConfig(cosine, quantizer=BQConfig(rescore_limit=R)))``
for each ``--rescore`` R, and prints one JSON line a (rows a centre, R)
pair: recall@10 of the search against the exact float32 answer. If the
hamming scan cannot rank the rows of the query's own cluster, recall is
high while R covers a cluster and falls as a cluster outgrows R. On
``--device cpu`` every scan is its plain PyTorch version (the JAX
program's steps), so the answer does not depend on a kernel.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from weaviate_tpu_torch.index.flat import make_flat
from weaviate_tpu_torch.ops.distance import flat_search, normalize
from weaviate_tpu_torch.schema.config import BQConfig, FlatIndexConfig

DIMS, NOISE, QUERY_NOISE, K = 768, 0.45, 0.05, 10


def rows(centres: int, per_centre: int, queries: int, device: str):
    """bench_bq's generator's shapes, seeded: (corpus, queries) unit rows."""
    gen = torch.Generator(device=device).manual_seed(99)
    c = torch.randn(centres, DIMS, generator=gen, device=device)
    n = centres * per_centre
    assign = torch.randint(0, centres, (n,), generator=gen, device=device)
    corpus = normalize(c[assign] + NOISE * torch.randn(
        n, DIMS, generator=gen, device=device))
    q = normalize(corpus[:queries] + QUERY_NOISE * torch.randn(
        queries, DIMS, generator=gen, device=device))
    return corpus, q


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--centres", type=int, default=32)
    ap.add_argument("--per-centre", default="305,1220,2441")
    ap.add_argument("--rescore", default="320,1280,2560")
    ap.add_argument("--queries", type=int, default=32)
    args = ap.parse_args(argv)
    for per_centre in (int(x) for x in args.per_centre.split(",")):
        corpus, q = rows(args.centres, per_centre, args.queries, args.device)
        n = corpus.shape[0]
        truth = flat_search(q, corpus, K, "cosine",
                            precision="fp32")[1].cpu().numpy()
        host = corpus.cpu().numpy()
        qn = q.cpu().numpy()
        for limit in (int(x) for x in args.rescore.split(",")):
            idx = make_flat(DIMS, FlatIndexConfig(
                distance="cosine", initial_capacity=n,
                quantizer=BQConfig(rescore_limit=limit)), device=args.device)
            idx.add_batch(np.arange(n, dtype=np.int64), host)
            got = idx.search(qn, K).ids
            hits = sum(len(set(g.tolist()) & set(t.tolist()))
                       for g, t in zip(got, truth))
            print(json.dumps({
                "device": args.device, "centres": args.centres,
                "rows_a_centre": per_centre, "rows": n,
                "rescore_limit": limit, "queries": args.queries,
                "recall_at_10": hits / (K * len(truth))}), flush=True)
            del idx
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
