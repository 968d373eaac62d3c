"""Production serving launcher (the paper's workload) on the port.

    PYTHONPATH=src python -m repro_torch.launch.serve --docs 20000 \\
        --shards 4 --queries 100 --k 10 [--variant bm25+] \\
        [--deadline-ms 200] [--device cuda]

Builds the sharded eager index (distributed build: global-stats pass +
per-shard scoring), starts the hedged retrieval engine — one
``DeviceRetriever`` a shard on ``--device`` (default ``cuda``; with no GPU
that raises ``ResidencyError``, pass ``--device cpu`` to run the kernels'
plain twins on the host) — serves a query stream and prints QPS / tail
latency / degradation stats. ``--straggle`` injects a slow shard to
demonstrate deadline hedging; ``--rescale N`` re-shards to N after half
the stream.

Unlike the reference (whose engine scores on the host), one untimed query
goes through the engine before the stream: on the card the first query of
a process pays first-use costs that the engine's one-token warmup does
not reach, and can miss the deadline and come back degraded.
"""

from __future__ import annotations

import argparse
import time


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--docs", type=int, default=20_000)
    ap.add_argument("--vocab", type=int, default=20_000)
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--queries", type=int, default=100)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--variant", default="lucene")
    ap.add_argument("--k1", type=float, default=1.5)
    ap.add_argument("--b", type=float, default=0.75)
    ap.add_argument("--deadline-ms", type=float, default=500.0)
    ap.add_argument("--quorum", type=float, default=0.75)
    ap.add_argument("--straggle", action="store_true",
                    help="make shard 0 sleep 1s (hedging demo)")
    ap.add_argument("--rescale", type=int, default=None,
                    help="elastically re-shard to N after half the stream")
    ap.add_argument("--device", default=None,
                    help="device of the shard retrievers (default cuda)")
    args = ap.parse_args(argv)

    import numpy as np

    from ..core import BM25Params, build_sharded_indexes
    from ..data.corpus import zipf_corpus, zipf_queries
    from ..device import resolve_device
    from ..serve import RetrievalEngine

    device = resolve_device(args.device)
    print(f"[serve] indexing {args.docs} docs "
          f"({args.variant}, k1={args.k1}, b={args.b}) "
          f"into {args.shards} shards...")
    t0 = time.time()
    corpus = zipf_corpus(args.docs, args.vocab, avg_len=80)
    params = BM25Params(method=args.variant, k1=args.k1, b=args.b)
    shards = build_sharded_indexes(corpus, args.vocab, args.shards,
                                   params=params)
    print(f"[serve] indexed in {time.time() - t0:.1f}s "
          f"({sum(s.nnz for s in shards) / 1e6:.2f}M postings)")

    delay = (lambda i: (lambda: 1.0) if i == 0 else None) \
        if args.straggle else None
    engine = RetrievalEngine(shards, k=args.k,
                             deadline_s=args.deadline_ms / 1e3,
                             quorum=args.quorum, delay=delay,
                             scorer_opts=dict(device=device))

    queries = zipf_queries(args.queries, args.vocab, q_len=5)
    if queries:
        engine.retrieve(queries[0])          # untimed: first-use costs
    lat, degraded = [], 0
    t0 = time.time()
    for i, q in enumerate(queries):
        if args.rescale and i == len(queries) // 2:
            print(f"[serve] elastic re-shard -> {args.rescale}")
            engine.rescale(args.rescale)
        r = engine.retrieve(q)
        lat.append(r.latency_s)
        degraded += int(r.degraded)
    dt = time.time() - t0
    lat = np.asarray(lat)
    print(f"[serve] {len(queries)} queries  {len(queries) / dt:.1f} QPS  "
          f"p50 {1e3 * np.percentile(lat, 50):.1f}ms  "
          f"p99 {1e3 * np.percentile(lat, 99):.1f}ms  "
          f"degraded {degraded}/{len(queries)}")


if __name__ == "__main__":
    main()
