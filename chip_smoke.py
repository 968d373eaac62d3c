#!/usr/bin/env python3
"""Drive the PyTorch port's resident BM25 query path on one GPU and check it.

    python3 chip_smoke.py [--n-docs N] [--seed S] [--batches N]

Phases (any failure exits non-zero; nothing is caught):

1. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (one nvcc
   per source, in parallel) and print the card's name and power limit;
2. kernel vs twin: K1 (``bm25_resident_score_topk``) and K2
   (``bm25_block_score_topk``) on the card against their plain torch
   twins on CPU copies of the same inputs, at moderate shapes, three
   variants (robertson's negative IDF among them), k in {1, 7, 100} and
   B in {8, 64}: bitwise equal;
3. full width (``repro.configs.bm25s``: 2,097,152 docs, V = 200,000,
   ~120 unique tokens a doc, doc block 512, batches of 256 queries of at
   most 32 tokens, k = 100, lucene k1 = 1.5, b = 0.75; queries of five
   Zipf tokens as ``repro.data.corpus.zipf_queries`` draws them): build a
   ``DeviceRetriever`` on cuda and serve batches under ``auto``,
   ``gathered`` and ``blocked``; zero posting bytes after the build, both
   launch counters > 0, and sampled queries exact against the port's
   ``ScipyBM25`` (scores within atol 1e-4, ids carrying their oracle
   scores, so ties may come in either order);
4. the kernels at the full-width shapes: each bitwise equal to its CPU
   twin on the first 32 query columns (one B-tile; every column is
   scored on its own), timed with CUDA events beside its twin on the
   card (atomics there, so values agree within atol 1e-4 + rtol 1e-6,
   and where an id differs from the twin's the kernel's id must carry
   its exact score from the index), and the least time the card could
   take (bytes over 3.35 TB/s, FP32 operations over 67 TFLOP/s).

The second-to-last lines are the ``kernels`` JSON and the card's
``nvidia-smi`` name and power limit; the last is the ``{"ok": true, ...}``
JSON. The script exits non-zero without a CUDA device, and when run
outside the repository (it imports ``src/repro_torch``).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

N_VOCAB = 200_000
DOC_BLOCK = 512
QUERY_BATCH = 256
Q_MAX = 32
TOP_K = 100
ALPHA = 1.07                   # data/corpus.py::zipf_corpus
Q_LEN = 5                      # data/corpus.py::zipf_queries
AVG_LEN = 170                  # Poisson mean giving ~120 unique tokens a doc
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12         # CUDA-core FP32 (FMA counted as 2)
EXACT_ATOL = 1e-4              # boards vs ScipyBM25 (different sum order)
ATOL, RTOL = 1e-4, 1e-6        # kernel vs twin on the card (atomics there)
TWIN_COLS = 32                 # query columns held bitwise at full width


def check(ok, what: str) -> None:
    """Fail the run (a check that survives ``python -O``)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def zipf_cdf(n_vocab: int) -> np.ndarray:
    p = np.arange(1, n_vocab + 1, dtype=np.float64) ** -ALPHA
    return np.cumsum(p / p.sum())


def zipf_corpus(rng, n_docs: int, n_vocab: int, avg_len: int) -> list:
    """``zipf_corpus``'s distribution in one vectorized draw."""
    lens = np.maximum(1, rng.poisson(avg_len, size=n_docs))
    flat = np.minimum(np.searchsorted(zipf_cdf(n_vocab),
                                      rng.random(int(lens.sum()))),
                      n_vocab - 1).astype(np.int32)
    return np.split(flat, np.cumsum(lens)[:-1])


def zipf_queries(rng, n: int, n_vocab: int) -> list:
    """``zipf_queries``'s distribution (``Q_LEN`` tokens a query, drawn
    with replacement) in one vectorized draw."""
    flat = np.minimum(np.searchsorted(zipf_cdf(n_vocab),
                                      rng.random(n * Q_LEN)),
                      n_vocab - 1).astype(np.int32)
    return list(flat.reshape(n, Q_LEN))


def cuda_ms(fn, reps: int = 1) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` calls, by CUDA events."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bits_equal(a, b) -> bool:
    import torch
    a, b = a.cpu().contiguous(), b.cpu().contiguous()
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and bool(torch.equal(a, b))


def phase_kernels_vs_twins(seed: int) -> None:
    """Phase 2: each kernel on the card bitwise equal to its CPU twin."""
    import torch

    from repro_torch.core import BM25Params, build_index
    from repro_torch.kernels import bm25_block_score as k2
    from repro_torch.kernels import bm25_gather_score as k1
    from repro_torch.serve import DeviceRetriever
    from repro_torch.sparse.block_csr import fragment_plan
    rng = np.random.default_rng(seed)
    n_docs, n_vocab = 100_003, 30_000
    corpus = zipf_corpus(rng, n_docs, n_vocab, 60)
    cuda = torch.device("cuda")
    for method, cases in (("robertson", ((1, 8), (100, 64))),
                          ("lucene", ((7, 64), (100, 8))),
                          ("bm25l", ((7, 8), (1, 64)))):
        idx = build_index(corpus, n_vocab, params=BM25Params(method=method))
        cpu = DeviceRetriever(idx, block_size=DOC_BLOCK, q_max=Q_MAX,
                              device="cpu")
        di = cpu.dindex
        for k, b in cases:
            pk = cpu.pack_batch(zipf_queries(rng, b, n_vocab))
            w = torch.as_tensor(pk.weights)
            fp = fragment_plan(idx, pk.uniq_batch, block_size=DOC_BLOCK)
            kw = dict(block_size=DOC_BLOCK, k=k, n_docs=n_docs)
            oks = []
            for fn, ops, extra in (
                    (k1.bm25_resident_score_topk,
                     (torch.as_tensor(fp.desc), w, di.csc_doc_ids,
                      di.csc_scores), dict(frag=di.frag)),
                    (k2.bm25_block_score_topk,
                     (di.blk_tok, di.blk_loc, di.blk_sc,
                      torch.as_tensor(pk.uniq_tab), w), {})):
                ref = fn(*ops, **kw, **extra)
                got = fn(*(t.to(cuda) for t in ops), **kw, **extra)
                torch.cuda.synchronize()
                ok = bits_equal(got[0], ref[0]) and bits_equal(got[1], ref[1])
                if not ok:
                    bad = (got[0].cpu() != ref[0]).nonzero()[:5].tolist()
                    print(f"[kernel-vs-twin] {fn.__name__} differs at {bad}")
                oks.append(ok)
            print(f"[kernel-vs-twin] {method:9s} k={k:3d} B={b:2d} "
                  f"nf={fp.n_frags} sum_df={fp.sum_df} "
                  f"K1 bitwise={oks[0]} K2 bitwise={oks[1]}", flush=True)
            check(all(oks), f"kernels bitwise equal to twins ({method}, "
                            f"k={k}, B={b})")


def exact_raw_scores(sub_csr, w, docs, cols) -> np.ndarray:
    """Exact raw score (float64) of doc ``docs[i]`` for query column
    ``cols[i]``: the sum over the batch's tokens ``u`` of
    ``score(doc, u) · w[u, col]``. ``sub_csr`` is the index's docs × tokens
    matrix restricted to the batch's sorted unique tokens (``w``'s rows)."""
    rows = sub_csr[docs]
    cnt = np.diff(rows.indptr)
    contrib = (rows.data.astype(np.float64)
               * w[rows.indices, np.repeat(cols, cnt)].astype(np.float64))
    return np.bincount(np.repeat(np.arange(docs.size), cnt),
                       weights=contrib, minlength=docs.size)


def ids_hold_their_scores(v, ids, ref_ids, gdoc, n_docs, sub_csr, w,
                          what: str) -> bool:
    """The kernel's ids (rank on axis -2, query column on -1) against the
    twin's on the card. Where they differ — the twin's atomics round some
    near-ties the other way — the kernel's id must carry its exact score
    from the index within tolerance (``gdoc`` maps each entry to its
    global doc; a doc outside ``[0, n_docs)`` must carry the float
    minimum). No id may repeat in a list."""
    import torch
    distinct = bool((torch.sort(ids, dim=-2).values.diff(dim=-2) != 0).all())
    pos = torch.nonzero(ids != ref_ids)
    sel = tuple(pos.T)
    d = gdoc[sel].cpu().numpy().astype(np.int64)
    val = v[sel].cpu().numpy()
    col = pos[:, -1].cpu().numpy()
    pad = (d < 0) | (d >= n_docs)
    pad_ok = bool((val[pad] == np.finfo(np.float32).min).all())
    err = np.abs(exact_raw_scores(sub_csr, w, d[~pad], col[~pad])
                 - val[~pad])
    bad = err > ATOL + RTOL * np.abs(val[~pad])
    print(f"[kernels] {what}: {pos.shape[0]} of {ids.numel()} ids differ "
          f"from the twin on the card; {int(bad.sum())} of them do not "
          f"carry their exact score (max |value - exact| "
          f"{float(err.max(initial=0.0)):.3g}); padding ok {pad_ok}; ids "
          f"distinct {distinct}", flush=True)
    for i in np.flatnonzero(bad)[:5]:
        print(f"[kernels] {what}: doc {d[~pad][i]} column {col[~pad][i]} "
              f"value {val[~pad][i]!r} exact {err[i] + val[~pad][i]!r}")
    return distinct and pad_ok and not bad.any()


def twin_bitwise(fn, ops, w_at: int, got, kw, what: str) -> bool:
    """The kernel's first ``TWIN_COLS`` query columns against the wrapper
    on CPU copies of the same operands (so its twin runs) with only those
    columns of the weights (operand ``w_at``): bit for bit."""
    t0 = time.perf_counter()
    cpu = [t.cpu() for t in ops]
    cpu[w_at] = cpu[w_at][:, :TWIN_COLS].contiguous()
    ref = fn(*cpu, **kw)
    ok = (bits_equal(got[0][..., :TWIN_COLS], ref[0])
          and bits_equal(got[1][..., :TWIN_COLS], ref[1]))
    print(f"[kernels] {what}: columns 0-{TWIN_COLS - 1} bitwise equal to "
          f"the CPU twin: {ok} ({time.perf_counter() - t0:.1f}s)",
          flush=True)
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-docs", type=int, default=2_097_152)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batches", type=int, default=3,
                    help="batches served under each regime")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from repro_torch.core import BM25Params, ScipyBM25, build_index
    from repro_torch.core.retrieval import topk_numpy
    from repro_torch.kernels import COUNTERS, _build
    from repro_torch.kernels import bm25_block_score as k2
    from repro_torch.kernels import bm25_gather_score as k1
    from repro_torch.serve import DeviceRetriever
    from repro_torch.sparse.block_csr import (TRANSFERS, fragment_plan,
                                              reset_transfer_stats)
    t_all = time.perf_counter()

    # -- phase 1: build + card ------------------------------------------
    t0 = time.perf_counter()
    report = _build.build_all()
    print(f"[build] {time.perf_counter() - t0:.1f}s for "
          f"{len(report)} sources", flush=True)
    for name, r in report.items():
        info = [ln.strip() for ln in r["ptxas"].splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"[build] {name}: {r['seconds']:.1f}s; " + " | ".join(info))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"[card] {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)

    # -- phase 2: kernels vs twins, bitwise -------------------------------
    t0 = time.perf_counter()
    phase_kernels_vs_twins(args.seed)
    print(f"[kernel-vs-twin] done in {time.perf_counter() - t0:.1f}s",
          flush=True)

    # -- phase 3: full width through the retriever ------------------------
    rng = np.random.default_rng(args.seed + 1)
    n_docs = args.n_docs
    if n_docs < 2_097_152:
        print(f"[full] CUT: n_docs={n_docs} (config: 2,097,152)")
    t0 = time.perf_counter()
    corpus = zipf_corpus(rng, n_docs, N_VOCAB, AVG_LEN)
    t_gen = time.perf_counter() - t0
    params = BM25Params(method="lucene", k1=1.5, b=0.75)
    idx = build_index(corpus, N_VOCAB, params=params)
    del corpus
    t_index = time.perf_counter() - t0 - t_gen
    reset_transfer_stats()
    t0 = time.perf_counter()
    dr = DeviceRetriever(idx, regime="auto", block_size=DOC_BLOCK,
                         q_max=Q_MAX, device="cuda")
    torch.cuda.synchronize()
    t_dev = time.perf_counter() - t0
    print(f"[full] n_docs={n_docs} V={N_VOCAB} nnz={idx.nnz} "
          f"({idx.nnz / n_docs:.1f} unique tokens a doc); corpus "
          f"{t_gen:.1f}s, index {t_index:.1f}s, device build {t_dev:.1f}s, "
          f"posting bytes uploaded {TRANSFERS.posting_bytes}", flush=True)
    dr.warmup(k=TOP_K)
    reset_transfer_stats()
    for c in COUNTERS:
        c.reset()
    served, last = [], {}
    for regime in ("auto", "gathered", "blocked"):
        for i in range(args.batches):
            qs = zipf_queries(rng, QUERY_BATCH, N_VOCAB)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            res = dr.retrieve_batch(qs, TOP_K, regime=regime)
            end.record()
            end.synchronize()
            p = res.plan
            check(res.ids.shape == (QUERY_BATCH, TOP_K), "board shape")
            check(np.isfinite(res.scores).all(), "finite board")
            print(f"[full] regime={regime:8s} batch={i} chose={p.regime:8s}"
                  f" sum_df={p.sum_df} nnz={p.nnz} "
                  f"sum_df/nnz={p.sum_df / p.nnz:.3f} "
                  f"frags={p.frags_planned} "
                  f"pack_ms={res.timings['pack_s'] * 1e3:.1f} "
                  f"ms={start.elapsed_time(end):.1f}", flush=True)
            served.append((regime, qs, res))
            last[p.regime] = qs
    launches = {c.name: c.n for c in COUNTERS}
    print(f"[full] launches {launches}; posting bytes after build "
          f"{TRANSFERS.posting_bytes}; descriptor bytes "
          f"{TRANSFERS.descriptor_bytes}", flush=True)
    check(TRANSFERS.posting_bytes == 0, "postings crossed after the build")
    for name, n in launches.items():
        check(n > 0, f"{name} launched on the main path")

    t0 = time.perf_counter()
    oracle = ScipyBM25(idx)
    checked, worst = 0, 0.0
    for regime, qs, res in served[::args.batches]:
        for qi in rng.choice(QUERY_BATCH, size=6, replace=False):
            s = oracle.score(qs[qi])
            _, ref_v = topk_numpy(s[None], TOP_K)
            np.testing.assert_allclose(res.scores[qi], ref_v[0], rtol=0,
                                       atol=EXACT_ATOL)
            np.testing.assert_allclose(s[res.ids[qi]], res.scores[qi],
                                       rtol=0, atol=EXACT_ATOL)
            check(len(set(res.ids[qi].tolist())) == TOP_K, "distinct ids")
            worst = max(worst, float(np.abs(res.scores[qi] - ref_v[0]).max()))
            checked += 1
    check(checked >= 16, "at least 16 sampled queries")
    print(f"[full] {checked} sampled queries exact against ScipyBM25, max "
          f"|score - oracle| {worst:.3g} (atol {EXACT_ATOL}; "
          f"{time.perf_counter() - t0:.1f}s)", flush=True)

    # -- phase 4: the kernels at the main path's shapes -------------------
    dev = dr.device
    kernels = []
    tol = f"atol {ATOL} + rtol {RTOL} vs the twin on the card"
    bitwise_at = (f"full width, query columns 0-{TWIN_COLS - 1}, CPU twin; "
                  "phase 2: all columns, 100,003 docs, B 8 and 64")
    # K1 on the last gathered batch's operands
    pk = dr.pack_batch(last["gathered"])
    n_u = pk.uniq_batch.size
    check(np.array_equal(pk.uniq_tab[:n_u], pk.uniq_batch),
          "weights rows follow the batch's sorted unique tokens")
    sub_csr = oracle.matrix[:, pk.uniq_batch].tocsr()
    t0 = time.perf_counter()
    fp = fragment_plan(idx, pk.uniq_batch, block_size=DOC_BLOCK)
    print(f"[kernels] host fragment_plan of the last gathered batch: "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms for {fp.n_frags} "
          f"fragments", flush=True)
    desc = torch.as_tensor(fp.desc, device=dev)
    w = pk.weights
    ops1 = (desc, torch.as_tensor(w, device=dev), dr.dindex.csc_doc_ids,
            dr.dindex.csc_scores)
    kw1 = dict(block_size=DOC_BLOCK, k=TOP_K, n_docs=n_docs)
    got = k1.bm25_resident_score_topk(*ops1, frag=dr.dindex.frag, **kw1)
    ms = cuda_ms(lambda: k1.bm25_resident_score_topk(
        *ops1, frag=dr.dindex.frag, **kw1), reps=5)
    bitwise = twin_bitwise(k1.bm25_resident_score_topk, ops1, 1, got,
                           dict(kw1, frag=dr.dindex.frag), "K1")
    check(bitwise, "K1 bitwise equal to its CPU twin at full width")
    ref = k1.bm25_resident_score_topk_plain(*ops1, **kw1)
    plain_ms = cuda_ms(lambda: k1.bm25_resident_score_topk_plain(*ops1,
                                                                 **kw1))
    err = float((got[0] - ref[0]).abs().max())
    check(bool(torch.allclose(got[0], ref[0], atol=ATOL, rtol=RTOL)),
          f"K1 values vs twin (max abs err {err})")
    check(ids_hold_their_scores(got[0], got[1], ref[1], got[1], n_docs,
                                sub_csr, w[:n_u], "K1"), "K1 ids vs twin")
    b = w.shape[1]
    nbytes = fp.nf_pad * 24 + w.nbytes + fp.sum_df * 8 + TOP_K * b * 8
    nops = 2.0 * fp.sum_df * b
    kernels.append(dict(
        name="bm25_resident_score_topk", route="cuda",
        source="src/repro_torch/kernels/csrc/bm25_resident.cu",
        replaces="src/repro/kernels/bm25_gather_score.py:593",
        launches=launches["bm25_resident_score_topk"], max_abs_err=err,
        tolerance=tol, twin_bitwise=bitwise, twin_bitwise_at=bitwise_at,
        ms=ms, plain_ms=plain_ms, bytes=nbytes, ops=nops))
    # K2 on the last blocked batch's operands
    pk = dr.pack_batch(last["blocked"])
    tab, w = pk.uniq_tab, pk.weights
    n_u = pk.uniq_batch.size
    check(np.array_equal(tab[:n_u], pk.uniq_batch),
          "weights rows follow the batch's sorted unique tokens")
    sub_csr = oracle.matrix[:, pk.uniq_batch].tocsr()
    di = dr.dindex
    ops2 = (di.blk_tok, di.blk_loc, di.blk_sc,
            torch.as_tensor(tab, device=dev), torch.as_tensor(w, device=dev))
    kw2 = dict(block_size=DOC_BLOCK, k=TOP_K, n_docs=n_docs)
    got = k2.bm25_block_score_topk(*ops2, **kw2)
    ms = cuda_ms(lambda: k2.bm25_block_score_topk(*ops2, **kw2), reps=3)
    bitwise = twin_bitwise(k2.bm25_block_score_topk, ops2, 4, got, kw2, "K2")
    check(bitwise, "K2 bitwise equal to its CPU twin at full width")
    ref = k2.bm25_block_score_topk_plain(*ops2, **kw2)
    plain_ms = cuda_ms(lambda: k2.bm25_block_score_topk_plain(*ops2, **kw2))
    err = float((got[0] - ref[0]).abs().max())
    check(bool(torch.allclose(got[0], ref[0], atol=ATOL, rtol=RTOL)),
          f"K2 values vs twin (max abs err {err})")
    nb = got[1].shape[0]
    gdoc = got[1] + (torch.arange(nb, device=dev, dtype=torch.int32)
                     * DOC_BLOCK)[:, None, None]
    check(ids_hold_their_scores(got[0], got[1], ref[1], gdoc, n_docs,
                                sub_csr, w[:n_u], "K2"), "K2 ids vs twin")
    del gdoc, ref
    hits = int(torch.isin(di.blk_tok, ops2[3]).sum())
    b = w.shape[1]
    nbytes = (di.blk_tok.numel() * 12 + tab.nbytes + w.nbytes
              + got[0].numel() * 8)
    nops = 2.0 * hits * b
    kernels.append(dict(
        name="bm25_block_score_topk", route="cuda",
        source="src/repro_torch/kernels/csrc/bm25_block_score.cu",
        replaces="src/repro/kernels/bm25_block_score.py:184",
        launches=launches["bm25_block_score_topk"], max_abs_err=err,
        tolerance=tol, twin_bitwise=bitwise, twin_bitwise_at=bitwise_at,
        ms=ms, plain_ms=plain_ms, bytes=nbytes, ops=nops))
    for kd in kernels:
        t_bytes = kd.pop("bytes") / HBM_BYTES_PER_S * 1e3
        t_ops = kd.pop("ops") / FP32_OPS_PER_S * 1e3
        kd["bound_ms"] = max(t_bytes, t_ops)
        kd["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        kd["library_ms"] = None      # no single torch call computes this
    print(f"[done] {time.perf_counter() - t_all:.1f}s in all", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
