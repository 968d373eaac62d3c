#!/usr/bin/env python3
"""Drive the PyTorch port's BM25 query path and its ladder on one GPU.

    python3 chip_smoke.py [--n-docs N] [--seed S] [--batches N]

Phases (any failure exits non-zero; nothing is caught):

1. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (one nvcc
   per source, in parallel) and print the card's name and power limit;
2. kernel vs twin at moderate shapes (100,003 docs), three variants
   (robertson's negative IDF among them), k in {1, 7, 100} and B in
   {8, 64}: K1 (``bm25_resident_score_topk``), K2
   (``bm25_block_score_topk``), K3 (``bm25_resident_score_topk_pruned``,
   on the batch's whole table and its block bounds, so that its in-kernel
   skip does the pruning; the B = 8 batches are one-token queries, whose
   bounds prune, and K3 must skip somewhere) and K4
   (``bm25_gather_score_topk``, on the batch's host gather, per chunk and
   two-level) on the card against their plain torch twins on CPU copies:
   bitwise equal, all columns; K3 also bitwise equal to K1 on the card on
   the same table; the device fragment planner on the card byte-equal to
   the host ``fragment_plan`` and ``default_doc_ids``;
3. full width (``repro.configs.bm25s``: 2,097,152 docs, V = 200,000,
   ~120 unique tokens a doc, doc block 512, batches of 256 queries of at
   most 32 tokens, k = 100, lucene k1 = 1.5, b = 0.75; queries of five
   Zipf tokens as ``repro.data.corpus.zipf_queries`` draws them): build a
   ``DeviceRetriever`` on cuda with its defaults (``plan="device"``, a
   block-max table of the ``auto`` dtype) and serve each batch under
   ``auto``, ``gathered``, ``blocked`` and ``pruned``; every pruned board
   bitwise equal to the gathered board of the same batch, ``auto`` equal
   to the regime it chose; zero posting AND descriptor bytes after the
   build, the launch counters of K1-K3 > 0, and sampled queries of every
   regime exact against the port's ``ScipyBM25`` (scores within atol
   1e-4, ids carrying their oracle scores, so ties may come in either
   order);
4. the degradation ladder at full width through the engine: the same
   index cut into 4 shards of 524,288 documents on the one card, one
   ``RetrievalEngine(scorer="auto", quorum=1.0)`` with every shard's entry
   rung pinned at pruned, serving five batches of the same traffic: a
   healthy one (pruned serves, no trail, not degraded), one with
   ``kernel.resident_pruned`` armed (``nan_board``: pruned→resident), one
   with the pruned and resident breakers tripped (the host rung: host
   gather and K4), one with the host breaker tripped too (blocked) and one
   with every device rung tripped (the oracle). Each shard's trail and the
   engine's ``health()`` are printed; the rung that served is checked on
   every shard, each batch's launch counter of its rung must grow, every
   batch but the host rung's ships zero posting and descriptor bytes, all
   four kernels launched, and 20 sampled queries of each batch are exact
   against ``ScipyBM25`` on the whole index (as in phase 3);
5. at the full-width shapes: the device planner timed with CUDA events
   beside the host ``fragment_plan`` (tables byte-equal) and profiled
   with ``torch.profiler``, ``torch.cummax`` and ``torch.cumsum`` timed
   over a stream of the planner's size, the host survivor estimate
   timed; each kernel bitwise equal to its CPU twin on the first 32 query
   columns (one B-tile; every column is scored on its own), timed with
   CUDA events beside its twin on the card (atomics there, so values agree
   within atol 1e-4 + rtol 1e-6, and where an id differs from the twin's
   the kernel's id must carry its exact score from the index), and the
   least time the card could take (bytes over 3.35 TB/s, FP32 operations
   over 67 TFLOP/s). K1-K3 at the single retriever's shapes; K4 at the
   host rung's (shard 0's gather of the host-rung batch), beside the host
   gather's own time.

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
REGIMES = ("auto", "gathered", "blocked", "pruned")
N_SHARDS = 4                   # engine shards on the one card (phase 4)
LADDER_SAMPLES = 20            # sampled queries held exact per ladder batch
# the ladder batches: (rung that must serve, fault armed, breakers tripped
# on every shard before the batch, added to the earlier ones)
LADDER_STEPS = (
    ("pruned", None, ()),
    ("resident", {"site": "kernel.resident_pruned", "kind": "nan_board",
                  "times": N_SHARDS, "seed": 3}, ()),
    ("host", None, ("pruned", "resident")),
    ("blocked", None, ("host",)),
    ("oracle", None, ("blocked",)),
)
RUNG_KERNEL = {"pruned": "bm25_resident_score_topk_pruned",
               "resident": "bm25_resident_score_topk",
               "host": "bm25_gather_score_topk",
               "blocked": "bm25_block_score_topk", "oracle": None}


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
    """Phase 2: each kernel on the card bitwise equal to its CPU twin, and
    the device planner on the card byte-equal to the host plan."""
    import torch

    from repro_torch.core import BM25Params, build_index
    from repro_torch.core.retrieval import default_doc_ids
    from repro_torch.kernels import bm25_block_score as k2
    from repro_torch.kernels import bm25_gather_score as k1
    from repro_torch.serve import DeviceRetriever
    from repro_torch.sparse.block_csr import (DeviceIndex,
                                              block_upper_bounds,
                                              fragment_plan,
                                              gather_posting_runs)
    from repro_torch.sparse.fragment_device import plan_fragments_device
    rng = np.random.default_rng(seed)
    n_docs, n_vocab = 100_003, 30_000
    corpus = zipf_corpus(rng, n_docs, n_vocab, 60)
    cuda = torch.device("cuda")
    skipped = 0
    for method, cases in (("robertson", ((1, 8), (100, 64))),
                          ("lucene", ((7, 64), (100, 8))),
                          ("bm25l", ((7, 8), (1, 64)))):
        idx = build_index(corpus, n_vocab, params=BM25Params(method=method))
        cpu = DeviceRetriever(idx, block_size=DOC_BLOCK, q_max=Q_MAX,
                              device="cpu")
        di = cpu.dindex
        di_cuda = DeviceIndex.build(idx, device=cuda, block_size=DOC_BLOCK,
                                    with_blocked=False, with_bmax=False)
        for k, b in cases:
            qs = zipf_queries(rng, b, n_vocab)
            if b == 64:
                qs[-1] = np.zeros(0, np.int32)       # a real empty query
            else:                  # one-token queries: bounds that prune
                qs = [q[:1] for q in qs]
            pk = cpu.pack_batch(qs)
            w = torch.as_tensor(pk.weights)
            fp = fragment_plan(idx, pk.uniq_batch, block_size=DOC_BLOCK)
            # K3 on the whole table (no seed compaction), so that its
            # in-kernel skip does the pruning
            desc3 = torch.as_tensor(fp.desc)
            bounds = torch.as_tensor(block_upper_bounds(
                di.bmax, pk.uniq_tab, pk.weights))
            kw = dict(block_size=DOC_BLOCK, k=k, n_docs=n_docs)
            oks = []
            for fn, ops, extra in (
                    (k1.bm25_resident_score_topk,
                     (torch.as_tensor(fp.desc), w, di.csc_doc_ids,
                      di.csc_scores), dict(frag=di.frag)),
                    (k2.bm25_block_score_topk,
                     (di.blk_tok, di.blk_loc, di.blk_sc,
                      torch.as_tensor(pk.uniq_tab), w), {}),
                    (k1.bm25_resident_score_topk_pruned,
                     (desc3, w, bounds, di.csc_doc_ids, di.csc_scores),
                     dict(frag=di.frag))):
                ref = fn(*ops, **kw, **extra)
                got = fn(*(t.to(cuda) for t in ops), **kw, **extra)
                torch.cuda.synchronize()
                ok = bits_equal(got[0], ref[0]) and bits_equal(got[1], ref[1])
                if not ok:
                    bad = (got[0].cpu() != ref[0]).nonzero()[:5].tolist()
                    print(f"[kernel-vs-twin] {fn.__name__} differs at {bad}")
                oks.append(ok)
            # K3 against K1 on the card, on the same table
            k1c = k1.bm25_resident_score_topk(
                desc3.to(cuda), w.to(cuda), di_cuda.csc_doc_ids,
                di_cuda.csc_scores, frag=di.frag, **kw)
            oks.append(bits_equal(got[0], k1c[0])
                       and bits_equal(got[1], k1c[1]))
            if b <= 32:
                # one B-tile and one CTA: the kernel walks the table in
                # order, as the twin does, and must skip what it skips
                ctas, k1._CTAS = k1._CTAS, 1
                one = k1.bm25_resident_score_topk_pruned(
                    *(t.to(cuda) for t in (desc3, w, bounds,
                                           di.csc_doc_ids, di.csc_scores)),
                    frag=di.frag, **kw)
                k1._CTAS = ctas
                oks[2] = oks[2] and bits_equal(one[0], ref[0]) \
                    and int(one[2]) == int(ref[2])
                skipped += int(one[2])
            # K4 on the batch's host gather, per chunk and two-level
            gp = gather_posting_runs(idx, pk.uniq_batch, acc_block=DOC_BLOCK,
                                     tile=DOC_BLOCK)
            ops4 = tuple(torch.as_tensor(a) for a in (
                gp.token_ids, gp.slot_ids, gp.scores, pk.uniq_tab,
                pk.weights, gp.candidates))
            k4_ok = True
            for two_level in (False, True):
                kw4 = dict(acc_block=DOC_BLOCK, k=k, two_level=two_level)
                ref4 = k1.bm25_gather_score_topk(*ops4, **kw4)
                got4 = k1.bm25_gather_score_topk(
                    *(t.to(cuda) for t in ops4), **kw4)
                torch.cuda.synchronize()
                k4_ok = (k4_ok and bits_equal(got4[0], ref4[0])
                         and bits_equal(got4[1], ref4[1]))
            # the device planner on the card against the host plan
            desc_d, dids_d, _ = plan_fragments_device(
                di_cuda, pk.uniq_tab, sum_df=fp.sum_df, k=k,
                block_size=DOC_BLOCK, nf_bucket=fp.nf_pad)
            oks.append(bits_equal(desc_d, torch.as_tensor(fp.desc))
                       and bits_equal(dids_d, torch.as_tensor(
                           default_doc_ids(fp.vis_blocks, k, n_docs,
                                           DOC_BLOCK))))
            oks.append(k4_ok)
            print(f"[kernel-vs-twin] {method:9s} k={k:3d} B={b:2d} "
                  f"nf={fp.n_frags} sum_df={fp.sum_df} "
                  f"K3 twin skipped={int(ref[2])} card={int(got[2])} "
                  f"K1 bitwise={oks[0]} K2 bitwise={oks[1]} "
                  f"K3 bitwise={oks[2]} K3=K1 {oks[3]} "
                  f"device plan=host plan {oks[4]} K4 bitwise "
                  f"(per chunk and two-level, nc={gp.n_chunks}, "
                  f"p_pad={gp.p_pad}) {oks[5]}", flush=True)
            check(all(oks), f"kernels bitwise equal to twins, device plan "
                            f"equal to host plan ({method}, k={k}, B={b})")
    print(f"[kernel-vs-twin] K3 with one CTA skipped {skipped} fragments "
          "over the B = 8 cases, as its twin did", flush=True)
    check(skipped > 0, "K3 skipped spans on the card in phase 2")


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


def device_profile(fn, n: int = 6) -> str:
    """The ``n`` torch operators of one ``fn()`` call with the most self
    device time, by ``torch.profiler``, as ``name ms`` pairs and their
    total. Only operator rows are read: a kernel's time appears again
    under its own row, which would count it twice."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    rows = sorted((e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CPU),
                  key=dev_us, reverse=True)
    total = sum(dev_us(e) for e in rows)
    if total == 0:
        return "the trace holds no device time"
    top = "; ".join(f"{e.key} {dev_us(e) / 1e3:.2f}" for e in rows[:n])
    return f"{total / 1e3:.2f} ms of device time: {top}"


def boards_equal(a, b) -> bool:
    """Two results' ``[B, k]`` boards equal bit for bit (ids and scores)."""
    return (np.array_equal(a.ids, b.ids)
            and np.array_equal(a.scores.view(np.int32),
                               b.scores.view(np.int32)))


def twin_bitwise(fn, ops, col_at, got, kw, what: str) -> bool:
    """The kernel's first ``TWIN_COLS`` query columns against the wrapper
    on CPU copies of the same operands (so its twin runs) with only those
    columns of the operands at ``col_at`` (weights, bounds): bit for bit."""
    t0 = time.perf_counter()
    cpu = [t.cpu() for t in ops]
    for i in col_at:
        cpu[i] = cpu[i][:, :TWIN_COLS].contiguous()
    ref = fn(*cpu, **kw)
    ok = (bits_equal(got[0][..., :TWIN_COLS], ref[0])
          and bits_equal(got[1][..., :TWIN_COLS], ref[1]))
    print(f"[kernels] {what}: columns 0-{TWIN_COLS - 1} bitwise equal to "
          f"the CPU twin: {ok} ({time.perf_counter() - t0:.1f}s)",
          flush=True)
    return ok


def split_index(idx, n: int) -> list:
    """Cut a whole-corpus index into ``n`` contiguous document ranges, the
    shards ``build_sharded_indexes`` would build (global statistics, so
    every score is unchanged): one mask a shard over the token-major
    postings, which keeps each token's run in document order. The port's
    ``reshard_index`` does the same with one global lexsort, a minute at
    this size."""
    from dataclasses import replace
    tok = np.repeat(np.arange(idx.n_vocab, dtype=np.int32),
                    np.diff(idx.indptr))
    bounds = np.linspace(0, idx.doc_lens.size, n + 1).astype(np.int64)
    shards = []
    for lo, hi in zip(bounds[:-1].tolist(), bounds[1:].tolist()):
        m = (idx.doc_ids >= lo) & (idx.doc_ids < hi)
        indptr = np.zeros(idx.n_vocab + 1, np.int64)
        np.cumsum(np.bincount(tok[m], minlength=idx.n_vocab),
                  out=indptr[1:])
        shards.append(replace(
            idx, indptr=indptr, doc_ids=(idx.doc_ids[m] - lo).astype(
                np.int32), scores=idx.scores[m], doc_lens=idx.doc_lens[lo:hi],
            n_docs=hi - lo, doc_offset=lo))
    return shards


def sampled_exact(oracle, qs, res, rng, n: int) -> float:
    """``n`` sampled queries of a ``[B, k]`` result exact against the
    oracle: the score vector within ``EXACT_ATOL`` of the oracle's top-k,
    each id carrying its oracle score (ties may come in either order), no
    id repeated. Returns the largest |score - oracle| seen."""
    from repro_torch.core.retrieval import topk_numpy
    worst = 0.0
    for qi in rng.choice(len(qs), size=n, replace=False):
        s = oracle.score(qs[qi])
        _, ref_v = topk_numpy(s[None], TOP_K)
        np.testing.assert_allclose(res.scores[qi], ref_v[0], rtol=0,
                                   atol=EXACT_ATOL)
        np.testing.assert_allclose(s[res.ids[qi]], res.scores[qi], rtol=0,
                                   atol=EXACT_ATOL)
        check(len(set(res.ids[qi].tolist())) == TOP_K, "distinct ids")
        worst = max(worst, float(np.abs(res.scores[qi] - ref_v[0]).max()))
    return worst


def phase_ladder(idx, oracle, rng):
    """Phase 4: the exact ladder at full width through the engine.

    Returns ``(launches, shards, retrievers, host_rung_queries)``."""
    import torch

    from repro_torch.kernels import COUNTERS
    from repro_torch.serve import RetrievalEngine
    from repro_torch.serve.faults import inject_faults
    from repro_torch.sparse.block_csr import TRANSFERS, reset_transfer_stats
    t0 = time.perf_counter()
    shards = split_index(idx, N_SHARDS)
    t_split = time.perf_counter() - t0
    t0 = time.perf_counter()
    eng = RetrievalEngine(shards, k=TOP_K, deadline_s=3600.0, quorum=1.0,
                          scorer="auto",
                          scorer_opts=dict(block_size=DOC_BLOCK, q_max=Q_MAX,
                                           device="cuda"))
    torch.cuda.synchronize()
    print(f"[ladder] {N_SHARDS} shards of {shards[0].doc_lens.size} docs "
          f"(split {t_split:.1f}s); engine built and warmed in "
          f"{time.perf_counter() - t0:.1f}s, build {eng.last_build_stats}",
          flush=True)
    retrievers = [rt._scorer for rt in eng.runtimes]
    for dr in retrievers:
        check(dr.plan_mode == "device", 'shards resolve to plan="device"')
        dr.regime = "pruned"            # the operator pins the entry rung
    for c in COUNTERS:
        c.reset()
    host_qs = None
    for rung, fault, trip in LADDER_STEPS:
        qs = zipf_queries(rng, QUERY_BATCH, N_VOCAB)
        for dr in retrievers:
            for hop in trip:
                dr.trip_breaker(hop, cooldown_s=3600.0)
        before = {c.name: c.n for c in COUNTERS}
        reset_transfer_stats()
        t0 = time.perf_counter()
        if fault is None:
            res = eng.retrieve_batch(qs)
        else:
            with inject_faults(dict(fault)) as specs:
                res = eng.retrieve_batch(qs)
            check(specs[0].fired == N_SHARDS,
                  f"the {fault['site']} fault fired on every shard")
        ms = (time.perf_counter() - t0) * 1e3
        grew = {c.name: c.n - before[c.name] for c in COUNTERS}
        trails = [dr.last_plan.degradations for dr in retrievers]
        served = [t[-1]["to"] if t else "pruned" for t in trails]
        print(f"[ladder] rung={rung:8s} ms={ms:.1f} degraded={res.degraded}"
              f" shards_answered={res.shards_answered} served={served} "
              f"launches {grew} posting bytes {TRANSFERS.posting_bytes} "
              f"descriptor bytes {TRANSFERS.descriptor_bytes}", flush=True)
        print(f"[ladder] rung={rung:8s} shard 0 trail "
              + json.dumps([{k: t[k] for k in ("from", "to", "error")}
                            for t in trails[0]]), flush=True)
        h = eng.health()
        print(f"[ladder] rung={rung:8s} health " + json.dumps(
            {"served": h["served"], "degraded": h["degraded"],
             "faults": h["faults"],
             "shards": [{"served": sh["served"], "degraded": sh["degraded"],
                         "degradations": sh["degradations"]}
                        for sh in h["shards"]]}), flush=True)
        check(res.ids.shape == (QUERY_BATCH, TOP_K), "board shape")
        check(np.isfinite(res.scores).all(), "finite board")
        check(not res.degraded and res.shards_answered == N_SHARDS,
              "every shard answered")
        check(all(x == rung for x in served), f"{rung} served every shard")
        if rung == "pruned":
            check(not any(trails), "the healthy batch took no hop")
        if RUNG_KERNEL[rung] is not None:
            check(grew[RUNG_KERNEL[rung]] > 0,
                  f"{RUNG_KERNEL[rung]} launched for the {rung} rung")
        if rung == "host":
            check(TRANSFERS.posting_bytes > 0, "the host rung ships postings")
            host_qs = qs
        else:
            check(TRANSFERS.posting_bytes == 0
                  and TRANSFERS.descriptor_bytes == 0,
                  f"the {rung} rung ships no posting or descriptor bytes")
        t0 = time.perf_counter()
        worst = sampled_exact(oracle, qs, res, rng, LADDER_SAMPLES)
        print(f"[ladder] rung={rung:8s} {LADDER_SAMPLES} sampled queries "
              f"exact against ScipyBM25, max |score - oracle| {worst:.3g} "
              f"({time.perf_counter() - t0:.1f}s)", flush=True)
    launches = {c.name: c.n for c in COUNTERS}
    print(f"[ladder] launches {launches}", flush=True)
    for name, n in launches.items():
        check(n > 0, f"{name} launched on the ladder path")
    return launches, shards, retrievers, host_qs


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
    from repro_torch.core.retrieval import default_doc_ids
    from repro_torch.core.scoring import bucket_pow2
    from repro_torch.kernels import COUNTERS, _build
    from repro_torch.kernels import bm25_block_score as k2
    from repro_torch.kernels import bm25_gather_score as k1
    from repro_torch.serve import DeviceRetriever
    from repro_torch.sparse.block_csr import (TRANSFERS,
                                              estimate_prune_survivors,
                                              fragment_plan,
                                              gather_posting_runs,
                                              reset_transfer_stats)
    from repro_torch.sparse.fragment_device import plan_fragments_device
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
    dr = DeviceRetriever(idx, block_size=DOC_BLOCK, q_max=Q_MAX,
                         device="cuda")
    torch.cuda.synchronize()
    t_dev = time.perf_counter() - t0
    bm = dr.dindex.bmax
    print(f"[full] n_docs={n_docs} V={N_VOCAB} nnz={idx.nnz} "
          f"({idx.nnz / n_docs:.1f} unique tokens a doc); corpus "
          f"{t_gen:.1f}s, index {t_index:.1f}s, device build {t_dev:.1f}s, "
          f"posting bytes uploaded {TRANSFERS.posting_bytes}; "
          f"plan={dr.plan_mode}", flush=True)
    print(f"[full] block-max table: {'u8' if bm.quantized else 'f32'} "
          f"[{bm.host.shape[0]}, {bm.nb_pad}], {bm.nbytes} bytes on the "
          f"card, over_budget={bm.over_budget}, built in "
          f"{bm.build_s * 1e3:.1f} ms (host, upload included)", flush=True)
    check(dr.plan_mode == "device", 'cuda resolves to plan="device"')
    reset_transfer_stats()
    dr.warmup(k=TOP_K)
    for c in COUNTERS:
        c.reset()
    served, boards = [], {}
    for i in range(args.batches):
        qs = zipf_queries(rng, QUERY_BATCH, N_VOCAB)
        for regime in REGIMES:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            res = dr.retrieve_batch(qs, TOP_K, regime=regime)
            end.record()
            end.synchronize()
            p = res.plan
            check(res.ids.shape == (QUERY_BATCH, TOP_K), "board shape")
            check(np.isfinite(res.scores).all(), "finite board")
            frac = ("-" if p.survivor_frac is None
                    else f"{p.survivor_frac:.4f}")
            print(f"[full] regime={regime:8s} batch={i} chose={p.regime:8s}"
                  f" sum_df={p.sum_df} nnz={p.nnz} "
                  f"sum_df/nnz={p.sum_df / p.nnz:.3f} "
                  f"frags_planned={p.frags_planned} "
                  f"frags_pruned={p.frags_pruned} "
                  f"frags_skipped={p.frags_skipped} survivor_frac={frac} "
                  f"pack_ms={res.timings['pack_s'] * 1e3:.1f} "
                  f"ms={start.elapsed_time(end):.1f}", flush=True)
            served.append((regime, i, qs, res))
            boards[regime, i] = res
        chose = boards["auto", i].plan.regime
        pruned_same = boards_equal(boards["pruned", i], boards["gathered", i])
        auto_same = boards_equal(boards["auto", i], boards[chose, i])
        print(f"[full] batch={i}: pruned board bitwise equal to gathered "
              f"{pruned_same}; auto ({chose}) equal to {chose} {auto_same}",
              flush=True)
        check(pruned_same, "pruned board == gathered board")
        check(auto_same, "auto board == the chosen regime's board")
    launches = {c.name: c.n for c in COUNTERS}
    print(f"[full] launches {launches}; after the build: posting bytes "
          f"{TRANSFERS.posting_bytes}, descriptor bytes "
          f"{TRANSFERS.descriptor_bytes}", flush=True)
    check(TRANSFERS.posting_bytes == 0, "postings crossed after the build")
    check(TRANSFERS.descriptor_bytes == 0,
          "descriptors crossed after the build")
    for name, n in launches.items():
        if name != k1.LAUNCHES_GATHER.name:   # the ladder's host rung only
            check(n > 0, f"{name} launched on the main path")

    t0 = time.perf_counter()
    oracle = ScipyBM25(idx)
    worst = 0.0
    for regime, i, qs, res in served[:len(REGIMES)]:
        worst = max(worst, sampled_exact(oracle, qs, res, rng, 5))
    print(f"[full] {5 * len(REGIMES)} sampled queries ({len(REGIMES)} "
          f"regimes) exact against ScipyBM25, max |score - oracle| "
          f"{worst:.3g} (atol {EXACT_ATOL}; "
          f"{time.perf_counter() - t0:.1f}s)", flush=True)

    # -- phase 4: the ladder through the engine ---------------------------
    t0 = time.perf_counter()
    ladder_launches, shards, shard_drs, host_qs = phase_ladder(idx, oracle,
                                                               rng)
    print(f"[ladder] done in {time.perf_counter() - t0:.1f}s", flush=True)

    # -- phase 5: the kernels at the main path's shapes -------------------
    dev = dr.device
    kernels = []
    tol = f"atol {ATOL} + rtol {RTOL} vs the twin on the card"
    bitwise_at = (f"full width, query columns 0-{TWIN_COLS - 1}, CPU twin; "
                  "phase 2: all columns, 100,003 docs, B 8 and 64")
    # every kernel on the last batch's operands (served under each regime)
    pk = dr.pack_batch(served[-1][2])
    n_u = pk.uniq_batch.size
    check(np.array_equal(pk.uniq_tab[:n_u], pk.uniq_batch),
          "weights rows follow the batch's sorted unique tokens")
    sub_csr = oracle.matrix[:, pk.uniq_batch].tocsr()
    # the fragment planners: host numpy against the device builder
    t0 = time.perf_counter()
    fp = fragment_plan(idx, pk.uniq_batch, block_size=DOC_BLOCK)
    host_plan_ms = (time.perf_counter() - t0) * 1e3

    def plan_on_device():
        return plan_fragments_device(dr.dindex, pk.uniq_tab,
                                     sum_df=fp.sum_df, k=TOP_K,
                                     block_size=DOC_BLOCK,
                                     state=dr._nf_state)

    dev_plan_ms = cuda_ms(plan_on_device, reps=3)
    desc_d, dids_d, nf_pad = plan_on_device()
    host_fp = (fp if nf_pad == fp.nf_pad else
               fragment_plan(idx, pk.uniq_batch, block_size=DOC_BLOCK,
                             nf_bucket=nf_pad))
    plan_equal = (bits_equal(desc_d, torch.as_tensor(host_fp.desc))
                  and bits_equal(dids_d, torch.as_tensor(default_doc_ids(
                      host_fp.vis_blocks, TOP_K, n_docs, DOC_BLOCK))))
    print(f"[plan] {fp.n_frags} fragments from sum_df={fp.sum_df}: host "
          f"fragment_plan {host_plan_ms:.1f} ms, device planner "
          f"{dev_plan_ms:.3f} ms (CUDA events, 3 calls, nf bucket "
          f"{nf_pad}); tables byte-equal {plan_equal}", flush=True)
    check(plan_equal, "device plan == host plan at full width")
    print(f"[plan] profile of one device planner call (self device ms): "
          f"{device_profile(plan_on_device)}", flush=True)
    stream = torch.zeros(bucket_pow2(fp.sum_df, floor=8), dtype=torch.int32,
                         device=dev)
    print(f"[plan] over a {stream.numel()}-position int32 stream alone: "
          f"torch.cummax {cuda_ms(lambda: torch.cummax(stream, 0)):.1f} ms, "
          f"torch.cumsum "
          f"{cuda_ms(lambda: torch.cumsum(stream, 0, dtype=torch.int32)):.1f}"
          f" ms", flush=True)
    del stream
    t0 = time.perf_counter()
    frac, _ = estimate_prune_survivors(dr.dindex.bmax, pk.uniq_tab,
                                       pk.weights, k=TOP_K, b_true=pk.b)
    print(f"[plan] host estimate_prune_survivors: "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms, survivor_frac "
          f"{frac:.4f}", flush=True)
    desc = torch.as_tensor(fp.desc, device=dev)
    w = pk.weights
    ops1 = (desc, torch.as_tensor(w, device=dev), dr.dindex.csc_doc_ids,
            dr.dindex.csc_scores)
    kw1 = dict(block_size=DOC_BLOCK, k=TOP_K, n_docs=n_docs)
    got = k1.bm25_resident_score_topk(*ops1, frag=dr.dindex.frag, **kw1)
    ms = cuda_ms(lambda: k1.bm25_resident_score_topk(
        *ops1, frag=dr.dindex.frag, **kw1), reps=5)
    bitwise = twin_bitwise(k1.bm25_resident_score_topk, ops1, (1,), got,
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
    nbytes = fp.n_frags * 24 + w.nbytes + fp.sum_df * 8 + TOP_K * b * 8
    nops = 2.0 * fp.sum_df * b
    kernels.append(dict(
        name="bm25_resident_score_topk", route="cuda",
        source="src/repro_torch/kernels/csrc/bm25_resident.cu",
        replaces="src/repro/kernels/bm25_gather_score.py:593",
        launches=launches["bm25_resident_score_topk"], max_abs_err=err,
        tolerance=tol, twin_bitwise=bitwise, twin_bitwise_at=bitwise_at,
        ms=ms, plain_ms=plain_ms, bytes=nbytes, ops=nops))
    # K2
    tab, w = pk.uniq_tab, pk.weights
    di = dr.dindex
    ops2 = (di.blk_tok, di.blk_loc, di.blk_sc,
            torch.as_tensor(tab, device=dev), torch.as_tensor(w, device=dev))
    kw2 = dict(block_size=DOC_BLOCK, k=TOP_K, n_docs=n_docs)
    got = k2.bm25_block_score_topk(*ops2, **kw2)
    ms = cuda_ms(lambda: k2.bm25_block_score_topk(*ops2, **kw2), reps=3)
    bitwise = twin_bitwise(k2.bm25_block_score_topk, ops2, (4,), got, kw2,
                           "K2")
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
    # K3 on the same batch's pruned operands (seed pass + compaction)
    w_dev = torch.as_tensor(pk.weights, device=dev)
    desc3, bounds3, _, nf_planned, n_surv = dr._plan_pruned(
        pk, w_dev, TOP_K, fp.sum_df)
    ops3 = (desc3, w_dev, bounds3, di.csc_doc_ids, di.csc_scores)
    kw3 = dict(block_size=DOC_BLOCK, frag=di.frag, k=TOP_K, n_docs=n_docs)
    got = k1.bm25_resident_score_topk_pruned(*ops3, **kw3)
    ms = cuda_ms(lambda: k1.bm25_resident_score_topk_pruned(*ops3, **kw3),
                 reps=5)
    bitwise = twin_bitwise(k1.bm25_resident_score_topk_pruned, ops3,
                           (1, 2), got, kw3, "K3")
    check(bitwise, "K3 bitwise equal to its CPU twin at full width")
    k1_got = k1.bm25_resident_score_topk(*ops3[:2], *ops3[3:], **kw3)
    same_k1 = bits_equal(got[0], k1_got[0]) and bits_equal(got[1],
                                                           k1_got[1])
    print(f"[kernels] K3: {nf_planned} fragments planned, {n_surv} after "
          f"the seed compaction, {int(got[2])} skipped in the kernel "
          f"(mean over B-tiles); board bitwise equal to K1 on the same "
          f"table {same_k1}", flush=True)
    check(same_k1, "K3 board == K1 board on the same table")
    del k1_got
    kw3p = dict(block_size=DOC_BLOCK, k=TOP_K, n_docs=n_docs)
    ref = k1.bm25_resident_score_topk_pruned_plain(*ops3, **kw3p)
    plain_ms = cuda_ms(lambda: k1.bm25_resident_score_topk_pruned_plain(
        *ops3, **kw3p))
    err = float((got[0] - ref[0]).abs().max())
    check(bool(torch.allclose(got[0], ref[0], atol=ATOL, rtol=RTOL)),
          f"K3 values vs twin (max abs err {err})")
    check(ids_hold_their_scores(got[0], got[1], ref[1], got[1], n_docs,
                                sub_csr, pk.weights[:n_u], "K3"),
          "K3 ids vs twin")
    del ref
    # what K3 must read: the real fragments' descriptors, one bound row per
    # span (at its first fragment), the postings and the weights
    n_post = int(desc3[1].sum())
    n_spans = int(desc3[4].sum())
    b = pk.weights.shape[1]
    nbytes = (n_surv * 24 + pk.weights.nbytes + n_spans * b * 4
              + n_post * 8 + TOP_K * b * 8)
    nops = 2.0 * n_post * b
    kernels.append(dict(
        name="bm25_resident_score_topk_pruned", route="cuda",
        source="src/repro_torch/kernels/csrc/bm25_resident.cu",
        replaces="src/repro/kernels/bm25_gather_score.py:521",
        launches=launches["bm25_resident_score_topk_pruned"],
        max_abs_err=err, tolerance=tol, twin_bitwise=bitwise,
        twin_bitwise_at=bitwise_at, fragments=int(desc3.shape[1]),
        survivors=n_surv, skipped=int(got[2]), ms=ms, plain_ms=plain_ms,
        bytes=nbytes, ops=nops))
    # K4 at the host rung's shapes: shard 0's gather of the host-rung batch
    sh0, dr0 = shards[0], shard_drs[0]
    pk0 = dr0.pack_batch(host_qs)
    n_u0 = pk0.uniq_batch.size
    t0 = time.perf_counter()
    gp = gather_posting_runs(sh0, pk0.uniq_batch, acc_block=DOC_BLOCK,
                             tile=DOC_BLOCK)
    gather_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    ops4 = [torch.as_tensor(a, device=dev) for a in (
        gp.token_ids, gp.slot_ids, gp.scores, pk0.uniq_tab, pk0.weights,
        gp.candidates)]
    torch.cuda.synchronize()
    upload_ms = (time.perf_counter() - t0) * 1e3
    kw4 = dict(acc_block=gp.acc_block, k=TOP_K, two_level=True)
    got = k1.bm25_gather_score_topk(*ops4, **kw4)
    ms = cuda_ms(lambda: k1.bm25_gather_score_topk(*ops4, **kw4), reps=3)
    print(f"[kernels] K4 at shard 0's host-rung shapes: sum_df={gp.sum_df} "
          f"candidates={gp.n_candidates} nc={gp.n_chunks} p_pad={gp.p_pad}; "
          f"host gather_posting_runs {gather_ms:.1f} ms, upload "
          f"{gp.token_ids.nbytes * 3 + gp.candidates.nbytes} bytes in "
          f"{upload_ms:.1f} ms, K4 (two-level) {ms:.3f} ms", flush=True)
    bitwise = twin_bitwise(k1.bm25_gather_score_topk, ops4, (4,), got, kw4,
                           "K4")
    check(bitwise, "K4 bitwise equal to its CPU twin at full width")
    ref = k1.bm25_gather_score_topk_plain(*ops4, **kw4)
    plain_ms = cuda_ms(lambda: k1.bm25_gather_score_topk_plain(*ops4,
                                                               **kw4))
    err = float((got[0] - ref[0]).abs().max())
    check(bool(torch.allclose(got[0], ref[0], atol=ATOL, rtol=RTOL)),
          f"K4 values vs twin (max abs err {err})")
    sub0 = ScipyBM25(sh0).matrix[:, pk0.uniq_batch].tocsr()
    check(ids_hold_their_scores(got[0], got[1], ref[1], got[1],
                                sh0.doc_lens.size, sub0,
                                pk0.weights[:n_u0], "K4"), "K4 ids vs twin")
    del ref, ops4
    b = pk0.weights.shape[1]
    nbytes = (gp.token_ids.nbytes + gp.slot_ids.nbytes + gp.scores.nbytes
              + gp.candidates.nbytes + pk0.uniq_tab.nbytes
              + pk0.weights.nbytes + TOP_K * b * 8)
    nops = 2.0 * gp.sum_df * b
    kernels.append(dict(
        name="bm25_gather_score_topk", route="cuda",
        source="src/repro_torch/kernels/csrc/bm25_gather_score.cu",
        replaces="src/repro/kernels/bm25_gather_score.py:177",
        launches=ladder_launches["bm25_gather_score_topk"],
        max_abs_err=err, tolerance=tol, twin_bitwise=bitwise,
        twin_bitwise_at=(f"shard 0's host-rung gather, query columns "
                         f"0-{TWIN_COLS - 1}, CPU twin; phase 2: all "
                         "columns, 100,003 docs, B 8 and 64"),
        n_chunks=gp.n_chunks, p_pad=gp.p_pad, sum_df=gp.sum_df,
        gather_ms=gather_ms, ms=ms, plain_ms=plain_ms, bytes=nbytes,
        ops=nops))
    for kd in kernels[:3]:
        kd["launches_ladder"] = ladder_launches[kd["name"]]
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
