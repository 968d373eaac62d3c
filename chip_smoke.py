#!/usr/bin/env python3
"""Drive the port's query paths, sparse substrate, recsys and LM cells on GPU.

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
   bounds prune, and K3 must skip somewhere; with one CTA, one column
   group of 64, it must skip what its twin skips) and K4
   (``bm25_gather_score_topk``, on the batch's host gather, per chunk and
   two-level) on the card against their plain torch twins on CPU copies:
   bitwise equal, all columns; K3 also bitwise equal to K1 on the card on
   the same table; K6 (``bm25_block_score``, dense sums) on the same
   blocked layout and query tables; the device fragment planner on the
   card byte-equal to the host ``fragment_plan`` and ``default_doc_ids``;
   K5 (``blockwise_topk``) on seeded rows of 9,000 entries (a ragged last
   segment) with blocks of 512 and 4,096 and k in {1, 7, 100, block}:
   random rows, ties, all-equal rows, rows of ``-inf`` and of
   ``-FLT_MAX``, ``+0.0`` mixed with ``-0.0``, denormals and many ties at
   the k-th value, values and positions bitwise equal to the CPU twin and
   every segment's positions distinct; K6 at B in {8, 64, 100, 256} with
   tables of up to 1,280 rows, and at B = 256 with 8,192 (256 x Q_MAX),
   on 20,011 documents, on the token-sorted
   layout and on its postings shuffled within each block, K7 at S =
   10,000 and 50,000 (cut into segment ranges), K2 at B = 256 with
   8,192 table rows at k = 100 at blocks of 512, 700 and 1,024 rows and
   at k = 200 at 512, and K4 at k = 200 (``acc_block`` 512) and k = 600
   (``acc_block`` 1,024) on a chunk of fewer real candidates than 600,
   per chunk and two-level, each bitwise equal to its CPU twin;
3. full width (``repro.configs.bm25s``: 2,097,152 docs, V = 200,000,
   ~120 unique tokens a doc, doc block 512, batches of 256 queries of at
   most 32 tokens, k = 100, lucene k1 = 1.5, b = 0.75; queries of five
   Zipf tokens as ``repro.data.corpus.zipf_queries`` draws them): build a
   ``DeviceRetriever`` on cuda with its defaults (``plan="device"``, a
   block-max table of the ``auto`` dtype) and serve each batch under
   ``auto`` (its survivor estimate on the card), ``gathered``,
   ``blocked`` and ``pruned``; every pruned board
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
   timed; each kernel bitwise equal to its CPU twin on the first 64 query
   columns (every lane of the first CTA's column group; every column is
   scored on its own), K1, K2 and K4 also timed at k = 1 and k = 200
   beside k = 100 (the fold's share; K2 and K4 select k = 200 in two
   passes) and K1 on the first 32 columns (the split), timed with
   CUDA events beside its twin on the card (atomics there, so values agree
   within atol 1e-4 + rtol 1e-6, and where an id differs from the twin's
   the kernel's id must carry its exact score from the index), and the
   least time the card could take (bytes over 3.35 TB/s, FP32 operations
   over 67 TFLOP/s). K1-K3 at the single retriever's shapes; K4 at the
   host rung's (shard 0's gather of the host-rung batch), beside the host
   gather's own time;
6. the dense full-score path at full width, after the engine is freed:
   one batch of 256 queries through ``ops.bm25_score_blocked`` (K6, a
   ``[256, n_docs]`` f32 matrix) and ``ops.topk`` (K5 over ``[131,072,
   4,096]`` segments, then the merge), through ``score_batch`` +
   ``ops.topk`` on the eager scorer's ``DeviceIndex`` with
   ``suggest_p_max``, and ``BM25Retriever`` end to end from texts (the
   Zipf corpus rendered as words, cut to 100,000 documents: tokenizing
   the full 2,097,152 in Python would take most of the time budget; a
   ragged last K5 segment), the launch counts read around the three. The
   unfused board's values bitwise equal the fused K2 board's, its ids
   tie-aware (each carries the fused id's dense score: the shift is added
   before ranking, so two distinct sums can meet); 20 sampled queries of
   it and of ``score_batch``'s board exact against ``ScipyBM25``, no
   overflow, ``score_batch`` within 1e-4 of K6's rows; every retriever
   board exact against ``ScipyBM25`` on the same tokens; ``score_batch``
   run twice on the card bitwise equal, and its rows of 8 sampled queries
   bitwise equal to ``score_batch`` on the CPU over the same arrays; the
   retriever's ids and values bitwise equal to the same retriever built
   with ``device="cpu"``; the fused batch's merge of K2's 409,600
   candidates a query through ``ops.topk`` (K5, then the rank merge)
   bitwise equal, ids and values, to a full ``rank_order`` sort of them,
   both timed; K6 bitwise equal to its CPU twin on 128
   columns, 32 of each 64-column CTA (one a lane), and K5 to its twin on
   the card; K6 and K5 timed with CUDA events
   in turns with ``torch.sparse.mm`` of the doc × token CSR by the
   ``[V, 256]`` weights (K6's library call) and ``torch.topk(dense, 100,
   dim=1)`` (K5's): library, kernel, kernel, library; their twins on the
   card timed; the fused and the unfused batch timed in turns, and
   ``score_batch``;
7. the sparse substrate at full width, after phases 3-6's tensors are
   freed, at two shapes of ``repro/configs/egnn.py``: K7
   (``ops.segment_sum_blocked``) aggregates 64-wide f32 messages (EGNN's
   ``d_hidden``, drawn on the card from ``--seed``) over ogb_products'
   graph (``data.graphs.random_graph(2,449,029, 25)``: 61,225,725 edges,
   power-law in-degree) sorted by destination and cut into 4,784 blocks
   of 512 destinations, each padded to the largest block's length
   rounded up to ``tile_p`` = 512; K8 (``ops.embedding_bag``) takes the
   mean of Reddit's ``[232,965, 602]`` feature rows
   (``random_graph(232,965, 492)``, minibatch_lg) over the hop-1
   ``[1,024, 15]`` and hop-2 ``[15,360, 10]`` bags of a (15, 10)
   neighbour sample drawn by ``neighbor_sample``'s rule. The launch
   counts are read around those three calls; K7 is held bitwise against
   its CPU twin on the largest block and 7 others and the whole output
   within 1e-4 (relative to the largest sum) of ``index_add_`` on the
   card, K8 bitwise against its CPU twin on both bag sets and within
   1e-5 of ``F.embedding_bag``; each kernel, its twin on the card and the
   library call are timed with CUDA events. K7 runs its TMA ring here
   (the stages are printed), K8 its 8-byte loads (the width is printed).

8. after phase 3, on its retriever: ``auto``'s survivor estimate on the
   card (``estimate_survivors_device``) against the host numpy one on
   every phase 3 ``auto`` batch (the same ``survivor_frac`` and regime,
   ``ub`` within one f32 ulp, the ulps counted; both timed at B = 256),
   then 4,096 single Zipf queries submitted at once and 1,024 more at
   seeded exponential gaps at half the burst's QPS through
   ``ServingFrontend(dr, k=100, max_batch=32, batch_deadline_s=0.002)``
   (``max_queue`` 4,096, so the burst is admitted): p50/p99 of each
   request's ``latency_s`` and ``queue_s``, QPS, mean batch, flush
   reasons, the regime mix and the launches, zero posting and descriptor
   bytes, every future resolved within 300 s, 128 sampled requests exact
   against ``ScipyBM25``, every recorded batch bitwise equal to a direct
   ``retrieve_batch`` on its queries; then a ``frontend.former`` thread
   death recovers, an unguarded ``queue.flood`` raises
   ``QueueOverflowError`` and ``close(drain=False)`` fails pending
   futures with ``StageFailedError``;
9. after phase 8, on phase 3's retriever (the launch counts read around
   its serving calls only): (a) K1/K3 past 512 rows — one batch of 256
   queries each under ``gathered``, ``pruned`` and ``auto`` at k = 600
   (resident blocks of 1,024 rows), 20 sampled queries of each exact
   against ``ScipyBM25``; K1 and K3 called at 1,024 rows on that batch's
   device fragment table (K3 with each block's bound the larger of its
   two 512-row halves'), bitwise equal to their CPU twins on 10 sampled
   query columns (both lanes' columns at the edges of each CTA column
   group), K3's board bitwise equal to K1's, both timed with CUDA events,
   and their bound at 1,024 rows by phase 5's rule (``[f3] bound``);
   (b) a cold start at full width — ``dr.save`` into a fresh
   ``tempfile.mkdtemp`` (the free disk space printed first; a short disk
   fails the phase), ``DeviceIndex.load(mmap=True)`` onto the card and a
   ``DeviceRetriever(device_index=...)``: save seconds, bytes on disk,
   the checksum algorithm, read + verify and upload seconds, posting
   bytes (equal to the layouts' size); phase 3's first batch under each
   regime bitwise equal to phase 3's boards, and a second batch shipping
   no posting or descriptor byte; the store is deleted; (c) the snapshot
   fault lanes at 65,536 documents (cut: the small run's depth):
   ``torn_write`` (the save raises, the previous generation serves),
   ``manifest_corrupt``, ``truncate`` and ``bit_flip`` (each load heals
   through a recovery hop) and ``stale_version`` (a typed
   ``SnapshotVersionError``), every recovered board bitwise equal to the
   saving retriever's; (d) ``DeviceRetriever(regime="auto",
   reorder="signature")`` built on phase 3's index (host reorder seconds
   and build seconds), then pruned batches at B = 32 and 256 on it and on
   phase 3's retriever: ``frags_planned/pruned/skipped``, batch ms, zero
   posting and descriptor bytes, sampled queries exact in client ids.
10. after phase 6, on phase 3's index (its retriever freed): the sharded
   step on ``torch.distributed`` at world size 1 — one card runs one
   NCCL rank, so this checks the step and times its local steps; it is
   not a multi-card figure. An NCCL group of one rank in this process
   (``file://`` rendezvous in a temporary directory, destroyed at the
   end), ``launch.mesh.make_mesh_from(device_type="cuda")`` (a (1, 1)
   mesh), ``stack_shard_arrays`` of the full-width index (one upload,
   the bytes printed); the classic step (``score_batch`` + ``ops.topk``,
   K5) on phase 3's first two batches at each batch's exact largest
   ``query_posting_budget``, and at the median budget, where it must flag
   exactly the queries whose host budget exceeds it;
   ``sharded_retrieve_adaptive(gathered=True)`` from p_max 1,024 on the
   same batches (the bucket trail, ``p_used`` the first bucket covering
   the batch's Σdf, the device memory above the inputs at its peak below
   a ``[p_used, B]`` f32 buffer); every board exact against
   ``ScipyBM25`` on 10 sampled queries and tie-aware equal to phase 3's
   gathered board of its batch, the gathered board to the classic one;
   CUDA-event times of both steps and of the all-gather + merge; K5 must
   launch. Then ``python -m repro_torch.launch.serve`` on the card at the
   reference's defaults (20,000 docs, 4 shards, 100 queries, k = 10; it
   must print ``degraded 0/100``) and with ``--rescale 2``, each exiting
   0.
11. after phase 7, every earlier tensor freed: the recsys serving family
   at its configs' widths (``repro_torch.configs``: DLRM-MLPerf, AutoInt,
   SASRec, MIND). DLRM is **cut**: its concatenated table is 96.1 GB in
   f32, more than the card holds, so each field keeps at most 2^22 rows
   (25,038,848 rows, 12.8 GB; the 26 fields, dim 128, both MLPs and the
   interaction kept; a ``CUT`` line says so). An NCCL group of one rank
   and the (1, 1) mesh; for each arch the cells of
   ``configs.get_cells`` (``serve_p99`` B = 512, ``serve_bulk`` B =
   262,144, ``retrieval_cand`` one user against 2^20 candidates) built
   on the mesh, params drawn on the card from a seeded generator, each
   cell's inputs drawn from its specs (histories with left pads on a
   quarter of the rows and, in a serving batch, one all-pad row;
   candidates a permutation of the item ids 1..2^20, or uniform in field
   0's vocabulary for the CTR models, which gives AutoInt's board a block
   of ties); every output finite, ``serve_p99``'s logits equal to the same
   function on the CPU (a CTR model's table copied as the rows the batch
   reads) within rtol/atol 1e-4, and ``retrieval_cand``'s board (its
   top-k is ``ops.topk``: K5) bitwise equal to ``ops.topk`` on the scores
   copied to the CPU (K5's twin) and value-equal to ``torch.topk``, each
   id carrying its own score. Each cell prints its median ms (CUDA
   events, 5 runs after a warm-up), samples (candidates) a second, peak
   device memory and ``model_flops`` over its time as a share of 67
   TFLOP/s; ``retrieval_cand`` also the scoring's ms, ``ops.topk``'s and
   K5's launch alone, and K5's launches.
12. after phase 11, every earlier tensor freed, on the same mesh and
   group: LM serving at full width. gemma3-1b (``configs.get_cells``,
   params drawn on the card and cast to bf16 as the specs say):
   ``decode_32k`` (B = 128, 32,768 positions, 18.7 GB cache) and
   ``long_500k`` (B = 1, 524,288), each one warm-up step, the median of 5
   timed steps and 8 more (``pos`` moves; the local rings wrap);
   ``prefill_32k`` **cut** to B = 1 (a ``CUT`` line says why: f32
   attention over all 32,768 keys, and 80 GB at B = 32), one warm-up and
   the median of 3; ``decode_32k`` over the int8 cache (``kv_quant``).
   Then the card against the CPU in f32 at full width (prefill of 64
   tokens, 4 teacher-forced decode steps from ``pos = 0``; logits within
   rtol/atol 1e-3, greedy ids equal where the CPU's top-2 gap is
   clear), prefill against a 64-step decode in bf16 on the card (logits
   and every layer's K/V within 2^-4 of the tensor's largest entry),
   and ``DecodeEngine`` (8 slots, 1,024 positions) over 16 seeded
   requests (prompts of 8-200 tokens, ``max_new`` 16-64; 4 of them
   decoded again alone by a lockstep ``decode_step``, teacher-forced with
   the engine's ids: equal ids except under a top-2 gap of 4 bf16 ulps,
   counted). Then mixtral-8x7b at full width, depth **cut** from 32 to 2
   layers: ``prefill_32k`` at B = 1, ``decode_32k`` (window-capped
   caches of 4,096) and layer 0's ``moe_block`` in f32 on 64 tokens
   against ``Σ_k w_tk · expert_{e_tk}(x_t)`` over the kept choices
   (rtol/atol 1e-4), its router's integers equal to the CPU's on the same
   logits. Each cell prints its ms (CUDA events), tokens a second, peak
   device memory (params included) and FLOP share of 67 TFLOP/s
   (``model_flops`` of the cut batch or depth); each decode cell its
   cache bytes. No kernel launches here: the LM path reaches none.
13. after phase 12, every earlier tensor freed, on the same mesh and
   group: training at full width (``train/``, the families' train
   cells). First which sums repeat on the card: ``index_add_``,
   ``index_select``'s backward and ``table[ids]``'s backward (reported),
   and the port's fixed-order ``segment_sum`` and ``gather_rows``'
   backward (held bitwise run to run and to the CPU's bits). Then each
   family's SMOKE in f32 (gemma3-1b, mixtral-8x7b, the four recsys
   archs, EGNN's node and graph readouts) trained three steps on the CPU
   and twice on the card: the card's runs bitwise equal, the losses within
   rtol 1e-5, the first step's grads within rtol 1e-4 / atol 1e-6 · max
   |g|, the params within atol 1e-5 wherever AdamW's first step is held to
   a sign by the grads (within 2 · steps · lr elsewhere, counted). Then
   the train cells of ``configs.get_cells``: gemma3-1b ``train_4k`` at
   full width and 4,096 positions, its global batch **cut** from 256 to
   ``TRAIN_LM_BATCH`` (two microbatches, as the config says); the four
   recsys ``train_batch`` cells at B = 65,536, DLRM's table **cut** to
   ``DLRM_TRAIN_ROW_CAP`` rows a field (a step holds seven copies of it);
   EGNN on Cora, on phase 7's Reddit graph through the (15, 10)
   ``neighbor_sample``, on ogb_products with all 2,449,029 nodes and its
   edges **cut** to ``PRODUCTS_TRAIN_EDGES`` (``CUT`` lines give the bytes
   reckoned), and on 128 molecules. Each cell runs ``TRAIN_STEPS`` steps on
   a fixed batch (the loss must fall), then through ``train.loop.
   run_training`` half of them into a checkpoint (bitwise equal to the
   straight run there) and the rest resumed from it (bitwise equal to the
   straight run's end), the other microbatch count (LM and recsys: the
   clipped grads within the dtype's tolerance, the params as above) and
   one step with int8 compression (the same loss, finite params). Each
   prints its step's ms (CUDA events, the median after the first),
   samples, tokens, seeds, nodes or graphs a second, peak device memory,
   and ``model_flops`` (of the cut batch) over its time as a share of the
   peak of its compute dtype (989 TFLOP/s bf16 for the LM, 67 TFLOP/s
   f32 for the rest). No kernel launches: the training path reaches none.

With ``--save-board-operands DIR`` phase 5 also writes K2's and K4's
operands and keyword arguments there (``torch.save``, ~3.5 GB at full
width), for ``tools/time_board_kernels.py`` to time another tree's
kernels on the same inputs.

The second-to-last lines are the ``kernels`` JSON and the card's
``nvidia-smi`` name and power limit; before them a ``[bound]`` line a
kernel gives its time beside its bound. The last line is the ``{"ok":
true, ...}`` JSON. The script exits non-zero without a CUDA device, and
when run outside the repository (it imports ``src/repro_torch``). The
kernels line lists K1-K8; ``launches`` counts each kernel on its own
path: phase 3 for K1-K3, phase 4 for K4, phase 6 for K5 and K6, phase 7
for K7 (once) and K8 (twice); ``launches_frontend`` counts K1-K6 in phase
8's front-end pass and ``launches_phase9`` in phase 9's serving calls; K1
and K3 carry ``ms_rows1024_k600`` and ``bound_ms_rows1024_k600``, their
times and bound at 1,024 rows; ``launches_phase10`` counts every kernel in
phase 10's steps, and K5 carries ``phase10_ms`` (the steps' and the
merge's times); ``launches_phase11`` counts every kernel in phase 11's
cells (K5 alone launches there), and K5 carries ``phase11_ms``
(``ops.topk``'s ms on each arch's ``[1, 2^20]`` scores);
``launches_phase12`` counts every kernel in phase 12 and
``launches_phase13`` every kernel in phase 13 (all 0).
"""

from __future__ import annotations

import argparse
import gc
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
WIDE_K = 200                   # K2/K4: past fold_select's 128-row pass
ALPHA = 1.07                   # data/corpus.py::zipf_corpus
Q_LEN = 5                      # data/corpus.py::zipf_queries
AVG_LEN = 170                  # Poisson mean giving ~120 unique tokens a doc
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12         # CUDA-core FP32 (FMA counted as 2)
EXACT_ATOL = 1e-4              # boards vs ScipyBM25 (different sum order)
ATOL, RTOL = 1e-4, 1e-6        # kernel vs twin on the card (atomics there)
# K1-K4's query columns held bitwise at full width: a CTA takes a group of
# 64 columns, a lane two of them
GROUP_TWIN_COLS = tuple(range(64))
# K6's: a CTA takes 64 columns, a lane two of them; 32 of each CTA's, one
# a lane (its first in even CTAs, its second in odd ones)
K6_TWIN_COLS = tuple(64 * c + 2 * j + c % 2 for c in range(4)
                     for j in range(32))
TOPK_BLOCK = 4096              # ops.topk's segment: K5's block
TOPK_ROW = 9000                # phase 2's K5 rows: ragged for 512 and 4096
TEXT_DOCS = 100_000            # BM25Retriever's text corpus (phase 6 cut)
WORD_LETTERS = "bcdfghjklmnpqrstvwxz"   # token id -> a word (phase 6)
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
# phase 7: the sparse substrate at two shapes of configs/egnn.py.
# ogb_products: 2,449,029 nodes, 61,859,140 edges (avg_degree 25 as an
# int gives 61,225,725), d_feat 100, 47 classes; EGNN's d_hidden 64
PRODUCTS = dict(n_nodes=2_449_029, avg_degree=25, d_feat=100, n_classes=47)
D_HIDDEN = 64
SEG_BLOCK = 512                # destination nodes a K7 block (the doc block)
SEG_TILE_P = 512               # ops.segment_sum_blocked's tile_p
K7_TWIN_BLOCKS = 8             # blocks held against the CPU twin
# minibatch_lg: Reddit's 232,965 nodes and 602 features, 41 classes; its
# 114,615,892 edges (as DGL and PyG publish it) are an average degree of
# ~492; 1,024 seeds sampled with fanouts (15, 10)
REDDIT = dict(n_nodes=232_965, avg_degree=492, d_feat=602, n_classes=41)
SAMPLE_SEEDS = 1024
FANOUTS = (15, 10)
K7_RTOL = 1e-4                 # K7 vs index_add_ (atomics: another order)
K8_RTOL = 1e-5                 # K8 vs F.embedding_bag (another order)
# phase 8: the micro-batching front-end over phase 3's retriever
FE_MAX_BATCH = 32              # ServingFrontend(max_batch=...)
FE_DEADLINE_S = 0.002          # ServingFrontend(batch_deadline_s=...)
FE_BURST = 4096                # single queries submitted at once
FE_PACED = 1024                # then paced at half the burst's QPS
FE_SAMPLES = 128               # requests held exact against ScipyBM25
FE_TIMEOUT_S = 300.0           # every future resolves within this
REGIME_KERNEL = {"gathered": "bm25_resident_score_topk",
                 "blocked": "bm25_block_score_topk",
                 "pruned": "bm25_resident_score_topk_pruned"}
# phase 9: K1/K3 past 512 rows, snapshots and reordering at full width
F3_K = 600                     # k past 512: resident blocks of 1,024 rows
F3_SAMPLES = 20                # sampled queries held exact a regime
# K1/K3's sampled query columns at 1,024 rows: both lanes' columns at the
# edges of each of the four CTA column groups
F3_TWIN_COLS = (0, 1, 62, 63, 64, 127, 128, 191, 192, 255)
SNAP_FAULT_DOCS = 65_536       # 9c's fault lanes (cut: the small run's depth)
SNAP_FAULTS = (("snapshot.write", "torn_write"),
               ("snapshot.manifest", "manifest_corrupt"),
               ("snapshot.manifest", "stale_version"),
               ("snapshot.array", "truncate"),
               ("snapshot.array", "bit_flip"))
REORDER_WIDTHS = (32, 256)     # 9d's pruned batches: phase 8's and phase 3's
# phase 10: the sharded step at world size 1 on the card, and the launcher
SHARD_AXES = ("data", "model")  # every mesh axis holds shards
SHARD_BATCHES = 2              # phase 3's first batches, served again
SHARD_SAMPLES = 10             # sampled queries held exact a board
SHARD_P_FLOOR = 1024           # sharded_retrieve_adaptive's first bucket
SERVE_RUNS = ((), ("--rescale", "2"))   # launcher flags past its defaults
SERVE_TIMEOUT_S = 240          # each launcher run
# phase 11: the recsys serving family at full width (configs/{dlrm_mlperf,
# autoint,sasrec,mind}.py): serve_p99, serve_bulk and retrieval_cand
RECSYS_ARCHS = ("dlrm-mlperf", "autoint", "sasrec", "mind")
DLRM_ROW_CAP = 2 ** 22         # rows a DLRM field keeps (cut: 96.1 GB in f32)
RECSYS_PAD_SHARE = 0.25        # history rows with a seeded left pad
RECSYS_REPS = 5                # timed runs a cell, after one warm-up
RECSYS_RTOL = RECSYS_ATOL = 1e-4   # serve_p99 logits, card vs CPU
# phase 12: LM serving at full width (configs/{gemma3_1b,mixtral_8x7b}.py)
LM_ARCH = "gemma3-1b"
MOE_ARCH = "mixtral-8x7b"
MOE_LAYERS = 2                 # Mixtral's depth (cut: 32 layers are 94 GB)
LM_PREFILL_B = 1               # prefill_32k's batch (cut from 32)
LM_WARM, LM_REPS, LM_MORE = 1, 5, 8   # decode steps: warm, timed, then on
LM_PREFILL_REPS = 3            # timed prefill calls, after one warm-up
LM_CHECK_PROMPT = 64           # tokens of the card-vs-CPU and prefill checks
LM_CHECK_STEPS = 4             # card-vs-CPU decode steps
LM_RTOL = LM_ATOL = 1e-3       # card vs CPU, f32 (TF32 off)
# prefill vs decode in bf16 on the card, each within this share of the
# tensor's largest entry: the last logits read 8.7e-4 there (2^-7: 9x
# room), the worst layer's K/V 8.7e-3 (2^-5: 3.6x room); PERF.md §6
LM_BF16_LOGITS_REL = 2.0 ** -7
LM_BF16_KV_REL = 2.0 ** -5
LM_GAP_ULPS = 4                # engine vs lockstep: a tie is a top-2 gap
                               # under 4 bf16 ulps of the top logit
ENGINE_SLOTS, ENGINE_MAX_SEQ, ENGINE_REQUESTS = 8, 1024, 16
ENGINE_PROMPT, ENGINE_NEW = (8, 200), (16, 64)   # drawn, ends included
ENGINE_LOCKSTEP = 4            # requests decoded again alone
MOE_CHECK_TOKENS = 64
MOE_RTOL = MOE_ATOL = 1e-4     # moe_block vs the per-token formula, f32
# phase 13: training at full width (train/, the three families' train cells)
TRAIN_STEPS = 4                # straight steps on a fixed batch (2 + 2 resumed)
TRAIN_LM_BATCH = 4             # train_4k's global batch (cut from 256)
DLRM_TRAIN_ROW_CAP = 2 ** 19   # rows a DLRM field keeps in training (cut)
PRODUCTS_TRAIN_EDGES = 2 ** 23  # ogb_products' edges in training (cut)
EGNN_BYTES_PER_EDGE = 4_800    # one EGNN layer's recompute + backward, f32
TRAIN_SMOKE_STEPS = 3          # card against CPU at each family's SMOKE
TRAIN_LOSS_RTOL = 1e-5         # losses, card vs CPU (f32, TF32 off)
TRAIN_GRAD_RTOL = 1e-4         # grads, card vs CPU: rtol, and atol as a
TRAIN_GRAD_ATOL_REL = 1e-6     # share of the leaf's largest |g|
TRAIN_PARAM_ATOL = 1e-5        # params: card vs CPU, M = 2 vs M = 1
TRAIN_BF16_GRAD_REL = 2.0 ** -5  # bf16 grads, M = 2 vs M = 1: share of max
TRAIN_SPLIT_GRAD_REL = 1e-5    # f32 grads at B = 65,536, M = 2 vs M = 1:
                               # sums of up to 3.3M terms in another order
BF16_OPS_PER_S = 989e12        # H100 SXM dense bf16, NVIDIA data sheet
PROBE_ROWS, PROBE_IDS, PROBE_D = 1 << 20, 1 << 23, 64   # repeatability probe


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


def device_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn()`` over ``reps`` calls back to
    back, queued behind a sleep on the device so that the host's enqueue
    (tens of microseconds a wrapper call, as long as K8's calls) is not in
    the time."""
    import torch
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)         # ~25 ms: the host queues ahead
    return cuda_ms(fn, reps)


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
            if b <= 64:
                # one column group and one CTA: the kernel walks the table
                # in order, as the twin does, and must skip what it skips
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
            # K6 on the same blocked layout and query table, all columns
            ops6 = (di.blk_tok, di.blk_loc, di.blk_sc,
                    torch.as_tensor(pk.uniq_tab), w)
            ref6 = k2.bm25_block_score(*ops6, block_size=DOC_BLOCK)
            got6 = k2.bm25_block_score(*(t.to(cuda) for t in ops6),
                                       block_size=DOC_BLOCK)
            torch.cuda.synchronize()
            oks.append(bits_equal(got6, ref6))
            print(f"[kernel-vs-twin] {method:9s} k={k:3d} B={b:2d} "
                  f"nf={fp.n_frags} sum_df={fp.sum_df} "
                  f"K3 twin skipped={int(ref[2])} card={int(got[2])} "
                  f"K1 bitwise={oks[0]} K2 bitwise={oks[1]} "
                  f"K3 bitwise={oks[2]} K3=K1 {oks[3]} "
                  f"device plan=host plan {oks[4]} K4 bitwise "
                  f"(per chunk and two-level, nc={gp.n_chunks}, "
                  f"p_pad={gp.p_pad}) {oks[5]} K6 bitwise {oks[6]}",
                  flush=True)
            check(all(oks), f"kernels bitwise equal to twins, device plan "
                            f"equal to host plan ({method}, k={k}, B={b})")
    print(f"[kernel-vs-twin] K3 with one CTA skipped {skipped} fragments "
          "over the cases of B <= 64, as its twin did", flush=True)
    check(skipped > 0, "K3 skipped spans on the card in phase 2")


def topk_rows(rng, n: int) -> dict:
    """Seeded ``[4, n]`` rows for K5: random, ties, all equal, rows of
    ``-inf`` and of ``-FLT_MAX`` (the last row of each with a few finite
    winners), ``+0.0`` mixed with ``-0.0``, denormals, and many ties at
    the k-th value (a few winners above one repeated value)."""
    rows = {"normal": rng.normal(size=(4, n)).astype(np.float32),
            "ties": rng.integers(-3, 4, size=(4, n)).astype(np.float32),
            "equal": np.full((4, n), 0.5, np.float32)}
    for kind, fill in (("-inf", -np.inf),
                       ("-FLT_MAX", np.finfo(np.float32).min)):
        x = np.full((4, n), fill, np.float32)
        x[-1, ::13] = 1.0
        rows[kind] = x
    x = np.where(rng.random((4, n)) < 0.5, 0.0, -0.0).astype(np.float32)
    x[:, ::97] = 1.0
    rows["+-0.0"] = x
    rows["denormals"] = (rng.integers(-5, 6, size=(4, n))
                         * np.float32(1e-45)).astype(np.float32)
    x = np.full((4, n), 2.5, np.float32)
    x[:, ::301] = rng.normal(5.0, 1.0, size=x[:, ::301].shape)
    x[:, 7::11] = -1.0
    rows["k-th ties"] = x
    return rows


def positions_distinct(pos) -> bool:
    """No position repeats in a row of K5's output (``-1`` pads apart)."""
    import torch
    k = pos.shape[1]
    real = torch.where(pos >= 0, pos.long(),
                       -2 - torch.arange(k, device=pos.device))
    return bool((torch.sort(real, dim=1).values.diff(dim=1) != 0).all())


def phase_topk_vs_twin(seed: int) -> None:
    """Phase 2, K5: the kernel on the card bitwise equal to its CPU twin
    on seeded rows of ``TOPK_ROW`` entries (a ragged last segment for both
    blocks), values and positions, every segment's positions distinct."""
    import torch

    from repro_torch.kernels import blockwise_topk as k5
    rows = topk_rows(np.random.default_rng(seed), TOPK_ROW)
    cuda = torch.device("cuda")
    for block in (512, TOPK_BLOCK):
        for k in (1, 7, 100, block):
            oks = {}
            for kind, x in rows.items():
                xt = torch.as_tensor(x)
                ref = k5.blockwise_topk(xt, k=k, block=block)
                got = k5.blockwise_topk(xt.to(cuda), k=k, block=block)
                torch.cuda.synchronize()
                oks[kind] = (bits_equal(got[0], ref[0])
                             and bits_equal(got[1], ref[1])
                             and positions_distinct(got[1]))
            print(f"[kernel-vs-twin] K5 block={block} k={k} rows of "
                  f"{TOPK_ROW} (last segment {TOPK_ROW % block}): bitwise "
                  f"and distinct {oks}", flush=True)
            check(all(oks.values()),
                  f"K5 bitwise equal to its twin (block={block}, k={k})")


def phase_k6_k7_vs_twins(seed: int) -> None:
    """Phase 2, K6 and K7 beyond the main path's shapes: K6 at B in {8,
    64, 100, 256} with a table of up to 1,280 rows, and at B = 256 with
    the widest table a batch packs (256 x Q_MAX rows), on the token-sorted
    blocked layout and on the same postings shuffled within each block
    (the kernel's path for any order); K7 at S = 10,000 and 50,000 (S cut
    into segment ranges). Each bitwise equal to its CPU twin."""
    import torch

    from repro_torch.core import BM25Params, build_index
    from repro_torch.kernels import block_segment_sum as k7
    from repro_torch.kernels import bm25_block_score as k2
    from repro_torch.sparse.block_csr import DeviceIndex
    rng = np.random.default_rng(seed + 16)
    cuda = torch.device("cuda")
    n_docs, n_vocab = 20_011, 30_000
    idx = build_index(zipf_corpus(rng, n_docs, n_vocab, 60), n_vocab,
                      params=BM25Params(method="lucene"))
    di = DeviceIndex.build(idx, device="cpu", block_size=DOC_BLOCK,
                           with_bmax=False)
    perm = torch.as_tensor(np.stack([rng.permutation(di.blk_tok.shape[1])
                                     for _ in range(di.blk_tok.shape[0])]))
    layouts = {"sorted": (di.blk_tok, di.blk_loc, di.blk_sc),
               "shuffled": tuple(torch.gather(t, 1, perm) for t in (
                   di.blk_tok, di.blk_loc, di.blk_sc))}
    for b, n_uniq in ((8, 40), (64, 320), (100, 500), (256, 1280),
                      (256, QUERY_BATCH * Q_MAX)):
        uniq = np.unique(np.concatenate(zipf_queries(rng, 4 * b, n_vocab)))
        uniq = uniq[:n_uniq]
        if uniq.size < n_uniq:      # the widest table a batch can pack:
            uniq = np.sort(rng.choice(n_vocab, n_uniq, replace=False))
            uniq[-n_uniq // 16:] = np.iinfo(np.int32).max   # its pad rows
        tab = torch.as_tensor(uniq.astype(np.int32))
        w = torch.as_tensor(rng.random((uniq.size, b)).astype(np.float32))
        oks = {}
        for name, blk in layouts.items():
            t0 = time.perf_counter()
            ops6 = (*blk, tab, w)
            ref = k2.bm25_block_score(*ops6, block_size=DOC_BLOCK)
            got = k2.bm25_block_score(*(t.to(cuda) for t in ops6),
                                      block_size=DOC_BLOCK)
            torch.cuda.synchronize()
            oks[name] = (bits_equal(got, ref),
                         round(time.perf_counter() - t0, 1))
        print(f"[kernel-vs-twin] K6 B={b} U={uniq.size} on {n_docs} docs: "
              f"bitwise, seconds {oks}", flush=True)
        check(all(ok for ok, _ in oks.values()),
              f"K6 bitwise equal to its twin (B={b}, U={uniq.size})")
    for s_len, d in ((10_000, 64), (50_000, 20)):
        vals = rng.normal(size=(3, 2048, d)).astype(np.float32)
        ids = rng.integers(0, s_len, size=(3, 2048)).astype(np.int32)
        ids[1].sort()                          # runs of a segment
        ids[:, ::7] = -1                       # dropped
        vals[:, 5::13] = 0.0                   # skipped rows of zeros
        vt, it = torch.as_tensor(vals), torch.as_tensor(ids)
        ref = k7.block_segment_sum(vt, it, num_segments=s_len, tile_p=512)
        got = k7.block_segment_sum(vt.to(cuda), it.to(cuda),
                                   num_segments=s_len, tile_p=512)
        torch.cuda.synchronize()
        ok = bits_equal(got, ref)
        print(f"[kernel-vs-twin] K7 S={s_len} D={d} (plan "
              f"{k7.column_tile(s_len, d)}): bitwise {ok}", flush=True)
        check(ok, f"K7 bitwise equal to its twin at S={s_len}")


def phase_k2_k4_vs_twins(seed: int) -> None:
    """Phase 2, K2 and K4 beyond the main path's shapes: K2 at B = 256
    with the widest table a batch packs (256 x Q_MAX = 8,192 rows), at
    k = 100 at blocks of 512, 700 and 1,024 rows (two windows of the walk
    past 512 rows, the board in device memory) and at k = WIDE_K at 512
    (two passes of the select); K4 at k = WIDE_K (``acc_block`` 512) and
    k = 600 (``acc_block`` 1,024, as ``DeviceRetriever`` sizes it) on a
    batch whose one chunk holds fewer real candidates than 600, per chunk
    and two-level. Each bitwise equal to its CPU twin, values and ids."""
    import torch

    from repro_torch.core import BM25Params, build_index
    from repro_torch.kernels import bm25_block_score as k2
    from repro_torch.kernels import bm25_gather_score as k1
    from repro_torch.serve import DeviceRetriever
    from repro_torch.sparse.block_csr import DeviceIndex, gather_posting_runs
    rng = np.random.default_rng(seed + 18)
    cuda = torch.device("cuda")
    n_docs, n_vocab = 20_011, 30_000
    idx = build_index(zipf_corpus(rng, n_docs, n_vocab, 60), n_vocab,
                      params=BM25Params(method="robertson"))
    uniq = np.sort(rng.choice(n_vocab, QUERY_BATCH * Q_MAX, replace=False))
    uniq[-QUERY_BATCH * Q_MAX // 16:] = np.iinfo(np.int32).max  # pad rows
    tab = torch.as_tensor(uniq.astype(np.int32))
    w = torch.as_tensor(rng.random((uniq.size, QUERY_BATCH))
                        .astype(np.float32))
    for bs, k in ((DOC_BLOCK, TOP_K), (DOC_BLOCK, WIDE_K), (700, TOP_K),
                  (1024, TOP_K)):
        t0 = time.perf_counter()
        di = DeviceIndex.build(idx, device="cpu", block_size=bs,
                               with_bmax=False)
        ops2 = (di.blk_tok, di.blk_loc, di.blk_sc, tab, w)
        kw2 = dict(block_size=bs, k=k, n_docs=n_docs)
        ref = k2.bm25_block_score_topk(*ops2, **kw2)
        got = k2.bm25_block_score_topk(*(t.to(cuda) for t in ops2), **kw2)
        torch.cuda.synchronize()
        ok = bits_equal(got[0], ref[0]) and bits_equal(got[1], ref[1])
        print(f"[kernel-vs-twin] K2 block={bs} B={QUERY_BATCH} "
              f"U={uniq.size} k={k} on {n_docs} docs "
              f"({di.blk_tok.shape[0]} blocks): bitwise {ok} "
              f"({time.perf_counter() - t0:.1f}s)", flush=True)
        check(ok, f"K2 bitwise equal to its twin (block {bs}, k {k}, U "
                  f"{uniq.size})")
    cpu = DeviceRetriever(idx, block_size=DOC_BLOCK, q_max=Q_MAX,
                          device="cpu")
    # three one-token queries of rare tokens: one chunk, mostly padding
    df = np.diff(idx.indptr)
    rare = rng.choice(np.flatnonzero((df >= 20) & (df <= 150)), 3,
                      replace=False)
    pk = cpu.pack_batch([np.array([t], np.int32) for t in rare])
    for acc_block, k in ((DOC_BLOCK, WIDE_K), (1024, 600)):
        gp = gather_posting_runs(idx, pk.uniq_batch, acc_block=acc_block,
                                 tile=64)
        check(gp.n_candidates < 600, "a chunk holds fewer than 600 real "
                                     "candidates")
        ops4 = tuple(torch.as_tensor(a) for a in (
            gp.token_ids, gp.slot_ids, gp.scores, pk.uniq_tab, pk.weights,
            gp.candidates))
        oks = {}
        for two_level in (False, True):
            kw4 = dict(acc_block=acc_block, k=k, two_level=two_level)
            ref = k1.bm25_gather_score_topk(*ops4, **kw4)
            got = k1.bm25_gather_score_topk(*(t.to(cuda) for t in ops4),
                                            **kw4)
            torch.cuda.synchronize()
            oks[two_level] = (bits_equal(got[0], ref[0])
                              and bits_equal(got[1], ref[1]))
        print(f"[kernel-vs-twin] K4 acc_block={acc_block} k={k} B={pk.b}: "
              f"{gp.n_candidates} candidates in {gp.n_chunks} chunks; "
              f"bitwise per chunk {oks[False]}, two-level {oks[True]}",
              flush=True)
        check(all(oks.values()), f"K4 bitwise equal to its twin at k = {k}")


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


def twin_bitwise(fn, ops, col_at, got, kw, what: str,
                 cols=GROUP_TWIN_COLS) -> bool:
    """The kernel's query columns ``cols`` against the wrapper on CPU
    copies of the same operands (so its twin runs) with only those columns
    of the operands at ``col_at`` (weights, bounds): bit for bit, the one
    output of a dense kernel, or a board's values and ids."""
    import torch
    t0 = time.perf_counter()
    cols = [c for c in cols if c < ops[col_at[0]].shape[1]]
    cpu = [t.cpu() for t in ops]
    for i in col_at:
        cpu[i] = cpu[i][:, cols].contiguous()
    ref = fn(*cpu, **kw)
    pairs = ([(got, ref)] if isinstance(got, torch.Tensor)
             else [(got[0], ref[0]), (got[1], ref[1])])
    ok = all(bits_equal(g[..., cols], r) for g, r in pairs)
    print(f"[kernels] {what}: {len(cols)} columns in {cols[0]}-{cols[-1]} "
          f"bitwise equal to the CPU twin: {ok} "
          f"({time.perf_counter() - t0:.1f}s)", flush=True)
    return ok


def timed_cuts(fn, ops, ms: float, kw, what: str, b: int) -> dict:
    """A board kernel's time at the main path's operands (``b`` query
    columns) beside the same call at k = 1 (the fold almost vanishes) and
    at k = WIDE_K (K2 and K4 select their boards in two passes), through
    the public wrapper."""
    cuts = {f"k{kw['k']}_b{b}": ms}
    for k in (1, WIDE_K):
        cuts[f"k{k}_b{b}"] = cuda_ms(lambda: fn(*ops, **dict(kw, k=k)),
                                     reps=3)
    print(f"[kernels] {what} split: " + "; ".join(
        f"{key} {t:.3f} ms" for key, t in cuts.items()), flush=True)
    return cuts


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


def sampled_exact(oracle, qs, res, rng, n: int, k: int = TOP_K) -> float:
    """``n`` sampled queries of a ``[B, k]`` result exact against the
    oracle: the score vector within ``EXACT_ATOL`` of the oracle's top-k,
    each id carrying its oracle score (ties may come in either order), no
    id repeated. Returns the largest |score - oracle| seen."""
    from repro_torch.core.retrieval import topk_numpy
    worst = 0.0
    for qi in rng.choice(len(qs), size=n, replace=False):
        s = oracle.score(qs[qi])
        _, ref_v = topk_numpy(s[None], k)
        np.testing.assert_allclose(res.scores[qi], ref_v[0], rtol=0,
                                   atol=EXACT_ATOL)
        np.testing.assert_allclose(s[res.ids[qi]], res.scores[qi], rtol=0,
                                   atol=EXACT_ATOL)
        check(len(set(res.ids[qi].tolist())) == k, "distinct ids")
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
    for name in RUNG_KERNEL.values():
        if name is not None:
            check(launches[name] > 0, f"{name} launched on the ladder path")
    return launches, shards, retrievers, host_qs


def word_table(n_vocab: int) -> np.ndarray:
    """A word for each token id: ``q`` and the id in base 20 over
    consonants, which the tokenizer keeps whole and distinct (no
    stopword, nothing to stem)."""
    letters = np.array(list(WORD_LETTERS))
    out = []
    for i in range(n_vocab):
        w = ""
        while True:
            i, r = divmod(i, len(letters))
            w = letters[r] + w
            if i == 0:
                break
        out.append("q" + w)
    return np.array(out)


def zipf_texts(rng, n_docs: int) -> tuple[list, list]:
    """The Zipf corpus and a batch of Zipf queries rendered as words."""
    words = word_table(N_VOCAB)
    docs = [" ".join(words[d]) for d in zipf_corpus(rng, n_docs, N_VOCAB,
                                                    AVG_LEN)]
    qs = [" ".join(words[q]) for q in zipf_queries(rng, QUERY_BATCH,
                                                   N_VOCAB)]
    return docs, qs


def board(ids, vals):
    """A ``[B, k]`` device board as the host result ``sampled_exact``
    reads."""
    from types import SimpleNamespace
    return SimpleNamespace(ids=ids.cpu().numpy(), scores=vals.cpu().numpy())


def phase_dense(dr, idx, oracle, rng) -> list:
    """Phase 6: the dense full-score path at full width.

    One batch of ``QUERY_BATCH`` queries through the unfused path
    ``ops.topk(ops.bm25_score_blocked(...))`` (K6, then K5) on the
    retriever's blocked layout, through ``score_batch`` + ``ops.topk`` on
    the eager scorer's ``DeviceIndex``, and ``BM25Retriever`` end to end
    from texts on ``TEXT_DOCS`` documents; the launch counts are read
    around those three. Then the checks and the timings. Returns the
    ``kernels`` entries of K5 and K6."""
    import torch

    from repro_torch.core import (BM25Retriever, ScipyBM25, pad_queries,
                                  score_batch, suggest_p_max)
    from repro_torch.core.scoring import DeviceIndex as ScoringIndex
    from repro_torch.kernels import COUNTERS, ops
    from repro_torch.kernels import blockwise_topk as k5
    from repro_torch.kernels import bm25_block_score as k2
    dev, n_docs, di = dr.device, dr.n_docs, dr.dindex
    qs = zipf_queries(rng, QUERY_BATCH, N_VOCAB)
    pk = dr.pack_batch(qs)
    tab = torch.as_tensor(pk.uniq_tab, device=dev)
    w = torch.as_tensor(pk.weights, device=dev)
    shift = torch.as_tensor(pk.shift, device=dev)
    blk = (di.blk_tok, di.blk_loc, di.blk_sc, tab, w)
    kwb = dict(block_size=DOC_BLOCK, n_docs=n_docs)
    t0 = time.perf_counter()
    sidx = ScoringIndex.from_host(idx, device=dev)
    toks, wts = pad_queries(qs, Q_MAX)
    p_max = suggest_p_max(idx, Q_MAX)
    torch.cuda.synchronize()
    t_sidx = time.perf_counter() - t0
    t0 = time.perf_counter()
    texts, text_qs = zipf_texts(rng, TEXT_DOCS)
    print(f"[dense] eager DeviceIndex uploaded in {t_sidx:.1f}s; p_max "
          f"{p_max} (suggest_p_max, q_max {Q_MAX}); {TEXT_DOCS} texts and "
          f"{QUERY_BATCH} text queries rendered in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)

    # -- the paths, with the launch counts read around them --------------
    for c in COUNTERS:
        c.reset()
    t0 = time.perf_counter()
    dense = ops.bm25_score_blocked(*blk, shift, **kwb)
    u_vals, u_ids = ops.topk(dense, TOP_K)
    torch.cuda.synchronize()
    unfused_first_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    sb, over = score_batch(sidx, toks, wts, p_max=p_max,
                           return_overflow=True)
    s_vals, s_ids = ops.topk(sb, TOP_K)
    torch.cuda.synchronize()
    eager_first_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    ret = BM25Retriever(method="lucene", k1=1.5, b=0.75).index(texts)
    torch.cuda.synchronize()
    t_text_index = time.perf_counter() - t0
    k5_before = k5.LAUNCHES.n
    t0 = time.perf_counter()
    r_ids, r_vals = ret.retrieve(text_qs, k=TOP_K)
    torch.cuda.synchronize()
    retriever_first_ms = (time.perf_counter() - t0) * 1e3
    launches = {c.name: c.n for c in COUNTERS}
    print(f"[dense] launches {launches}; first calls: unfused batch "
          f"{unfused_first_ms:.1f} ms, score_batch + topk "
          f"{eager_first_ms:.1f} ms, BM25Retriever index "
          f"{t_text_index:.1f}s ({ret.bm25_index.n_docs} docs, "
          f"{ret.bm25_index.nnz} postings, V {ret.bm25_index.n_vocab}), "
          f"retrieve {retriever_first_ms:.1f} ms (host clock)", flush=True)
    check(launches[k2.LAUNCHES_DENSE.name] > 0, "K6 launched on the path")
    check(launches[k5.LAUNCHES.name] >= 3, "K5 launched on every top-k")
    check(k5.LAUNCHES.n == k5_before + 1, "BM25Retriever took its top-k "
                                          "through K5")
    check(dense.shape == (QUERY_BATCH, n_docs) and sb.shape == dense.shape,
          "dense shapes")
    check(bool(torch.isfinite(dense).all()) and bool(
        torch.isfinite(sb).all()), "finite dense scores")

    # -- the unfused board against the fused K2 board and ScipyBM25 -------
    f_ids, f_vals = ops.bm25_retrieve_blocked(*blk, shift, k=TOP_K, **kwb)
    vals_same = bits_equal(u_vals, f_vals)
    # tie-aware: at every rank the two ids carry the same dense score
    ids_tied = bits_equal(dense.gather(1, u_ids.long()),
                          dense.gather(1, f_ids.long()))
    n_diff = int((u_ids != f_ids).sum())
    t0 = time.perf_counter()
    worst = sampled_exact(oracle, qs, board(u_ids, u_vals), rng, 20)
    print(f"[dense] unfused board vs the fused K2 board: values bitwise "
          f"equal {vals_same}; {n_diff} of {u_ids.numel()} ids differ, each "
          f"carrying the fused id's dense score {ids_tied}; 20 sampled "
          f"queries exact against ScipyBM25, max |score - oracle| "
          f"{worst:.3g} ({time.perf_counter() - t0:.1f}s)", flush=True)
    check(vals_same and ids_tied, "unfused board == fused board, "
                                  "tie-aware")
    # the fused batch's merge (K5 over segments of 4,096, then the rank
    # merge) against a full sort of K2's candidates by (score, doc id)
    from repro_torch.core.retrieval import rank_order
    c_v, c_loc = k2.bm25_block_score_topk(*blk, k=TOP_K, **kwb)
    nb = c_v.shape[0]
    flat_v = c_v.permute(2, 0, 1).reshape(QUERY_BATCH, nb * TOP_K)
    flat_i = (c_loc + (torch.arange(nb, dtype=torch.int32, device=dev)
                       * DOC_BLOCK)[:, None, None]
              ).permute(2, 0, 1).reshape(QUERY_BATCH, nb * TOP_K)
    del c_v, c_loc
    sel = rank_order(flat_v, flat_i)[:, :TOP_K]
    merge_same = (bits_equal(torch.gather(flat_i, 1, sel), f_ids)
                  and bits_equal(torch.gather(flat_v, 1, sel)
                                 + shift[:, None], f_vals))
    del sel
    topk_merge_ms = cuda_ms(lambda: ops.topk(flat_v, TOP_K))
    sort_merge_ms = cuda_ms(lambda: rank_order(flat_v, flat_i))
    print(f"[dense] the fused batch's merge of {QUERY_BATCH} x "
          f"{nb * TOP_K} candidates through ops.topk (K5, then the rank "
          f"merge) equals a full rank_order sort, ids and values bitwise: "
          f"{merge_same}; ops.topk {topk_merge_ms:.3f} ms, the sort "
          f"{sort_merge_ms:.3f} ms (CUDA events)", flush=True)
    check(merge_same, "the blocked merge through K5 == the full sort")
    del f_ids, f_vals, flat_v, flat_i

    # -- score_batch + ops.topk ---------------------------------------------
    t0 = time.perf_counter()
    again = score_batch(sidx, toks, wts, p_max=p_max)
    same_run = bits_equal(sb, again)
    del again
    rows = np.sort(rng.choice(QUERY_BATCH, size=8, replace=False))
    cpu_idx = ScoringIndex(*(t.cpu() for t in (sidx.indptr, sidx.doc_ids,
                                                 sidx.scores,
                                                 sidx.nonoccurrence)),
                           n_docs=sidx.n_docs, doc_offset=sidx.doc_offset)
    on_cpu = score_batch(cpu_idx, toks[rows], wts[rows], p_max=p_max)
    same_cpu = bits_equal(sb[torch.as_tensor(rows, device=dev)], on_cpu)
    del cpu_idx, on_cpu
    print(f"[dense] score_batch on the card: two runs bitwise equal "
          f"{same_run}; rows {rows.tolist()} bitwise equal to score_batch "
          f"on the CPU over the same arrays {same_cpu} "
          f"({time.perf_counter() - t0:.1f}s)", flush=True)
    check(same_run and same_cpu, "score_batch sums in one fixed order")
    diff = float((sb - dense).abs().max())
    worst = sampled_exact(oracle, qs, board(s_ids, s_vals), rng, 20)
    print(f"[dense] score_batch: overflow {int(over.sum())} of "
          f"{QUERY_BATCH}; max |score_batch - K6 dense| {diff:.3g} over all "
          f"{QUERY_BATCH} rows; 20 sampled boards exact against ScipyBM25, "
          f"max |score - oracle| {worst:.3g}", flush=True)
    check(not bool(over.any()), "no overflow under suggest_p_max")
    check(diff <= EXACT_ATOL, "score_batch rows within 1e-4 of K6's")

    # -- BM25Retriever from texts ---------------------------------------------
    t0 = time.perf_counter()
    ret_cpu = BM25Retriever(method="lucene", k1=1.5, b=0.75,
                            device="cpu").index(texts)
    c_ids, c_vals = ret_cpu.retrieve(text_qs, k=TOP_K)
    same_ret = bits_equal(r_ids, c_ids) and bits_equal(r_vals, c_vals)
    n_ties = int((r_vals[:, 1:] == r_vals[:, :-1]).sum())
    print(f"[dense] BM25Retriever on the card against the same retriever "
          f"built with device='cpu': ids and values bitwise equal "
          f"{same_ret} ({n_ties} tied neighbours on the boards; "
          f"{time.perf_counter() - t0:.1f}s)", flush=True)
    check(same_ret, "BM25Retriever boards bitwise equal to the CPU's")
    del ret_cpu, c_ids, c_vals
    t0 = time.perf_counter()
    t_oracle = ScipyBM25(ret.bm25_index)
    text_tok = ret.tokenizer.tokenize_queries(text_qs)
    worst = sampled_exact(t_oracle, text_tok, board(r_ids, r_vals), rng,
                          QUERY_BATCH)
    print(f"[dense] BM25Retriever: all {QUERY_BATCH} boards exact against "
          f"ScipyBM25 on the same tokens, max |score - oracle| {worst:.3g} "
          f"({time.perf_counter() - t0:.1f}s); n_docs "
          f"{ret.bm25_index.n_docs} % {TOPK_BLOCK} = "
          f"{ret.bm25_index.n_docs % TOPK_BLOCK} (ragged K5 segment)",
          flush=True)

    # -- K6 alone, its twins and its library call ---------------------------
    raw = k2.bm25_block_score(*blk, block_size=DOC_BLOCK)
    bitwise6 = twin_bitwise(k2.bm25_block_score, blk, (4,), raw,
                            dict(block_size=DOC_BLOCK), "K6",
                            cols=K6_TWIN_COLS)
    check(bitwise6, "K6 bitwise equal to its CPU twin at full width")
    check(bits_equal(raw.permute(2, 0, 1).reshape(QUERY_BATCH, -1)
                     [:, :n_docs] + shift[:, None], dense),
          "bm25_score_blocked = K6 laid out, cut and shifted")
    plain6 = k2.block_accumulate(*blk, block_size=DOC_BLOCK)
    plain6_ms = cuda_ms(lambda: k2.block_accumulate(*blk,
                                                    block_size=DOC_BLOCK))
    err6 = float((raw - plain6).abs().max())
    check(bool(torch.allclose(raw, plain6, atol=ATOL, rtol=RTOL)),
          f"K6 vs its twin on the card (max abs err {err6})")
    del plain6
    csr = oracle.matrix.tocsr()
    mat = torch.sparse_csr_tensor(
        torch.as_tensor(csr.indptr.astype(np.int64), device=dev),
        torch.as_tensor(csr.indices.astype(np.int64), device=dev),
        torch.as_tensor(csr.data, device=dev), size=csr.shape)
    del csr
    n_u = pk.uniq_batch.size
    wv = torch.zeros((N_VOCAB, w.shape[1]), dtype=torch.float32, device=dev)
    wv[torch.as_tensor(pk.uniq_batch, device=dev)] = w[:n_u]
    lib6 = torch.sparse.mm(mat, wv)
    # in turns: library, kernel, kernel, library
    turns6 = [cuda_ms(lambda: torch.sparse.mm(mat, wv), reps=3),
              cuda_ms(lambda: k2.bm25_block_score(*blk,
                                                  block_size=DOC_BLOCK),
                      reps=3)]
    turns6 += [cuda_ms(lambda: k2.bm25_block_score(*blk,
                                                   block_size=DOC_BLOCK),
                       reps=3),
               cuda_ms(lambda: torch.sparse.mm(mat, wv), reps=3)]
    ms6 = (turns6[1] + turns6[2]) / 2
    lib6_ms = (turns6[0] + turns6[3]) / 2
    lib6_err = float((lib6 - raw.reshape(-1, w.shape[1])[:n_docs])
                     .abs().max())
    print(f"[dense] K6 and torch.sparse.mm in turns (library, kernel, "
          f"kernel, library): {', '.join(f'{t:.3f}' for t in turns6)} ms; "
          f"K6 {'<=' if ms6 <= lib6_ms else '>'} torch.sparse.mm",
          flush=True)
    print(f"[dense] K6 {ms6:.3f} ms, twin on the card {plain6_ms:.1f} ms, "
          f"torch.sparse.mm of the [{n_docs}, {N_VOCAB}] CSR "
          f"({mat.values().numel()} nonzeros) by [{N_VOCAB}, "
          f"{w.shape[1]}] weights {lib6_ms:.3f} ms (max |sparse.mm - K6| "
          f"{lib6_err:.3g}, another sum order)", flush=True)
    del lib6, mat, wv
    hits = int(torch.isin(di.blk_tok, tab).sum())
    nbytes6 = (di.blk_tok.numel() * 12 + tab.numel() * 4 + w.numel() * 4
               + raw.numel() * 4)
    entry6 = dict(
        name=k2.LAUNCHES_DENSE.name, route="cuda",
        source="src/repro_torch/kernels/csrc/bm25_block_score.cu",
        replaces="src/repro/kernels/bm25_block_score.py:146",
        launches=launches[k2.LAUNCHES_DENSE.name], max_abs_err=err6,
        tolerance=f"atol {ATOL} + rtol {RTOL} vs the twin on the card "
                  "(atomics there)", twin_bitwise=bitwise6,
        twin_bitwise_at=("full width, query columns 64c + 2j + c % 2 "
                         "(c < 4, j < 32: every lane of every column-CTA),"
                         " CPU twin; phase 2: all columns, 20,011 docs, "
                         "B 8, 64, 100 and 256, U up to 8,192"),
        ms=ms6, plain_ms=plain6_ms, library_ms=lib6_ms,
        library="torch.sparse.mm (doc x token CSR by [V, B] weights)",
        bytes=nbytes6, ops=2.0 * hits * w.shape[1])
    del raw

    # -- K5 alone, its twin on the card and its library call ---------------
    bv, bp = k5.blockwise_topk(dense, k=TOP_K, block=TOPK_BLOCK)
    # in turns: library, kernel, kernel, library
    turns5 = []
    for fn in ("lib", "k5", "k5", "lib"):
        turns5.append(cuda_ms(
            (lambda: torch.topk(dense, TOP_K, dim=1)) if fn == "lib" else
            (lambda: k5.blockwise_topk(dense, k=TOP_K, block=TOPK_BLOCK)),
            reps=3))
    ms5 = (turns5[1] + turns5[2]) / 2
    lib5_ms = (turns5[0] + turns5[3]) / 2
    pv, pp = k5.blockwise_topk_plain(dense, k=TOP_K, block=TOPK_BLOCK)
    plain5_ms = cuda_ms(lambda: k5.blockwise_topk_plain(
        dense, k=TOP_K, block=TOPK_BLOCK))
    bitwise5 = bits_equal(bv, pv) and bits_equal(bp, pp)
    distinct5 = positions_distinct(bp)
    err5 = float((bv - pv).abs().nan_to_num(0.0).max())
    print(f"[dense] K5 and torch.topk in turns (library, kernel, kernel, "
          f"library): {', '.join(f'{t:.3f}' for t in turns5)} ms; K5 "
          f"{'<=' if ms5 <= lib5_ms else '>'} torch.topk", flush=True)
    print(f"[dense] K5 over [{bv.shape[0]}, {TOPK_BLOCK}] segments, k "
          f"{TOP_K}: {ms5:.3f} ms; bitwise equal to its twin on the card "
          f"{bitwise5} ({plain5_ms:.1f} ms); positions distinct "
          f"{distinct5}; torch.topk(dense, {TOP_K}, dim=1) {lib5_ms:.3f} ms",
          flush=True)
    check(bitwise5 and distinct5, "K5 bitwise equal to its twin at full "
                                  "width")
    entry5 = dict(
        name=k5.LAUNCHES.name, route="cuda",
        source="src/repro_torch/kernels/csrc/blockwise_topk.cu",
        replaces="src/repro/kernels/blockwise_topk.py:61",
        launches=launches[k5.LAUNCHES.name], max_abs_err=err5,
        tolerance="bitwise vs the twin on the card", twin_bitwise=bitwise5,
        twin_bitwise_at=(f"full width, [{bv.shape[0]}, {TOPK_BLOCK}] "
                         "segments, twin on the card; phase 2: CPU twin, "
                         "blocks 512 and 4096, k 1, 7, 100 and block"),
        ms=ms5, plain_ms=plain5_ms, library_ms=lib5_ms,
        library=f"torch.topk(dense, {TOP_K}, dim=1)",
        bytes=dense.numel() * 4 + bv.numel() * 8, ops=float(dense.numel()))
    del bv, bp, pv, pp

    # -- whole batches: unfused against fused, the eager scorer ------------
    def unfused():
        return ops.topk(ops.bm25_score_blocked(*blk, shift, **kwb), TOP_K)

    def fused():
        return ops.bm25_retrieve_blocked(*blk, shift, k=TOP_K, **kwb)

    del dense, sb
    f1, u1, u2, f2 = (cuda_ms(fused), cuda_ms(unfused), cuda_ms(unfused),
                      cuda_ms(fused))
    eager_ms = cuda_ms(lambda: score_batch(sidx, toks, wts, p_max=p_max))
    t0 = time.perf_counter()
    ret.retrieve(text_qs, k=TOP_K)
    torch.cuda.synchronize()
    retriever_ms = (time.perf_counter() - t0) * 1e3
    print(f"[dense] batch of {QUERY_BATCH} (CUDA events): fused "
          f"bm25_retrieve_blocked {f1:.1f}, {f2:.1f} ms; unfused "
          f"topk(bm25_score_blocked) {u1:.1f}, {u2:.1f} ms; score_batch "
          f"{eager_ms:.1f} ms; BM25Retriever.retrieve on {TEXT_DOCS} docs "
          f"{retriever_ms:.1f} ms (host clock, tokenizing included)",
          flush=True)
    del sidx
    return [entry5, entry6]


def blocked_by_destination(dst, n_nodes: int, gen):
    """K7's operands from a graph's destinations (on the card): edges
    sorted by destination and cut into blocks of ``SEG_BLOCK`` destination
    nodes, each block padded to the largest block's length rounded up to
    ``SEG_TILE_P`` (pads: id 0, value 0). Values are ``[nb, P, D_HIDDEN]``
    f32 messages drawn from ``gen``. Returns ``(values, ids, counts)``."""
    import torch
    dst = torch.sort(dst).values
    blk = dst // SEG_BLOCK
    nb = -(-n_nodes // SEG_BLOCK)
    counts = torch.bincount(blk, minlength=nb)
    p = -(-int(counts.max()) // SEG_TILE_P) * SEG_TILE_P
    starts = torch.cumsum(counts, 0) - counts
    slot = blk * p + torch.arange(dst.numel(), device=dst.device) - starts[blk]
    ids = torch.zeros((nb, p), dtype=torch.int32, device=dst.device)
    ids.view(-1)[slot] = (dst % SEG_BLOCK).to(torch.int32)
    pad = torch.ones((nb, p), dtype=torch.bool, device=dst.device)
    pad.view(-1)[slot] = False
    del dst, blk, slot, starts
    values = torch.empty((nb, p, D_HIDDEN), dtype=torch.float32,
                         device=ids.device).normal_(generator=gen)
    values.masked_fill_(pad[..., None], 0.0)
    return values, ids, counts


def sample_bags(graph, rng):
    """Hop-1 bags ``[SAMPLE_SEEDS, 15]`` and hop-2 bags ``[SAMPLE_SEEDS ·
    15, 10]`` of global node ids, by ``neighbor_sample``'s rule
    (``fanout_bags`` over ``Graph.csr()``); a hop-2 bag per hop-1 slot
    (all ``-1`` under a pad). Returns ``(hop1, hop2, csr_s, csr)``,
    ``csr_s`` the host seconds of the CSR ``csr``."""
    from repro_torch.data.graphs import fanout_bags
    t0 = time.perf_counter()
    indptr, src_idx = graph.csr()
    csr_s = time.perf_counter() - t0
    seeds = rng.choice(graph.n_nodes, size=SAMPLE_SEEDS, replace=False)
    hop1 = fanout_bags(indptr, src_idx, seeds, FANOUTS[0], rng=rng)
    hop2 = fanout_bags(indptr, src_idx, hop1.reshape(-1), FANOUTS[1],
                       rng=rng)
    return hop1, hop2, csr_s, (indptr, src_idx)


def mean_weights(bags: np.ndarray) -> np.ndarray:
    """GraphSAGE's mean as bag weights: ``1/k`` on a bag's ``k`` valid
    slots, 0 on its pads."""
    valid = bags >= 0
    k = np.maximum(valid.sum(1, keepdims=True), 1)
    return (valid / k).astype(np.float32)


def rel_err(got, ref) -> float:
    """``max |got - ref| / max |ref|``."""
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


def phase_sparse(seed: int, keep: dict | None = None) -> list:
    """Phase 7: the sparse substrate at full width, K7 and K8.

    K7 (``ops.segment_sum_blocked``) aggregates ``D_HIDDEN``-wide messages
    over the ogb_products graph blocked by destination; K8
    (``ops.embedding_bag``) takes the mean of Reddit's 602-wide feature
    rows over the hop-1 and hop-2 bags of a (15, 10) neighbour sample. The
    launch counts are read around those three calls; then each kernel is
    held bitwise against its CPU twin (K7 on the largest block and 7
    others, K8 on both bag sets), the whole output against the library
    call, and the kernel, its twin on the card and the library call are
    timed. Returns the ``kernels`` entries of K7 and K8. With ``keep``,
    ``keep["reddit"]`` gets phase 13's (15, 10) neighbour sample of the
    same Reddit graph (``reddit_train_sample``)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.data.graphs import random_graph
    from repro_torch.kernels import COUNTERS, ops
    from repro_torch.kernels import block_segment_sum as k7
    from repro_torch.kernels.embedding_bag import LAUNCHES as K8_LAUNCHES
    from repro_torch.kernels.embedding_bag import embedding_bag as k8
    from repro_torch.kernels.embedding_bag import (embedding_bag_plain,
                                                   load_width)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    rng = np.random.default_rng(seed + 7)

    # -- operands: ogb_products blocked by destination, Reddit's bags ----
    t0 = time.perf_counter()
    g = random_graph(**PRODUCTS, seed=seed)
    n_edges = g.edges.shape[0]
    t_products = time.perf_counter() - t0
    dst = torch.as_tensor(np.ascontiguousarray(g.edges[:, 1]), device=dev)
    del g
    values, ids, counts = blocked_by_destination(dst, PRODUCTS["n_nodes"],
                                                 gen)
    del dst
    torch.cuda.synchronize()
    nb, p, _ = values.shape
    t_k7_ops = time.perf_counter() - t0
    real = n_edges * D_HIDDEN * 4
    print(f"[sparse] K7 operands: ogb_products graph of "
          f"{PRODUCTS['n_nodes']} nodes and {n_edges} edges in "
          f"{t_products:.1f}s (host); {nb} blocks of {SEG_BLOCK} "
          f"destinations, P = {p} (largest block {int(counts.max())} "
          f"edges, mean {n_edges / nb:.0f}, smallest {int(counts.min())}); "
          f"values [{nb}, {p}, {D_HIDDEN}] f32: {values.numel() * 4} bytes "
          f"against {real} of real messages ({values.numel() * 4 / real:.2f}"
          f"x padding); {t_k7_ops:.1f}s in all", flush=True)
    t0 = time.perf_counter()
    gr = random_graph(**REDDIT, seed=seed)
    t_reddit = time.perf_counter() - t0
    hop1, hop2, csr_s, csr = sample_bags(gr, rng)
    if keep is not None:
        t1 = time.perf_counter()
        keep["reddit"] = reddit_train_sample(gr, csr, seed)
        print(f"[sparse] phase 13's (15, 10) sample of the Reddit graph in "
              f"{time.perf_counter() - t1:.1f}s (host)", flush=True)
    del csr
    table_cpu = torch.as_tensor(gr.node_feat)
    n_reddit_edges = gr.edges.shape[0]
    del gr
    table = table_cpu.to(dev)
    bags = []
    for bag in (hop1, hop2):
        w = mean_weights(bag)
        bags.append((torch.as_tensor(bag), torch.as_tensor(w),
                     torch.as_tensor(bag, device=dev),
                     torch.as_tensor(w, device=dev)))
    print(f"[sparse] K8 operands: Reddit graph of {REDDIT['n_nodes']} "
          f"nodes and {n_reddit_edges} edges in {t_reddit:.1f}s, its CSR "
          f"in {csr_s:.1f}s (host); "
          f"table [{table.shape[0]}, {table.shape[1]}] f32; bags "
          f"{list(hop1.shape)} ({int((hop1 < 0).sum())} pads) and "
          f"{list(hop2.shape)} ({int((hop2 < 0).sum())} pads), mean "
          f"weights; {time.perf_counter() - t0:.1f}s in all", flush=True)

    # -- the path, with the launch counts read around it -----------------
    for c in COUNTERS:
        c.reset()
    t0 = time.perf_counter()
    agg = ops.segment_sum_blocked(values, ids, num_segments=SEG_BLOCK,
                                  tile_p=SEG_TILE_P)
    means = [ops.embedding_bag(table, b_dev, w_dev)
             for _, _, b_dev, w_dev in bags]
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    launches = {c.name: c.n for c in COUNTERS}
    print(f"[sparse] launches {launches}; first calls {first_ms:.1f} ms "
          "(host clock)", flush=True)
    check(launches[k7.LAUNCHES.name] == 1, "K7 launched once on the path")
    check(launches[K8_LAUNCHES.name] == 2, "K8 launched twice on the path")
    check(agg.shape == (nb, SEG_BLOCK, D_HIDDEN)
          and bool(torch.isfinite(agg).all()), "K7 output shape, finite")
    for m, bag in zip(means, (hop1, hop2)):
        check(m.shape == (bag.shape[0], REDDIT["d_feat"])
              and bool(torch.isfinite(m).all()), "K8 output shape, finite")

    # -- K7: twin on the CPU, library call, times ------------------------
    t0 = time.perf_counter()
    largest = int(counts.argmax())
    sel = torch.as_tensor(np.concatenate([[largest], np.sort(rng.choice(
        np.flatnonzero(np.arange(nb) != largest), K7_TWIN_BLOCKS - 1,
        replace=False))]), device=dev)
    twin = k7.block_segment_sum(values[sel].cpu(), ids[sel].cpu(),
                                num_segments=SEG_BLOCK, tile_p=SEG_TILE_P)
    bitwise7 = bits_equal(agg[sel], twin)
    print(f"[sparse] K7 bitwise equal to its CPU twin on blocks "
          f"{sel.tolist()} (the largest first): {bitwise7} "
          f"({time.perf_counter() - t0:.1f}s)", flush=True)
    check(bitwise7, "K7 bitwise equal to its CPU twin at full width")
    gid = (ids.long() + torch.arange(nb, device=dev)[:, None]
           * SEG_BLOCK).view(-1)
    flat = values.view(-1, D_HIDDEN)
    lib = torch.zeros((nb * SEG_BLOCK, D_HIDDEN), device=dev)
    lib.index_add_(0, gid, flat)
    lib_err = rel_err(agg.view(-1, D_HIDDEN), lib)
    check(lib_err <= K7_RTOL, f"K7 within {K7_RTOL} of index_add_ "
                              f"(relative {lib_err:.3g})")
    plain = k7.block_segment_sum_plain(values, ids, num_segments=SEG_BLOCK,
                                       tile_p=SEG_TILE_P)
    err7 = float((agg - plain).abs().max())
    del plain
    ms7 = cuda_ms(lambda: ops.segment_sum_blocked(
        values, ids, num_segments=SEG_BLOCK, tile_p=SEG_TILE_P), reps=3)
    plain7_ms = cuda_ms(lambda: k7.block_segment_sum_plain(
        values, ids, num_segments=SEG_BLOCK, tile_p=SEG_TILE_P))
    lib7_ms = cuda_ms(lambda: lib.index_add_(0, gid, flat), reps=3)
    stages = k7.ring_stages(values.data_ptr(), p, D_HIDDEN, SEG_BLOCK,
                            values.element_size())
    print(f"[sparse] K7 {ms7:.3f} ms ({stages} ring stages); twin on the "
          f"card {plain7_ms:.3f} ms "
          f"(max |K7 - twin| {err7:.3g}, atomics there); "
          f"out.view(-1, {D_HIDDEN}).index_add_(0, global_ids, "
          f"values.view(-1, {D_HIDDEN})) {lib7_ms:.3f} ms (max |K7 - lib| / "
          f"max |lib| = {lib_err:.3g})", flush=True)
    entry7 = dict(
        name=k7.LAUNCHES.name, route="cuda",
        source="src/repro_torch/kernels/csrc/block_segment_sum.cu",
        replaces="src/repro/kernels/block_segment_sum.py:40",
        launches=launches[k7.LAUNCHES.name], max_abs_err=err7,
        tolerance=(f"bitwise vs the CPU twin on {K7_TWIN_BLOCKS} blocks; "
                   f"{K7_RTOL} relative vs index_add_ on the card"),
        twin_bitwise=bitwise7,
        twin_bitwise_at=(f"ogb_products, blocks {sel.tolist()}, CPU twin"),
        blocks=nb, p=p, edges=n_edges, ring_stages=stages, ms=ms7,
        plain_ms=plain7_ms,
        library_ms=lib7_ms,
        library=f"out.view(-1, {D_HIDDEN}).index_add_(0, global_ids, "
                f"values.view(-1, {D_HIDDEN}))",
        bytes=values.numel() * 4 + ids.numel() * 4 + agg.numel() * 4,
        ops=float(values.numel()))
    del values, ids, agg, lib, gid, flat
    gc.collect()
    torch.cuda.empty_cache()

    # -- K8: twin on the CPU, library call, times ------------------------
    calls = []
    for (b_cpu, w_cpu, b_dev, w_dev), got in zip(bags, means):
        t0 = time.perf_counter()
        twin = embedding_bag_plain(table_cpu, b_cpu, w_cpu)
        bitwise = bits_equal(got, twin)
        valid = b_dev >= 0
        safe = torch.where(valid, b_dev, 0).long()
        ref = F.embedding_bag(safe, table, per_sample_weights=w_dev * valid,
                              mode="sum")
        lerr = rel_err(got, ref)
        plain = embedding_bag_plain(table, b_dev, w_dev)
        err = float((got - plain).abs().max())
        w_lib = w_dev * valid

        def k8_call():
            return k8(table, b_dev, w_dev)

        def lib_call():
            return F.embedding_bag(safe, table, per_sample_weights=w_lib,
                                   mode="sum")

        ms = device_ms(k8_call, reps=10)
        pms = cuda_ms(lambda: embedding_bag_plain(table, b_dev, w_dev),
                      reps=3)
        lms = device_ms(lib_call, reps=10)
        # back to back as a caller's loop runs them: the host's enqueue
        # of each call is in these
        b2b = cuda_ms(k8_call, reps=10)
        lib_b2b = cuda_ms(lib_call, reps=10)
        n_valid = int(valid.sum())
        # each distinct row is read once, however many slots name it
        n_rows = int(torch.unique(b_dev[valid]).numel())
        bsz, fan = b_cpu.shape
        width = load_width(table.data_ptr(), got.data_ptr(), table.shape[1])
        calls.append(dict(bags=bsz, fanout=fan, valid=n_valid, width=width,
                          distinct_rows=n_rows, ms=ms, plain_ms=pms,
                          library_ms=lms, ms_back_to_back=b2b,
                          library_ms_back_to_back=lib_b2b, max_abs_err=err,
                          twin_bitwise=bitwise, library_rel_err=lerr,
                          bytes=bsz * fan * 8 + (n_rows + bsz)
                          * table.shape[1] * 4,
                          ops=2.0 * n_valid * table.shape[1]))
        print(f"[sparse] K8 [{bsz}, {fan}] bags ({n_valid} valid slots, "
              f"{n_rows} distinct rows; {width}-float loads): "
              f"bitwise equal to its CPU twin {bitwise} "
              f"({time.perf_counter() - t0:.1f}s); {ms:.4f} ms on the device "
              f"({b2b:.4f} back to back), twin on the card {pms:.4f} ms (max "
              f"|K8 - twin| {err:.3g}), F.embedding_bag(mode='sum', "
              f"per_sample_weights) {lms:.4f} ms on the device ({lib_b2b:.4f} "
              f"back to back; max |K8 - lib| / max |lib| = {lerr:.3g})",
              flush=True)
        check(bitwise, "K8 bitwise equal to its CPU twin at full width")
        check(lerr <= K8_RTOL, f"K8 within {K8_RTOL} of F.embedding_bag "
                               f"(relative {lerr:.3g})")
    entry8 = dict(
        name=K8_LAUNCHES.name, route="cuda",
        source="src/repro_torch/kernels/csrc/embedding_bag.cu",
        replaces="src/repro/kernels/embedding_bag.py:86",
        launches=launches[K8_LAUNCHES.name],
        max_abs_err=max(c["max_abs_err"] for c in calls),
        tolerance=(f"bitwise vs the twin (CPU and card); {K8_RTOL} relative "
                   "vs F.embedding_bag"),
        twin_bitwise=all(c["twin_bitwise"] for c in calls),
        twin_bitwise_at="Reddit table, hop-1 and hop-2 bags, CPU twin",
        library="F.embedding_bag(idx, table, per_sample_weights, "
                "mode='sum')",
        calls=[{k: v for k, v in c.items() if k not in ("bytes", "ops")}
               for c in calls],
        **{k: sum(c[k] for c in calls)
           for k in ("ms", "plain_ms", "library_ms", "bytes", "ops")})
    del table, bags, means
    return [entry7, entry8]


def percentiles_ms(xs) -> str:
    a = np.asarray(xs) * 1e3
    return (f"p50 {np.percentile(a, 50):.2f} ms, p99 "
            f"{np.percentile(a, 99):.2f} ms")


def phase_frontend(dr, oracle, rng, auto_served) -> dict:
    """Phase 8: ``auto``'s survivor estimate on the card against the host
    numpy one, then single queries through ``ServingFrontend`` over phase
    3's retriever, and its faults. Returns the launches of the front-end
    pass, by kernel."""
    import torch
    from types import SimpleNamespace

    from repro_torch.core.retrieval import plan_retrieval
    from repro_torch.kernels import COUNTERS
    from repro_torch.serve import (QueueOverflowError, ServingFrontend,
                                   StageFailedError)
    from repro_torch.serve.faults import inject_faults
    from repro_torch.sparse.block_csr import (TRANSFERS,
                                              estimate_prune_survivors,
                                              reset_transfer_stats)
    from repro_torch.sparse.fragment_device import estimate_survivors_device

    # -- the estimate: device against host on phase 3's auto batches --------
    bm = dr.dindex.bmax
    for n, (i, qs, res) in enumerate(auto_served):
        pk = dr.pack_batch(qs)
        t0 = time.perf_counter()
        f_host, ub_host = estimate_prune_survivors(
            bm, pk.uniq_tab, pk.weights, k=TOP_K, b_true=pk.b)
        host_ms = (time.perf_counter() - t0) * 1e3
        operands = (bm.device, bm.scale_dev,
                    torch.as_tensor(pk.uniq_tab, device=dr.device),
                    torch.as_tensor(pk.weights, device=dr.device))

        def on_card():
            return estimate_survivors_device(
                *operands, quantized=bm.quantized, k=TOP_K, b_true=pk.b)

        f_dev, ub_dev = on_card()
        dev_ms = cuda_ms(on_card, reps=5)
        regime = plan_retrieval(
            dr.dindex.sum_df(pk.uniq_batch), dr.dindex.nnz, regime="auto",
            crossover=dr.crossover, plan=dr.plan_mode,
            survivor_frac=f_host).regime
        # ub: an f64 sum over the batch's tokens cast to f32, by cuBLAS on
        # the card and by numpy on the host (another order): held bitwise,
        # the one ulp it may differ by counted and bounded
        a = ub_dev.cpu().numpy().view(np.int32).astype(np.int64)
        b = ub_host.view(np.int32).astype(np.int64)
        ulps = np.abs(a - b)
        print(f"[frontend] phase 3 auto batch {i}: survivor_frac card "
              f"{f_dev!r} host {f_host!r} served {res.plan.survivor_frac!r};"
              f" regime served {res.plan.regime}, by the host estimate "
              f"{regime}; ub [{ub_host.shape[0]}, {ub_host.shape[1]}] "
              f"entries differing by one f32 ulp {int((ulps == 1).sum())}, "
              f"by more {int((ulps > 1).sum())}; estimate at B = "
              f"{pk.weights.shape[1]}: card {dev_ms:.3f} ms (CUDA events, 5 "
              f"calls), host {host_ms:.1f} ms", flush=True)
        check(f_dev == f_host == res.plan.survivor_frac,
              "device survivor_frac == host survivor_frac")
        check(regime == res.plan.regime, "auto's regime == the host's")
        check(int(ulps.max()) <= 1, "device ub within one f32 ulp of host")

    # -- the front-end pass ------------------------------------------------
    qs_all = zipf_queries(rng, FE_BURST + FE_PACED, N_VOCAB)
    fe = ServingFrontend(dr, k=TOP_K, max_batch=FE_MAX_BATCH,
                         batch_deadline_s=FE_DEADLINE_S,
                         max_queue=FE_BURST, record_batches=True)
    reset_transfer_stats()
    for c in COUNTERS:
        c.reset()
    t0 = time.perf_counter()
    futs = [fe.submit(q) for q in qs_all[:FE_BURST]]
    rows = [f.result(timeout=FE_TIMEOUT_S) for f in futs]
    burst_s = time.perf_counter() - t0
    burst_qps = FE_BURST / burst_s
    gaps = rng.exponential(2.0 / burst_qps, size=FE_PACED)
    t0 = time.perf_counter()
    futs = []
    for q, at in zip(qs_all[FE_BURST:], np.cumsum(gaps)):
        wait = t0 + at - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        futs.append(fe.submit(q))
    paced = [f.result(timeout=FE_TIMEOUT_S) for f in futs]
    paced_s = time.perf_counter() - t0
    fe.close()
    launches = {c.name: c.n for c in COUNTERS}
    h = fe.health()
    mix: dict = {}
    for _, _, res in fe.recorded:
        mix[res.plan.regime] = mix.get(res.plan.regime, 0) + 1
    for name, part in (("burst", rows), ("paced", paced)):
        print(f"[frontend] {name}: latency_s "
              f"{percentiles_ms([r.latency_s for r in part])}; queue_s "
              f"{percentiles_ms([r.timings['queue_s'] for r in part])}",
              flush=True)
    print(f"[frontend] {FE_BURST} burst requests in {burst_s:.3f} s "
          f"({burst_qps:.1f} QPS), {FE_PACED} paced at "
          f"{burst_qps / 2:.1f} QPS offered in {paced_s:.3f} s "
          f"({FE_PACED / paced_s:.1f} QPS); {h['batches']} batches, mean "
          f"batch {h['mean_batch']:.2f}, flushes {h['flushes']}, regime mix "
          f"{mix}; served {h['served']} degraded {h['degraded']} faults "
          f"{h['faults']}; launches {launches}; posting bytes "
          f"{TRANSFERS.posting_bytes}, descriptor bytes "
          f"{TRANSFERS.descriptor_bytes}", flush=True)
    total = FE_BURST + FE_PACED
    check(h["served"] == h["submitted"] == total and h["pending"] == 0,
          "every front-end request served")
    check(h["faults"] == {} and h["degraded"] == 0,
          "no fault or degradation in the front-end pass")
    check(sum(len(r[0]) for r in fe.recorded) == total,
          "recorded batches hold every request")
    check(TRANSFERS.posting_bytes == 0 and TRANSFERS.descriptor_bytes == 0,
          "the front-end pass ships no posting or descriptor bytes")
    for regime in mix:
        check(launches[REGIME_KERNEL[regime]] > 0,
              f"{REGIME_KERNEL[regime]} launched in the front-end pass")
    check(launches["bm25_resident_score_topk"] > 0,
          "K1 launched in the front-end pass")

    # -- exactness: sampled requests, recorded batches replayed directly ----
    t0 = time.perf_counter()
    allrows = rows + paced
    board_all = SimpleNamespace(ids=np.stack([r.ids for r in allrows]),
                                scores=np.stack([r.scores for r in allrows]))
    worst = sampled_exact(oracle, qs_all, board_all, rng, FE_SAMPLES)
    same = all(boards_equal(res, dr.retrieve_batch(bq, kk))
               for bq, kk, res in fe.recorded)
    print(f"[frontend] {FE_SAMPLES} sampled requests exact against "
          f"ScipyBM25, max |score - oracle| {worst:.3g} (atol {EXACT_ATOL});"
          f" {len(fe.recorded)} recorded batches bitwise equal to direct "
          f"retrieve_batch calls {same} ({time.perf_counter() - t0:.1f}s)",
          flush=True)
    check(same, "front-end batches == direct retrieve_batch")

    # -- faults: former death, queue flood, close(drain=False) -------------
    few = qs_all[:8]
    with inject_faults({"site": "frontend.former", "kind": "thread_death",
                        "times": 1, "seed": 1}) as sp:
        fe = ServingFrontend(dr, k=TOP_K, max_batch=FE_MAX_BATCH,
                             batch_deadline_s=FE_DEADLINE_S,
                             record_batches=True)
        got = [f.result(timeout=FE_TIMEOUT_S)
               for f in [fe.submit(q) for q in few]]
        fe.close()
    recovered = (sp[0].fired == 1 and fe.health()["restarts"] == 1
                 and len(got) == len(few)
                 and all(boards_equal(res, dr.retrieve_batch(bq, kk))
                         for bq, kk, res in fe.recorded))
    fe = ServingFrontend(dr, k=TOP_K, max_batch=FE_MAX_BATCH,
                         batch_deadline_s=FE_DEADLINE_S, max_queue=64)
    with inject_faults({"site": "queue.flood", "kind": "flood", "times": 1,
                        "seed": 1, "guarded": False}) as sp:
        try:
            fe.submit(few[0])
            flood = None
        except QueueOverflowError as e:
            flood = e
    flood_ok = (flood is not None and sp[0].fired == 1
                and fe.health()["pending"] == 0
                and fe.submit(few[0]).result(timeout=FE_TIMEOUT_S)
                .ids.shape == (TOP_K,))
    fe.close()
    fe = ServingFrontend(dr, k=TOP_K, max_batch=64, batch_deadline_s=30.0)
    futs = [fe.submit(q) for q in few]
    fe.close(drain=False)
    aborted = [f.exception(timeout=FE_TIMEOUT_S) for f in futs]
    abort_ok = (all(isinstance(e, StageFailedError) and e.stage == "close"
                    for e in aborted) and fe.health()["aborted"] == len(few))
    print(f"[frontend] faults: frontend.former thread death recovered "
          f"{recovered}; queue.flood raised "
          f"{type(flood).__name__ if flood else None} {flood_ok}; "
          f"close(drain=False) failed {len(few)} pending futures with "
          f"StageFailedError {abort_ok}", flush=True)
    check(recovered, "frontend.former thread death recovers")
    check(flood_ok, "queue.flood raises QueueOverflowError")
    check(abort_ok, "close(drain=False) fails pending futures typed")
    return launches


def launch_counts() -> dict:
    from repro_torch.kernels import COUNTERS
    return {c.name: c.n for c in COUNTERS}


def phase_snapshot(dr, idx, oracle, rng, phase3, seed: int) -> dict:
    """Phase 9, on phase 3's retriever ``dr`` (``phase3``: its first
    batch's queries and board under each regime). Returns K1's and K3's
    times at 1,024 rows and the launches of the phase's serving calls."""
    import os
    import shutil
    import tempfile

    import torch

    from repro_torch.core import ScipyBM25, build_index
    from repro_torch.core.scoring import bucket_pow2
    from repro_torch.kernels import bm25_gather_score as k1
    from repro_torch.serve import DeviceRetriever, SnapshotVersionError
    from repro_torch.serve.faults import inject_faults
    from repro_torch.sparse import reorder, snapshot
    from repro_torch.sparse.block_csr import (TRANSFERS, DeviceIndex,
                                              reset_transfer_stats)
    from repro_torch.sparse.fragment_device import (block_bounds_device,
                                                    plan_fragments_device)

    di = dr.dindex
    dev = dr.device
    served = {name: 0 for name in launch_counts()}

    def serve(r, qs, k, regime=None):
        """One timed batch; its launches count as the phase's."""
        before = launch_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        res = r.retrieve_batch(qs, k, regime=regime)
        end.record()
        end.synchronize()
        for name, n in launch_counts().items():
            served[name] += n - before[name]
        check(res.ids.shape == (len(qs), k), "board shape")
        check(np.isfinite(res.scores).all(), "finite board")
        return res, start.elapsed_time(end)

    # -- 9a: K1/K3 past 512 rows at full width ------------------------------
    rows = bucket_pow2(F3_K, floor=DOC_BLOCK)
    qs = zipf_queries(rng, QUERY_BATCH, N_VOCAB)
    for regime in ("gathered", "pruned", "auto"):
        n0 = k1.LAUNCHES.n
        res, ms = serve(dr, qs, F3_K, regime)
        worst = sampled_exact(oracle, qs, res, rng, F3_SAMPLES, k=F3_K)
        p = res.plan
        print(f"[f3] regime={regime} k={F3_K} (resident blocks of {rows} "
              f"rows) chose={p.regime} frags_planned={p.frags_planned} "
              f"ms={ms:.1f}; {F3_SAMPLES} sampled queries exact, max "
              f"|score - oracle| {worst:.3g}", flush=True)
        if p.regime != "blocked":
            check(k1.LAUNCHES.n > n0, f"K1 served {regime} at k={F3_K}")
        if regime == "gathered":
            n_frags = p.frags_planned
    pk = dr.pack_batch(qs)
    w = torch.as_tensor(pk.weights, device=dev)
    desc, _, _ = plan_fragments_device(di, pk.uniq_tab,
                                       sum_df=di.sum_df(pk.uniq_batch),
                                       k=F3_K, block_size=rows)
    kw = dict(block_size=rows, frag=di.frag, k=F3_K, n_docs=idx.n_docs)
    ops1 = (desc, w, di.csc_doc_ids, di.csc_scores)
    got1 = k1.bm25_resident_score_topk(*ops1, **kw)
    k1_ms = cuda_ms(lambda: k1.bm25_resident_score_topk(*ops1, **kw), reps=3)
    ok1 = twin_bitwise(k1.bm25_resident_score_topk, ops1, (1,), got1, kw,
                       f"K1 at {rows} rows, k={F3_K}", cols=F3_TWIN_COLS)
    check(ok1, f"K1 bitwise equal to its twin at {rows} rows")
    # K3's bounds at 1,024 rows: the larger of each block's two 512-row
    # halves' bounds (still an upper bound of every document in it)
    bm = di.bmax
    ub = block_bounds_device(bm.device, bm.scale_dev,
                             torch.as_tensor(pk.uniq_tab, device=dev), w,
                             quantized=bm.quantized)
    per = rows // DOC_BLOCK
    ub = ub[:ub.shape[0] // per * per].reshape(-1, per, ub.shape[1])
    ops3 = (desc, w, ub.amax(1).contiguous(), di.csc_doc_ids,
            di.csc_scores)
    got3 = k1.bm25_resident_score_topk_pruned(*ops3, **kw)
    k3_ms = cuda_ms(lambda: k1.bm25_resident_score_topk_pruned(*ops3, **kw),
                    reps=3)
    ok3 = twin_bitwise(k1.bm25_resident_score_topk_pruned, ops3, (1, 2),
                       got3, kw, f"K3 at {rows} rows, k={F3_K}",
                       cols=F3_TWIN_COLS)
    check(ok3, f"K3 bitwise equal to its twin at {rows} rows")
    same = bits_equal(got3[0], got1[0]) and bits_equal(got3[1], got1[1])
    print(f"[f3] at {rows} rows, k={F3_K}, B={w.shape[1]}: K1 {k1_ms:.3f} "
          f"ms, K3 {k3_ms:.3f} ms ({int(got3[2])} fragments skipped, mean "
          f"over column groups; board bitwise equal to K1 {same}); "
          f"{desc.shape[1]} fragment slots", flush=True)
    check(same, "K3 board == K1 board at 1,024 rows")
    # the bound by phase 5's rule: each fragment descriptor, the weights,
    # each matched posting (doc id, score) and the board once; two FP32
    # operations a matched posting and query
    sum_df, b = di.sum_df(pk.uniq_batch), w.shape[1]
    t_bytes = (n_frags * 24 + w.numel() * 4 + sum_df * 8 + F3_K * b * 8) \
        / HBM_BYTES_PER_S * 1e3
    t_ops = 2.0 * sum_df * b / FP32_OPS_PER_S * 1e3
    rows_bound_ms = max(t_bytes, t_ops)
    print(f"[f3] bound at {rows} rows, k={F3_K}: {rows_bound_ms:.4f} ms by "
          f"{'bytes' if t_bytes >= t_ops else 'operations'} ({t_bytes:.4f} "
          f"ms of bytes, {t_ops:.4f} ms of FP32 operations; {n_frags} "
          f"fragments, sum_df {sum_df}, B = {b})", flush=True)
    del ops1, ops3, got1, got3, desc, ub

    # -- 9b: cold start from a snapshot at full width ------------------------
    def layouts(d):
        return (d.csc_doc_ids, d.csc_scores, d.blk_tok, d.blk_loc, d.blk_sc)

    layout_bytes = sum(t.numel() * t.element_size() for t in layouts(di))
    need = layout_bytes + bm.host.nbytes + bm.scale.nbytes \
        + 2 * (idx.indptr.nbytes + idx.nonoccurrence.nbytes
               + idx.doc_lens.nbytes)
    tmp = tempfile.mkdtemp(prefix="bm25s-snapshot-")
    try:
        free = shutil.disk_usage(tmp).free
        print(f"[snapshot] store under {tmp}: {free} bytes free, the store "
              f"takes about {need}", flush=True)
        check(free > need + (1 << 30), f"{free} bytes free for a store of "
              f"about {need}")
        t0 = time.perf_counter()
        manifest = dr.save(tmp)
        save_s = time.perf_counter() - t0
        with open(os.path.join(tmp, "CURRENT"), encoding="utf-8") as fh:
            gen = os.path.join(tmp, json.load(fh)["generation"])
        on_disk = sum(os.path.getsize(os.path.join(gen, f))
                      for f in os.listdir(gen))
        read_s = []
        real_read = snapshot._read_snapshot

        def timed_read(*a, **k):
            t = time.perf_counter()
            out = real_read(*a, **k)
            read_s.append(time.perf_counter() - t)
            return out

        snapshot._read_snapshot = timed_read
        try:
            reset_transfer_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cold_di = DeviceIndex.load(tmp, mmap=True, device="cuda")
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
        finally:
            snapshot._read_snapshot = real_read
        loaded_bytes = sum(t.numel() * t.element_size()
                           for t in layouts(cold_di))
        print(f"[snapshot] save {save_s:.2f} s, {on_disk} bytes on disk "
              f"(checksums {manifest['algo']}); cold start "
              f"DeviceIndex.load(mmap=True): read + verify {read_s[0]:.2f} "
              f"s, upload {load_s - read_s[0]:.2f} s, {load_s:.2f} s in "
              f"all; posting bytes uploaded {TRANSFERS.posting_bytes} "
              f"(layouts {loaded_bytes}), descriptor bytes "
              f"{TRANSFERS.descriptor_bytes}", flush=True)
        check(loaded_bytes == layout_bytes, "the loaded layouts' size")
        check(TRANSFERS.posting_bytes == loaded_bytes,
              "one posting upload per layout at the cold start")
        check(not cold_di.snapshot_report["hops"], "a clean store loads "
              "without a recovery hop")
        cold = DeviceRetriever(None, device_index=cold_di, q_max=Q_MAX)
        check(cold.regime == "auto" and cold.plan_mode == "device",
              "the cold-started retriever serves auto on the device plan")
        for regime in REGIMES:
            qs0, want = phase3[regime]
            res, ms = serve(cold, qs0, TOP_K, regime)
            same = boards_equal(res, want)
            print(f"[snapshot] cold start, regime={regime} "
                  f"chose={res.plan.regime} ms={ms:.1f}: board bitwise "
                  f"equal to phase 3's {same}", flush=True)
            check(same, f"cold-started {regime} board == phase 3's")
        reset_transfer_stats()
        serve(cold, zipf_queries(rng, QUERY_BATCH, N_VOCAB), TOP_K)
        print(f"[snapshot] second cold batch: posting bytes "
              f"{TRANSFERS.posting_bytes}, descriptor bytes "
              f"{TRANSFERS.descriptor_bytes}", flush=True)
        check(TRANSFERS.posting_bytes == 0 and TRANSFERS.descriptor_bytes == 0,
              "no posting or descriptor byte after the cold start")
        del cold, cold_di
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()

    # -- 9c: the snapshot fault lanes, at the small run's depth ---------------
    srng = np.random.default_rng(seed + 90)
    sidx = build_index(zipf_corpus(srng, SNAP_FAULT_DOCS, N_VOCAB, AVG_LEN),
                       N_VOCAB, params=idx.params)
    sdr = DeviceRetriever(sidx, block_size=DOC_BLOCK, q_max=Q_MAX,
                          device="cuda")
    sqs = zipf_queries(srng, QUERY_BATCH, N_VOCAB)
    want, _ = serve(sdr, sqs, TOP_K)
    sampled_exact(ScipyBM25(sidx), sqs, want, srng, 5)
    for site, kind in SNAP_FAULTS:
        path = tempfile.mkdtemp(prefix="bm25s-fault-")
        try:
            sdr.save(path)
            spec = {"site": site, "kind": kind, "times": 1, "seed": 7}
            raised = loaded = None
            if kind == "torn_write":
                with inject_faults(dict(spec, guarded=False)) as sp:
                    try:
                        sdr.save(path)
                    except OSError as e:
                        raised = e
                loaded = DeviceIndex.load(path, device="cuda")
            else:
                with inject_faults(spec) as sp:
                    try:
                        loaded = DeviceIndex.load(path, device="cuda")
                    except SnapshotVersionError as e:
                        raised = e
            check(sp[0].fired == 1, f"{kind} fired")
            check((raised is not None)
                  == (kind in ("torn_write", "stale_version")),
                  f"{kind}: only the torn save and the future version "
                  f"raise, typed")
            check((loaded is None) == (kind == "stale_version"),
                  f"{kind}: every other fault loads")
            if loaded is not None:
                res, _ = serve(DeviceRetriever(None, device_index=loaded,
                                               q_max=Q_MAX), sqs, TOP_K)
                same = boards_equal(res, want)
                check(same, f"{kind}: the recovered board is exact")
                hops = loaded.snapshot_report["hops"]
                check(not hops if kind == "torn_write" else bool(hops),
                      f"{kind}: the previous generation, or a recovery hop")
                check(kind != "manifest_corrupt" or "manifest<-dup" in hops,
                      "a corrupt manifest heals from its replica")
            print(f"[snapshot] fault {site}/{kind} at {SNAP_FAULT_DOCS} "
                  f"docs: raised {type(raised).__name__ if raised else None}"
                  + ("" if loaded is None else
                     f"; loaded with hops {loaded.snapshot_report['hops']},"
                     f" board bitwise equal to the saving retriever's "
                     f"{same}"), flush=True)
        finally:
            shutil.rmtree(path, ignore_errors=True)
    del sdr, sidx, loaded
    gc.collect()
    torch.cuda.empty_cache()

    # -- 9d: reordering at full width -------------------------------------------
    host_s = {}
    real = {n: getattr(reorder, n) for n in ("signature_permutation",
                                             "permute_index")}

    def timed(name):
        def run(*a, **k):
            t = time.perf_counter()
            out = real[name](*a, **k)
            host_s[name] = host_s.get(name, 0.0) + time.perf_counter() - t
            return out
        return run

    for name in real:
        setattr(reorder, name, timed(name))
    try:
        reset_transfer_stats()
        t0 = time.perf_counter()
        rdr = DeviceRetriever(idx, regime="auto", reorder="signature",
                              block_size=DOC_BLOCK, q_max=Q_MAX,
                              device="cuda")
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
    finally:
        for name, fn in real.items():
            setattr(reorder, name, fn)
    print(f"[reorder] DeviceRetriever(reorder='signature') at full width: "
          f"signature_permutation {host_s['signature_permutation']:.1f} s, "
          f"permute_index {host_s['permute_index']:.1f} s (host), build "
          f"{build_s:.1f} s in all; posting bytes uploaded "
          f"{TRANSFERS.posting_bytes}", flush=True)
    check(rdr.dindex.perm is not None, "the full-width index was reordered")
    for b in REORDER_WIDTHS:
        qsb = zipf_queries(rng, b, N_VOCAB)
        for name, r in (("unordered", dr), ("reordered", rdr)):
            serve(r, qsb, TOP_K, "pruned")       # the bucket grows once
            reset_transfer_stats()
            res, ms = serve(r, qsb, TOP_K, "pruned")
            p = res.plan
            worst = sampled_exact(oracle, qsb, res, rng, min(F3_SAMPLES, b))
            print(f"[reorder] {name} pruned B={b}: frags_planned="
                  f"{p.frags_planned} frags_pruned={p.frags_pruned} "
                  f"frags_skipped={p.frags_skipped} (K3) ms={ms:.1f} "
                  f"posting bytes {TRANSFERS.posting_bytes} descriptor "
                  f"bytes {TRANSFERS.descriptor_bytes}; "
                  f"{min(F3_SAMPLES, b)} sampled queries exact in client "
                  f"ids, max |score - oracle| {worst:.3g}", flush=True)
            check(TRANSFERS.posting_bytes == 0, f"{name} ships no postings")
            check(TRANSFERS.descriptor_bytes == 0,
                  f"{name} ships no descriptors")
    del rdr
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[snapshot] phase 9 launches {served}", flush=True)
    check(served[k1.LAUNCHES.name] > 0 and served[k1.LAUNCHES_PRUNED.name] > 0,
          "K1 and K3 launched in phase 9")
    return {"k1_rows_ms": k1_ms, "k3_rows_ms": k3_ms, "rows": rows,
            "rows_bound_ms": rows_bound_ms,
            "launches": served}


def boards_tie_equal(a_ids, a_vals, b_ids, b_vals) -> bool:
    """Two ``[B, k]`` boards equal up to ties: the scores within
    ``EXACT_ATOL`` position by position, and in every row the ids scoring
    more than ``EXACT_ATOL`` above the row's k-th score the same set (a
    document tied at the cut may be either)."""
    if not np.allclose(a_vals, b_vals, rtol=0, atol=EXACT_ATOL):
        return False
    for ia, va, ib, vb in zip(a_ids, a_vals, b_ids, b_vals):
        cut = min(va[-1], vb[-1]) + EXACT_ATOL
        if set(ia[va > cut].tolist()) != set(ib[vb > cut].tolist()):
            return False
    return True


def phase_sharded(idx, oracle, rng, phase3) -> dict:
    """Phase 10: the sharded step on ``torch.distributed`` at world size 1.

    One card can run one NCCL rank, so this is the step's plumbing and its
    local steps at full width, not a multi-card figure. (a) an NCCL group
    of one rank in this process (``file://`` rendezvous in a temporary
    directory) and ``make_mesh_from(device_type="cuda")``; (b)
    ``stack_shard_arrays([idx], ...)`` uploads phase 3's index; (c) the
    classic step (``score_batch`` + ``ops.topk``, K5) on phase 3's first
    batches at their exact largest ``query_posting_budget``, then at a
    small budget that must flag exactly the queries whose budget exceeds
    it; (d) ``sharded_retrieve_adaptive(gathered=True)`` from
    ``SHARD_P_FLOOR`` on the same batches, its bucket trail, ``p_used``
    and the device memory it took beside a ``[p_used, B]`` f32 buffer;
    (e) CUDA-event times of both steps and of the all-gather + merge;
    (f) ``python -m repro_torch.launch.serve`` on the card at its defaults
    (then with ``--rescale 2``). Every board is exact against
    ``ScipyBM25`` on sampled queries and tie-aware equal to phase 3's
    gathered board of its batch. Returns the launch counts of (c)-(d)."""
    import os
    import shutil
    import tempfile
    from types import SimpleNamespace

    import torch
    import torch.distributed as tdist

    from repro_torch.core import pad_queries, query_posting_budget
    from repro_torch.core import retrieval as rmod
    from repro_torch.core.scoring import batch_posting_budget, bucket_pow2
    from repro_torch.kernels import COUNTERS
    from repro_torch.kernels import blockwise_topk as k5
    from repro_torch.launch.mesh import make_mesh_from
    from repro_torch.sparse.block_csr import TRANSFERS, reset_transfer_stats

    def exact(qs, ids, vals, res3, what):
        worst = sampled_exact(oracle, qs, SimpleNamespace(
            ids=ids.cpu().numpy(), scores=vals.cpu().numpy()), rng,
            SHARD_SAMPLES)
        same = boards_tie_equal(ids.cpu().numpy(), vals.cpu().numpy(),
                                res3.ids, res3.scores)
        check(same, f"{what}: tie-aware equal to phase 3's gathered board")
        return (f"{SHARD_SAMPLES} sampled queries exact against ScipyBM25, "
                f"max |score - oracle| {worst:.3g}; tie-aware equal to "
                f"phase 3's gathered board {same}")

    torch.cuda.set_device(0)
    rdv = tempfile.mkdtemp(prefix="smoke-dist-")
    tdist.init_process_group("nccl", init_method=f"file://{rdv}/rdv",
                             rank=0, world_size=1)
    try:
        mesh = make_mesh_from(device_type="cuda")
        shape = dict(zip(mesh.mesh_dim_names, mesh.shape))
        print(f"[sharded] world size {tdist.get_world_size()} "
              f"({tdist.get_backend()}); make_mesh_from: {shape}",
              flush=True)
        check(shape == {"data": 1, "model": 1}, "a (1, 1) mesh")
        reset_transfer_stats()
        t0 = time.perf_counter()
        arrs, ndoc = rmod.stack_shard_arrays([idx], mesh, SHARD_AXES)
        torch.cuda.synchronize()
        print(f"[sharded] stack_shard_arrays: {time.perf_counter() - t0:.2f}"
              f" s, posting bytes uploaded {TRANSFERS.posting_bytes}, "
              f"ndoc_pad {ndoc}, local {tuple(arrs[1].to_local().shape)}, "
              f"placements {arrs[1].placements}", flush=True)
        check(ndoc == idx.doc_lens.size, "ndoc_pad = the shard's doc count")
        df = np.diff(idx.indptr)
        batches = []
        for qs, res3 in phase3[:SHARD_BATCHES]:
            toks, wts = pad_queries(qs, Q_MAX)
            need = np.where(toks >= 0, df[np.maximum(toks, 0)], 0).sum(1)
            check(int(need.max()) == query_posting_budget(idx, toks),
                  "per-query budgets")
            batches.append((qs, res3, toks, wts, need))

        for c in COUNTERS:
            c.reset()
        steps, times = {}, {}
        for i, (qs, res3, toks, wts, need) in enumerate(batches):
            p_max = int(need.max())
            fn = steps["classic", i] = rmod.make_sharded_retrieve(
                mesh, SHARD_AXES, p_max=p_max, k=TOP_K,
                n_docs_per_shard=ndoc, return_overflow=True)
            ids, vals, over = fn(arrs, toks, wts)
            check(ids.shape == (QUERY_BATCH, TOP_K), "board shape")
            check(bool(torch.isfinite(vals).all()), "finite board")
            check(not bool(over.any()), "no overflow at the exact budget")
            print(f"[sharded] classic batch={i} p_max={p_max}: "
                  f"{exact(qs, ids, vals, res3, 'classic')}", flush=True)
            steps["board", i] = (ids, vals, over)
            p_small = int(np.median(need))
            small = rmod.make_sharded_retrieve(
                mesh, SHARD_AXES, p_max=p_small, k=TOP_K,
                n_docs_per_shard=ndoc, return_overflow=True)
            over_small = small(arrs, toks, wts)[2].cpu().numpy()
            flagged = int(over_small.sum())
            print(f"[sharded] classic batch={i} at p_max={p_small}: "
                  f"{flagged} of {QUERY_BATCH} queries flagged, the host "
                  f"budget says {int((need > p_small).sum())}", flush=True)
            check(np.array_equal(over_small, need > p_small),
                  "the flags are exactly the queries over the budget")

        adaptive = rmod.sharded_retrieve_adaptive(
            mesh, SHARD_AXES, k=TOP_K, n_docs_per_shard=ndoc,
            p_floor=SHARD_P_FLOOR, gathered=True)
        for i, (qs, res3, toks, wts, need) in enumerate(batches):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            ids, vals, p_used = adaptive(arrs, toks, wts)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() - base
            sum_df = batch_posting_budget(idx, toks)
            buffer = p_used * QUERY_BATCH * 4
            print(f"[sharded] gathered batch={i}: bucket trail "
                  f"{adaptive.trail}, p_used={p_used} (sum_df {sum_df}), "
                  f"{wall:.2f} s; device memory above the step's inputs "
                  f"{peak} bytes (peak), a [p_used, B] f32 buffer would be "
                  f"{buffer} bytes; "
                  f"{exact(qs, ids, vals, res3, 'gathered')}", flush=True)
            check(p_used == bucket_pow2(sum_df, floor=SHARD_P_FLOOR),
                  "p_used is the first bucket covering the batch's sum_df")
            check(peak < buffer, "no [p_max, B] buffer")
            cids, cvals, _ = steps["board", i]
            check(boards_tie_equal(ids.cpu().numpy(), vals.cpu().numpy(),
                                   cids.cpu().numpy(), cvals.cpu().numpy()),
                  "gathered board == classic board (tie-aware)")
            steps["p_used", i] = p_used

        # (e) the steps and the merge, timed with CUDA events
        last = len(batches) - 1
        qs, res3, toks, wts, need = batches[last]
        times["classic"] = cuda_ms(lambda: steps["classic", last](
            arrs, toks, wts), reps=3)
        times["gathered"] = cuda_ms(lambda: adaptive(arrs, toks, wts),
                                    reps=3)
        check(adaptive.trail == [steps["p_used", last]],
              "steady traffic runs one bucket a call")
        ids, vals, over = steps["board", last]
        group = rmod._shard_group(mesh, SHARD_AXES)
        times["merge"] = cuda_ms(lambda: rmod._all_gather_merge(
            ids, vals, over, group, 1, TOP_K), reps=10)
        launches = {c.name: c.n for c in COUNTERS}
        print(f"[sharded] B={QUERY_BATCH} k={TOP_K}: classic step "
              f"{times['classic']:.1f} ms, gathered step (p_max "
              f"{steps['p_used', last]}) {times['gathered']:.1f} ms, "
              f"all-gather"
              f" + merge {times['merge']:.3f} ms (CUDA events, world size "
              f"1); launches {launches}", flush=True)
        check(launches[k5.LAUNCHES.name] > 0, "K5 launched in phase 10")
        del arrs, steps, adaptive, ids, vals, over
    finally:
        tdist.destroy_process_group()
        shutil.rmtree(rdv, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()

    # (f) the serving launcher on the card, at the reference's defaults
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    for extra in SERVE_RUNS:
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                            *extra], cwd=ROOT, env=env, capture_output=True,
                           text=True, timeout=SERVE_TIMEOUT_S)
        for line in r.stdout.strip().splitlines():
            print(f"[launch] {' '.join(extra) or 'defaults'}: {line}")
        print(f"[launch] exit {r.returncode} in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        if r.returncode != 0:
            print(r.stderr[-3000:], file=sys.stderr)
        check(r.returncode == 0, "the launcher exits 0")
        if "--rescale" not in extra:
            check(r.stdout.rstrip().endswith("degraded 0/100"),
                  "the launcher serves 100 queries, none degraded")
    return dict(launches=launches, times=times)


def recsys_inputs(cfg, specs, gen, *, serve: bool) -> dict:
    """A batch shaped like ``specs`` (the cell's ``meta`` tensors), drawn
    on the card from ``gen``: sparse ids within each field's vocabulary,
    normal dense features, click labels 0 or 1, item ids in [1, v) with
    left pads 0 on a
    ``RECSYS_PAD_SHARE`` of the history rows (and, for a serving cell,
    one all-pad row, the last)."""
    import torch
    dev = gen.device
    out = {}
    for key, spec in specs.items():
        shape = tuple(spec.shape)
        if key == "sparse":
            x = torch.stack([torch.randint(0, v, shape[:1], generator=gen,
                                           device=dev, dtype=torch.int32)
                             for v in cfg.vocab_sizes], dim=1)
        elif key == "dense":
            x = torch.randn(shape, generator=gen, device=dev)
        elif key == "labels":
            x = torch.randint(0, 2, shape, generator=gen, device=dev,
                              dtype=torch.int32)
        else:
            x = torch.randint(1, cfg.vocab_sizes[0], shape, generator=gen,
                              device=dev, dtype=torch.int32)
            if key == "history":
                b, l = shape
                padded = torch.rand(b, generator=gen, device=dev) \
                    < RECSYS_PAD_SHARE
                n_pad = torch.randint(1, l, (b,), generator=gen, device=dev)
                lead = torch.arange(l, device=dev)[None] < n_pad[:, None]
                x.masked_fill_(lead & padded[:, None], 0)
                if serve:
                    x[-1] = 0
        check(tuple(x.shape) == shape and x.dtype == spec.dtype,
              f"{key} made as its spec")
        out[key] = x
    return out


def recsys_candidates(cfg, n: int, gen):
    """``retrieval_cand``'s candidates: a seeded permutation of the item
    ids 1..n (sequence models), or uniform in field 0's vocabulary (CTR
    models, whose candidate takes field 0: AutoInt's 64 values tie)."""
    import torch
    if cfg.model in ("sasrec", "mind"):
        return (torch.randperm(n, generator=gen, device=gen.device)
                + 1).to(torch.int32)
    return torch.randint(0, cfg.vocab_sizes[0], (n,), generator=gen,
                         device=gen.device, dtype=torch.int32)


def recsys_on_cpu(cfg, params, batch):
    """The CPU's copy of a serving batch and its params. A CTR model's
    table comes across as the rows the batch reads alone, field by field
    (its ids re-indexed into them), so DLRM's 12.8 GB table is never
    copied."""
    from dataclasses import replace

    import torch

    from repro_torch.models.common import tree_map
    cpu = {k: v.cpu() for k, v in batch.items()}
    if "table" not in params:
        return cfg, tree_map(lambda t: t.cpu(), params), cpu
    offs = cfg.field_offsets()
    rows, cols, sizes = [], [], []
    for f in range(cfg.n_sparse):
        u, inv = torch.unique(batch["sparse"][:, f], return_inverse=True)
        rows.append(u.long() + int(offs[f]))
        cols.append(inv.to(torch.int32))
        sizes.append(int(u.numel()))
    p = tree_map(lambda t: t.cpu(),
                 {k: v for k, v in params.items() if k != "table"})
    p["table"] = params["table"][torch.cat(rows)].cpu()
    cpu["sparse"] = torch.stack(cols, dim=1).cpu()
    return replace(cfg, vocab_sizes=tuple(sizes)), p, cpu


def median_ms(fn) -> float:
    """Median CUDA-event milliseconds of ``RECSYS_REPS`` calls of ``fn``,
    after one untimed call."""
    fn()
    return float(np.median([cuda_ms(fn) for _ in range(RECSYS_REPS)]))


def one_rank_mesh():
    """The (1, 1) mesh of ``launch/mesh.py`` over an NCCL group of one
    rank (phases 11 and 12), and the group's rendezvous directory."""
    import tempfile

    import torch
    import torch.distributed as tdist

    from repro_torch.launch.mesh import make_mesh_from
    torch.cuda.set_device(0)
    rdv = tempfile.mkdtemp(prefix="smoke-mesh-")
    tdist.init_process_group("nccl", init_method=f"file://{rdv}/rdv",
                             rank=0, world_size=1)
    return make_mesh_from(device_type="cuda"), rdv


def phase_recsys(seed: int, mesh) -> dict:
    """Phase 11: the recsys serving family at full width on the card.

    For each of DLRM (its table cut to ``DLRM_ROW_CAP`` rows a field),
    AutoInt, SASRec and MIND: the cells from ``configs.get_cells`` built
    on ``mesh``, the (1, 1) mesh of ``launch/mesh.py`` (an NCCL group of
    one rank, :func:`one_rank_mesh`),
    params drawn on the card from a seeded generator, each cell's inputs
    drawn from its specs; ``serve_p99``, ``serve_bulk`` and
    ``retrieval_cand`` run (the last selects with ``ops.topk``: K5).
    Checks: every output finite; ``serve_p99``'s logits equal the same
    function on the CPU within ``RECSYS_RTOL``/``RECSYS_ATOL``;
    ``retrieval_cand``'s board bitwise equal to ``ops.topk`` on the
    scores copied to the CPU (K5's twin) and value-equal to
    ``torch.topk``, each id carrying its own score. Prints each cell's
    median ms, samples a second, peak device memory and FLOP share, and
    K5's launches and ms beside the scoring's. Returns the launch counts
    of the cells' own calls (the side timings excluded), and by arch the
    ms of K5 alone and of all of ``ops.topk``."""
    from dataclasses import replace

    import torch

    from repro_torch import configs
    from repro_torch.configs.common import recsys_cells
    from repro_torch.kernels import COUNTERS, ops
    from repro_torch.kernels import blockwise_topk as k5
    from repro_torch.models import recsys
    from repro_torch.models.common import tree_leaves

    dev = torch.device("cuda")
    k5_ms, topk_ms = {}, {}
    launches = {c.name: 0 for c in COUNTERS}

    def drive(run):
        """Run the cell's own calls with every count set to 0 just before
        and read just after, adding them to the phase's launches; the side
        timings of K5 and ``ops.topk`` stay outside this window."""
        for c in COUNTERS:
            c.reset()
        out = run()
        for c in COUNTERS:
            launches[c.name] += c.n
        return out, {c.name: c.n for c in COUNTERS}

    for a, arch in enumerate(RECSYS_ARCHS):
        t_arch = time.perf_counter()
        cfg = configs.get_config(arch)
        cells = [c for c in configs.get_cells(arch) if c.kind != "train"]
        if arch == "dlrm-mlperf":
            full = cfg
            cfg = replace(full, vocab_sizes=tuple(
                min(v, DLRM_ROW_CAP) for v in full.vocab_sizes))
            print(f"[recsys] CUT dlrm-mlperf: table rows "
                  f"{full.padded_rows:,} -> {cfg.padded_rows:,} "
                  f"({full.padded_rows * full.embed_dim * 4 / 1e9:.1f}"
                  f" -> {cfg.padded_rows * cfg.embed_dim * 4 / 1e9:.1f}"
                  f" GB in f32): the whole table does not fit the "
                  f"card's 80 GB; each field keeps at most "
                  f"{DLRM_ROW_CAP:,} rows; the 26 fields, dim 128, "
                  f"both MLPs and the interaction are kept", flush=True)
            cut = [c for c in recsys_cells(arch, cfg) if c.kind != "train"]
            check([c.key for c in cut] == [c.key for c in cells],
                  "the cut DLRM has the same cells")
            cells = cut
        gen = torch.Generator(device=dev).manual_seed(seed * 100 + a)
        t0 = time.perf_counter()
        params = recsys.init_params(gen, cfg, device=dev)
        torch.cuda.synchronize()
        print(f"[recsys] {arch}: params on the card in "
              f"{time.perf_counter() - t0:.2f} s, "
              f"{sum(t.numel() for t in tree_leaves(params)) * 4:,} "
              f"bytes", flush=True)
        for cell in cells:
            fn, args = cell.build(mesh)
            placed = cell.shardings(mesh, args)
            retrieval = cell.kind == "retrieval"
            batch = recsys_inputs(cfg, args[1], gen, serve=not retrieval)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            if retrieval:
                n = args[2].shape[0]
                cands = recsys_candidates(cfg, n, gen)
                (ms, (idx, vals)), n_cell = drive(lambda: (
                    median_ms(lambda: fn(params, batch, cands)),
                    fn(params, batch, cands)))
                k5_n = n_cell[k5.LAUNCHES.name]
                score_ms = median_ms(lambda: recsys.retrieval_scores(
                    cfg, params, batch, cands))
                scores = recsys.retrieval_scores(cfg, params, batch,
                                                 cands)
                topk_ms[arch] = median_ms(lambda: ops.topk(
                    scores, TOP_K, block=TOPK_BLOCK))
                k5_ms[arch] = median_ms(lambda: k5.blockwise_topk(
                    scores, k=TOP_K, block=TOPK_BLOCK))
                peak = torch.cuda.max_memory_allocated()
                check(bool(torch.isfinite(vals).all())
                      and bool(torch.isfinite(scores).all()),
                      f"{cell.key}: finite scores and board")
                tv, ti = ops.topk(scores.cpu(), TOP_K, block=TOPK_BLOCK)
                twin = bits_equal(idx, ti) and bits_equal(vals, tv)
                lib_v, _ = torch.topk(scores, TOP_K, dim=1)
                own = torch.equal(scores.gather(1, idx.long()), vals)
                distinct = idx.unique().numel() == TOP_K
                ties = int(torch.unique(vals).numel())
                share = cell.model_flops / (ms * 1e-3) / FP32_OPS_PER_S
                print(f"[recsys] {cell.key}: {ms:.3f} ms for {n:,} "
                      f"candidates ({n / ms * 1e3:,.0f} candidates/s); "
                      f"scoring {score_ms:.3f} ms, top-{TOP_K} "
                      f"(ops.topk) {topk_ms[arch]:.3f} ms, of which "
                      f"K5's launch alone {k5_ms[arch]:.3f} ms; {k5_n} "
                      f"K5 launches in the cell's own calls; peak "
                      f"{peak:,} bytes; FLOP share {share:.4f} of 67 "
                      f"TFLOP/s FP32; board bitwise K5's twin "
                      f"{twin}, values torch.topk's "
                      f"{torch.equal(lib_v, vals)}, each id its own "
                      f"score {own}, distinct {distinct}, "
                      f"{ties} distinct values", flush=True)
                check(k5_n > 0, f"{cell.key}: K5 launched")
                check(twin, f"{cell.key}: board == K5's twin, bitwise")
                check(torch.equal(lib_v, vals) and own and distinct,
                      f"{cell.key}: board tie-aware == torch.topk")
                del idx, vals, scores, cands, tv, ti, lib_v
            else:
                b = args[1][next(iter(args[1]))].shape[0]
                (ms, logits), _ = drive(lambda: (
                    median_ms(lambda: fn(params, batch)),
                    fn(params, batch)))
                peak = torch.cuda.max_memory_allocated()
                check(bool(torch.isfinite(logits).all()),
                      f"{cell.key}: finite logits")
                share = cell.model_flops / (ms * 1e-3) / FP32_OPS_PER_S
                line = (f"[recsys] {cell.key}: {ms:.3f} ms at B = {b:,} "
                        f"({b / ms * 1e3:,.0f} samples/s); peak "
                        f"{peak:,} bytes; FLOP share {share:.4f} of 67 "
                        f"TFLOP/s FP32; logits {tuple(logits.shape)}")
                if cell.shape == "serve_p99":
                    c_cfg, c_params, c_batch = recsys_on_cpu(
                        cfg, params, batch)
                    ref = recsys.forward(c_cfg, c_params, c_batch)
                    err = float((logits.cpu() - ref).abs().max())
                    close = torch.allclose(logits.cpu(), ref,
                                           rtol=RECSYS_RTOL,
                                           atol=RECSYS_ATOL)
                    line += (f"; against the CPU: max |diff| {err:.3g},"
                             f" within rtol/atol 1e-4 {close}")
                    check(close, f"{cell.key}: card == CPU")
                print(line, flush=True)
                del logits
            # the (1, 1) mesh: one placement a mesh dim, every argument
            check(len(tree_leaves(placed)) == 2 * len(tree_leaves(args)),
                  f"{cell.key}: placements for every argument")
            del batch
        del params
        gc.collect()
        torch.cuda.empty_cache()
        print(f"[recsys] {arch} done in "
              f"{time.perf_counter() - t_arch:.1f} s", flush=True)
    print(f"[recsys] phase 11 launches (the cells' own calls) "
          f"{launches}", flush=True)
    check(launches[k5.LAUNCHES.name] > 0, "K5 launched in phase 11")
    check(all(n == 0 for name, n in launches.items()
              if name != k5.LAUNCHES.name),
          "no kernel but K5 launched in phase 11")
    return dict(launches=launches, k5_ms=k5_ms, topk_ms=topk_ms)


def lm_cast(cfg, specs, gen):
    """``cfg``'s params drawn in f32 on the card from ``gen`` (the
    reference's ``init_params``), each cast to its spec's dtype (bf16 for
    a cell's; ``specs`` None keeps f32). Leaves are cast one at a time,
    so the f32 draw and the cast copy overlap by one leaf."""
    from repro_torch.models import transformer
    from repro_torch.models.common import tree_leaves
    params = transformer.init_params(gen, cfg, device=gen.device)
    if specs is None:
        return params
    for k, v in list(params.items()):
        if isinstance(v, dict):
            for kk in list(v):
                v[kk] = v[kk].to(specs[k][kk].dtype)
        else:
            params[k] = v.to(specs[k].dtype)
    for a, s in zip(tree_leaves(params), tree_leaves(specs)):
        check(tuple(a.shape) == tuple(s.shape) and a.dtype == s.dtype,
              "params made as the cell's specs")
    return params


def nbytes(tree) -> int:
    from repro_torch.models.common import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def lm_line(key, ms, tokens, peak, flops, what):
    """A cell's line: ms, tokens a second, peak device memory, FLOP share."""
    share = flops / (ms * 1e-3) / FP32_OPS_PER_S
    print(f"[lm] {key}: {ms:.3f} ms ({tokens / ms * 1e3:,.1f} tokens/s); "
          f"peak {peak:,} bytes; FLOP share {share:.4f} of 67 TFLOP/s FP32 "
          f"({flops:.4g} model FLOPs{what})", flush=True)
    return dict(ms=ms, tokens_s=tokens / ms * 1e3, peak=peak, share=share)


def lm_decode_cell_run(cell, params, gen, mesh, note=""):
    """``LM_WARM`` untimed steps, ``LM_REPS`` timed (the median kept),
    then ``LM_MORE`` more, so ``pos`` moves past the timed ones and every
    local ring keeps wrapping: the cell's own ``decode_step`` over a
    zeroed cache from the cells' ``pos = S``. Every logit finite, ``pos``
    counted on the device."""
    import torch

    from repro_torch.configs.common import LM_SHAPES
    from repro_torch.models import transformer
    fn, (params_s, cache_s, tok_s) = cell.build(mesh)
    placed = cell.shardings(mesh, (params_s, cache_s, tok_s))
    check(len(placed[1]["k"]) == len(cache_s["k"]),
          f"{cell.key}: a placement a cache layer")
    cfg = fn.args[0]
    b, seq = tok_s.shape[0], LM_SHAPES[cell.shape]["seq_len"]
    cache = transformer.init_decode_cache(cfg, b, seq, dtype=torch.bfloat16,
                                          device=gen.device)
    for a, s in zip(cache["k"] + cache["v"], cache_s["k"] + cache_s["v"]):
        check(a.shape == s.shape and a.dtype == s.dtype,
              f"{cell.key}: cache made as its specs")
    cache_bytes = nbytes({k: v for k, v in cache.items() if k != "pos"})
    n = LM_WARM + LM_REPS + LM_MORE
    toks = torch.randint(0, cfg.vocab_size, (n, b), generator=gen,
                         device=gen.device, dtype=torch.int32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state = {"i": 0, "cache": cache}

    def step():
        logits, state["cache"] = fn(params, state["cache"], toks[state["i"]])
        state["i"] += 1
        return logits

    finite = True
    for _ in range(LM_WARM):
        finite &= bool(torch.isfinite(step()).all())
    times = [cuda_ms(step) for _ in range(LM_REPS)]
    for _ in range(LM_MORE):
        logits = step()
        finite &= bool(torch.isfinite(logits).all())
    peak = torch.cuda.max_memory_allocated()
    ms = float(np.median(times))
    check(finite, f"{cell.key}: finite logits")
    check(tuple(logits.shape) == (b, cfg.vocab_size), f"{cell.key}: logits")
    check(int(state["cache"]["pos"]) == seq + n,
          f"{cell.key}: pos moved {n} steps past S")
    print(f"[lm] {cell.key}{note}: cache {cache_bytes:,} bytes "
          f"({', '.join(sorted({str(tuple(t.shape)) for t in cache['k']}))}"
          f" a layer's k and v), pos {seq} -> {seq + n}; steps "
          + ", ".join(f"{t:.3f}" for t in times) + " ms", flush=True)
    out = lm_line(cell.key + note, ms, b, peak, cell.model_flops,
                  f", B = {b}")
    out["cache_bytes"] = cache_bytes
    del state, cache, toks, logits
    return out


def lm_prefill_cell_run(cell, cut, params, gen, mesh):
    """``cell``'s prefill at ``cut``'s batch: one warm-up, then the median
    of ``LM_PREFILL_REPS`` timed calls; logits and K/V finite and shaped
    as the reference's."""
    import torch
    fn, (params_s, tok_s) = cell.build(mesh)
    cut_fn, (_, cut_tok) = cut.build(mesh)
    cfg = fn.args[0]
    b, s = cut_tok.shape
    check(cut_tok.shape[1] == tok_s.shape[1] and cut_fn.args == fn.args,
          f"{cell.key}: the cut keeps the sequence and the config")
    toks = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                         device=gen.device, dtype=torch.int32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    logits, kv = cut_fn(params, toks)                   # the warm-up
    shape = (cfg.n_layers, b, s, cfg.n_kv_heads, cfg.hd)
    check(bool(torch.isfinite(logits).all()) and all(
        tuple(kv[k].shape) == shape and bool(torch.isfinite(kv[k]).all())
        for k in ("k", "v")), f"{cell.key}: finite logits and K/V")
    check(tuple(logits.shape) == (b, cfg.vocab_size) and int(kv["pos"]) == s,
          f"{cell.key}: logits [B, V] and pos = S")
    del kv, logits
    times = [cuda_ms(lambda: cut_fn(params, toks))
             for _ in range(LM_PREFILL_REPS)]
    peak = torch.cuda.max_memory_allocated()
    ms = float(np.median(times))
    print(f"[lm] {cell.key}: calls " + ", ".join(f"{t:.1f}" for t in times)
          + " ms", flush=True)
    return lm_line(cell.key, ms, b * s, peak, cut.model_flops,
                   f", scaled to B = {b} from the cell's "
                   f"{tok_s.shape[0]}: {cell.model_flops:.4g}")


def top2_gap(logits):
    """Top-1 minus top-2 of each row (f32)."""
    import torch
    v = torch.topk(logits.float(), 2, dim=-1).values
    return v[..., 0] - v[..., 1]


def bf16_ulps(x: float) -> float:
    """One bf16 ulp at the magnitude of ``x`` (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(max(abs(x), 2.0 ** -126))) - 7)


def lm_card_vs_cpu(cfg, gen, prompt) -> dict:
    """Step 5: ``cfg`` in f32 at full width, params drawn on the card and
    copied to the host: ``prefill`` of ``prompt`` ([1, S]) and
    ``LM_CHECK_STEPS`` teacher-forced ``decode_step``s over a zeroed cache
    of S + ``LM_CHECK_STEPS`` positions from ``pos = 0``, card against CPU
    within ``LM_RTOL``/``LM_ATOL``; greedy ids equal wherever the CPU's
    top-2 gap exceeds ``LM_ATOL``. Returns the largest differences."""
    from dataclasses import replace

    import torch

    from repro_torch.models import transformer
    from repro_torch.models.common import tree_map
    c32 = replace(cfg, dtype=torch.float32)
    params = lm_cast(c32, None, gen)
    host = tree_map(lambda t: t.cpu(), params)
    s = prompt.shape[1]
    lg, kv = transformer.prefill(c32, params, prompt)
    lg_h, kv_h = transformer.prefill(c32, host, prompt.cpu())
    diffs = {"prefill": float((lg.cpu() - lg_h).abs().max()),
             "prefill_kv": max(float((kv[k].cpu() - kv_h[k]).abs().max())
                               for k in ("k", "v"))}
    ok = torch.allclose(lg.cpu(), lg_h, rtol=LM_RTOL, atol=LM_ATOL)
    del kv, kv_h
    caches = [transformer.init_decode_cache(c32, 1, s + LM_CHECK_STEPS,
                                            device=d)
              for d in (gen.device, torch.device("cpu"))]
    for c in caches:
        c["pos"] = torch.zeros_like(c["pos"])
    worst, ids_ok, near = 0.0, True, 0
    for t in range(LM_CHECK_STEPS):
        a, caches[0] = transformer.decode_step(c32, params, caches[0],
                                               prompt[:, t])
        b, caches[1] = transformer.decode_step(c32, host, caches[1],
                                               prompt[:, t].cpu())
        a = a.cpu()
        worst = max(worst, float((a - b).abs().max()))
        ok &= torch.allclose(a, b, rtol=LM_RTOL, atol=LM_ATOL)
        clear = top2_gap(b) > LM_ATOL
        near += int((~clear).sum())
        ids_ok &= bool((a.argmax(-1) == b.argmax(-1))[clear].all())
    diffs["decode"] = worst
    print(f"[lm] card vs CPU, {cfg.name} at full width in f32 "
          f"({nbytes(params):,} bytes of params copied to the host): "
          f"prefill of {s} tokens, max |logits diff| {diffs['prefill']:.3g}"
          f" (K/V {diffs['prefill_kv']:.3g}); {LM_CHECK_STEPS} decode steps "
          f"from pos 0, max |diff| {worst:.3g}; within rtol/atol "
          f"{LM_RTOL:g} {ok}; greedy ids equal {ids_ok} ({near} rows with "
          f"a CPU top-2 gap under {LM_ATOL:g})", flush=True)
    check(ok, "LM card == CPU within 1e-3 (f32)")
    check(ids_ok, "LM greedy ids card == CPU where the top-2 gap is clear")
    del params, host, caches
    return diffs


def rel_to_top(got, want) -> float:
    """max |got - want| over max |want|."""
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


def lm_prefill_vs_decode(cfg, params, prompt) -> dict:
    """Step 6: ``prompt`` teacher-forced through ``decode_step`` from an
    empty cache of S positions (``pos = 0``) on the card in bf16: the last
    logits equal ``prefill``'s, and every layer's cache rows its K/V (a
    window shorter than S: the positions its ring still holds), within
    ``LM_BF16_LOGITS_REL`` (logits) or ``LM_BF16_KV_REL`` (K/V) of the
    tensor's largest entry."""
    import torch

    from repro_torch.models import transformer
    s = prompt.shape[1]
    lg, kv = transformer.prefill(cfg, params, prompt)
    cache = transformer.init_decode_cache(cfg, 1, s, device=prompt.device)
    cache["pos"] = torch.zeros_like(cache["pos"])
    for t in range(s):
        dl, cache = transformer.decode_step(cfg, params, cache, prompt[:, t])
    r_logits = rel_to_top(dl, lg)
    r_kv = []
    for i in range(cfg.n_layers):
        # a ring of s_i slots holds the last s_i positions, p at p % s_i
        s_i = cache["k"][i].shape[1]
        p = torch.arange(s - s_i, s, device=prompt.device)
        r_kv.append(max(rel_to_top(cache[k][i][:, p % s_i], kv[k][i][:, p])
                        for k in ("k", "v")))
    same_id = bool((dl.argmax(-1) == lg.argmax(-1)).all())
    print(f"[lm] prefill vs decode, {cfg.name} bf16 on the card, {s} "
          f"tokens: last logits max |diff| / max |logit| {r_logits:.4g}, "
          f"K/V worst layer {max(r_kv):.4g} (layer {int(np.argmax(r_kv))}; "
          f"first {r_kv[0]:.4g}, last {r_kv[-1]:.4g}); bounds "
          f"{LM_BF16_LOGITS_REL:g} (logits), {LM_BF16_KV_REL:g} (K/V); "
          f"greedy id equal {same_id}", flush=True)
    check(r_logits <= LM_BF16_LOGITS_REL, "prefill logits == decode's (bf16)")
    check(max(r_kv) <= LM_BF16_KV_REL, "prefill K/V == decode's cache (bf16)")
    return dict(logits=r_logits, kv=max(r_kv))


def lm_engine_run(cfg, params, seed, device) -> dict:
    """Step 7: ``DecodeEngine`` (``ENGINE_SLOTS`` slots, ``ENGINE_MAX_SEQ``
    positions) over ``ENGINE_REQUESTS`` seeded requests; each finishes
    with ``max_new`` ids. ``ENGINE_LOCKSTEP`` of them decoded alone by a
    greedy lockstep ``decode_step`` at B = 1, teacher-forced with the
    engine's own ids: equal ids, except where the lockstep's top-2 gap is
    under ``LM_GAP_ULPS`` bf16 ulps of its top logit (counted)."""
    import torch

    from repro_torch.models import transformer
    from repro_torch.serve import DecodeEngine
    rng = np.random.default_rng(seed + 12)
    reqs = [(rng.integers(0, cfg.vocab_size,
                          int(rng.integers(*ENGINE_PROMPT, endpoint=True))
                          ).tolist(),
             int(rng.integers(*ENGINE_NEW, endpoint=True)))
            for _ in range(ENGINE_REQUESTS)]
    eng = DecodeEngine(cfg, params, n_slots=ENGINE_SLOTS,
                       max_seq=ENGINE_MAX_SEQ, device=device)
    rids = [eng.submit(p, max_new=m) for p, m in reqs]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps = 0
    while eng.queue or any(s.request_id is not None for s in eng.slots):
        eng.step()
        steps += 1
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    out = eng.finished
    check(set(out) == set(rids) and all(
        len(out[r]) == m for r, (_, m) in zip(rids, reqs)),
        "every engine request finishes with max_new ids")
    gen_tok = sum(m for _, m in reqs)
    fed = sum(len(p) + m - 1 for p, m in reqs)
    del eng
    mism = near = compared = 0
    for r, (prompt, m) in zip(rids[:ENGINE_LOCKSTEP], reqs):
        ids = out[r]
        feed = prompt + ids[:-1]
        cache = transformer.init_decode_cache(cfg, 1, ENGINE_MAX_SEQ,
                                              device=device)
        cache["pos"] = torch.zeros_like(cache["pos"])
        toks = torch.as_tensor(feed, dtype=torch.int32, device=device)
        for t in range(len(feed)):
            lg, cache = transformer.decode_step(cfg, params, cache,
                                                toks[t:t + 1])
            j = t - (len(prompt) - 1)
            if j < 0:
                continue
            compared += 1
            got = int(lg[0].argmax())
            if got != ids[j]:
                top = float(lg[0].max())
                if float(top2_gap(lg[0])) < LM_GAP_ULPS * bf16_ulps(top):
                    near += 1
                else:
                    mism += 1
    print(f"[lm] DecodeEngine, {cfg.name} bf16, {ENGINE_SLOTS} slots, "
          f"max_seq {ENGINE_MAX_SEQ}: {ENGINE_REQUESTS} requests (prompts "
          f"{min(len(p) for p, _ in reqs)}-{max(len(p) for p, _ in reqs)} "
          f"tokens, max_new {min(m for _, m in reqs)}-"
          f"{max(m for _, m in reqs)}) in {steps} steps, {sec:.3f} s: "
          f"{sec / steps * 1e3:.3f} ms a step, {gen_tok / sec:,.1f} "
          f"generated tokens/s, {fed / sec:,.1f} tokens/s fed; lockstep "
          f"B = 1 on {ENGINE_LOCKSTEP} requests: {compared} ids compared, "
          f"{near} differ under a top-2 gap of {LM_GAP_ULPS} bf16 ulps, "
          f"{mism} elsewhere (host clock)", flush=True)
    check(mism == 0, "engine ids == lockstep decode's (bf16 ties aside)")
    return dict(steps=steps, seconds=sec, ms_step=sec / steps * 1e3,
                tokens_s=gen_tok / sec, near=near, compared=compared)


def moe_vs_formula(cfg, params, gen) -> dict:
    """Step 8's check: layer 0's ``moe_block`` in f32 on
    ``MOE_CHECK_TOKENS`` tokens against ``Σ_k w_tk · expert_{e_tk}(x_t)``
    over the kept choices, on the card, within ``MOE_RTOL``/``MOE_ATOL``;
    the router's top-k ids, the kept mask and the slots equal the CPU's
    on the same router logits, exactly."""
    from dataclasses import replace

    import torch
    import torch.nn.functional as F

    from repro_torch.models import transformer
    c32 = replace(cfg, dtype=torch.float32)
    lp = {k: v[0].float() for k, v in params["layers"].items()}
    t = MOE_CHECK_TOKENS
    x = torch.randn((1, t, cfg.d_model), generator=gen, device=gen.device)
    y, aux = transformer.moe_block(c32, lp, x)
    logits = (x @ lp["router"]).float()               # moe_block's, [1, T, E]
    cap = transformer.moe_capacity(c32, t)
    _, w, idx, keep, slot = transformer.moe_route(c32, logits, cap)
    _, w_h, idx_h, keep_h, slot_h = transformer.moe_route(c32, logits.cpu(),
                                                          cap)
    same = (torch.equal(idx.cpu(), idx_h) and torch.equal(keep.cpu(), keep_h)
            and torch.equal(slot.cpu(), slot_h))
    xt = x[0]
    outs = torch.stack([
        (F.silu(xt @ lp["w_gate"][e]) * (xt @ lp["w_up"][e])) @ lp["w_down"][e]
        for e in range(cfg.n_experts)])                # [E, T, D]
    kept = keep.reshape(t, cfg.top_k)
    want = torch.zeros_like(xt)
    for j in range(cfg.top_k):
        e = idx[0, :, j]
        rows = outs[e, torch.arange(t, device=e.device)]
        want += (w[0, :, j] * kept[:, j])[:, None] * rows
    close = torch.allclose(y[0], want, rtol=MOE_RTOL, atol=MOE_ATOL)
    err = float((y[0] - want).abs().max())
    print(f"[lm] {cfg.name} layer 0 moe_block in f32 on {t} tokens: "
          f"capacity {cap}, {int(kept.sum())} of {t * cfg.top_k} choices "
          f"kept; max |diff| against the per-token formula {err:.3g}, within "
          f"rtol/atol {MOE_RTOL:g} {close}; route (top-{cfg.top_k} ids, kept,"
          f" slots) equal to the CPU's {same}; aux {float(aux):.4f}",
          flush=True)
    check(bool(torch.isfinite(y).all()), "moe_block finite")
    check(close, "moe_block == the per-token formula")
    check(same, "the router's integers == the CPU's")
    return dict(err=err, kept=int(kept.sum()))


def phase_lm(seed: int, mesh) -> dict:
    """Phase 12: LM serving at full width on the card.

    gemma3-1b's cells from ``configs.get_cells`` on the (1, 1) mesh:
    ``decode_32k`` (B = 128, 32,768 positions) and ``long_500k`` (B = 1,
    524,288), each warmed, timed (median of ``LM_REPS``) and stepped on;
    ``prefill_32k`` cut to B = 1; ``decode_32k`` over the int8 cache
    (``kv_quant``); then the card against the CPU in f32, prefill against
    decode in bf16 and the ``DecodeEngine``; then mixtral-8x7b at full
    width cut to ``MOE_LAYERS`` layers: ``prefill_32k`` at B = 1,
    ``decode_32k`` and layer 0's ``moe_block`` against its per-token
    formula. Params are drawn on the card from seeded generators and cast
    as the cells' specs say. Returns the phase's launch counts (all 0:
    the LM path reaches no kernel) and the cells' numbers."""
    from dataclasses import replace

    import torch

    from repro_torch import configs
    from repro_torch.configs.common import (LM_SHAPES, lm_cells,
                                            lm_decode_cell, lm_prefill_cell)
    from repro_torch.kernels import COUNTERS

    dev = torch.device("cuda")
    for c in COUNTERS:
        c.reset()
    res = {}
    with torch.inference_mode():
        t_arch = time.perf_counter()
        cfg = configs.get_config(LM_ARCH)
        cells = {c.shape: c for c in configs.get_cells(LM_ARCH)
                 if c.kind != "train"}
        check(sorted(cells) == ["decode_32k", "long_500k", "prefill_32k"],
              "gemma3-1b's serving cells")
        gen = torch.Generator(device=dev).manual_seed(seed * 100 + 12)
        specs = cells["decode_32k"].build(mesh)[1][0]
        params = lm_cast(cfg, specs, gen)
        print(f"[lm] {LM_ARCH}: {nbytes(params):,} bytes of bf16 params on "
              f"the card", flush=True)
        for shape in ("decode_32k", "long_500k"):
            res[shape] = lm_decode_cell_run(cells[shape], params, gen, mesh)
            torch.cuda.empty_cache()
        cell = cells["prefill_32k"]
        b_full = LM_SHAPES["prefill_32k"]["global_batch"]
        print(f"[lm] CUT {cell.key}: B = {b_full} -> {LM_PREFILL_B} at "
              f"{LM_SHAPES['prefill_32k']['seq_len']:,} tokens: the "
              f"reference's chunked_attention scores "
              f"every query chunk against all 32,768 keys in f32 in every "
              f"layer (114 TFLOP a sequence, >= 1.7 s at 67 TFLOP/s), and "
              f"at B = 32 the MLP activations (3 x 14.5 GB) and the stacked "
              f"K/V (2 x 14.0 GB) pass 80 GB", flush=True)
        seq = LM_SHAPES["prefill_32k"]["seq_len"]
        cut = lm_prefill_cell(LM_ARCH, cfg, batch=LM_PREFILL_B,
                              seq_len=seq, shape_name="prefill_32k")
        res["prefill_32k"] = lm_prefill_cell_run(cell, cut, params, gen,
                                                 mesh)
        torch.cuda.empty_cache()
        q = lm_decode_cell(LM_ARCH, replace(cfg, kv_quant=True),
                           batch=LM_SHAPES["decode_32k"]["global_batch"],
                           seq_len=LM_SHAPES["decode_32k"]["seq_len"],
                           shape_name="decode_32k")
        res["decode_32k_int8"] = lm_decode_cell_run(q, params, gen, mesh,
                                                    note=" (int8 KV)")
        torch.cuda.empty_cache()
        prompt = torch.randint(0, cfg.vocab_size, (1, LM_CHECK_PROMPT),
                               generator=gen, device=dev, dtype=torch.int32)
        res["card_vs_cpu"] = lm_card_vs_cpu(cfg, gen, prompt)
        torch.cuda.empty_cache()
        res["prefill_vs_decode"] = lm_prefill_vs_decode(cfg, params, prompt)
        res["engine"] = lm_engine_run(cfg, params, seed, dev)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        print(f"[lm] {LM_ARCH} done in {time.perf_counter() - t_arch:.1f} s",
              flush=True)

        t_arch = time.perf_counter()
        full = configs.get_config(MOE_ARCH)
        mcfg = replace(full, n_layers=MOE_LAYERS)
        full_cells = {c.shape: c for c in configs.get_cells(MOE_ARCH)
                      if c.kind != "train"}
        mcells = {c.shape: c for c in lm_cells(
            MOE_ARCH, mcfg, n_microbatches=1) if c.kind != "train"}
        check(sorted(mcells) == sorted(full_cells),
              "the cut Mixtral has the same cells")
        mgen = torch.Generator(device=dev).manual_seed(seed * 100 + 13)
        mspecs = mcells["decode_32k"].build(mesh)[1][0]
        print(f"[lm] CUT {MOE_ARCH}: depth {full.n_layers} -> {MOE_LAYERS} "
              f"layers ({nbytes(full_cells['decode_32k'].build(mesh)[1][0]):,}"
              f" -> {nbytes(mspecs):,} bytes of bf16 params: the whole model "
              f"does not fit the card's 80 GB); d_model {mcfg.d_model}, "
              f"{mcfg.n_heads} heads (kv {mcfg.n_kv_heads}), d_ff "
              f"{mcfg.d_ff}, {mcfg.n_experts} experts top-{mcfg.top_k}, "
              f"window {mcfg.sliding_window}, vocab {mcfg.vocab_size} kept",
              flush=True)
        mparams = lm_cast(mcfg, mspecs, mgen)
        mcut = lm_prefill_cell(MOE_ARCH, mcfg, batch=LM_PREFILL_B,
                               seq_len=seq, shape_name="prefill_32k")
        res["moe_prefill_32k"] = lm_prefill_cell_run(
            mcells["prefill_32k"], mcut, mparams, mgen, mesh)
        torch.cuda.empty_cache()
        res["moe_decode_32k"] = lm_decode_cell_run(
            mcells["decode_32k"], mparams, mgen, mesh)
        torch.cuda.empty_cache()
        res["moe_check"] = moe_vs_formula(mcfg, mparams, mgen)
        del mparams
        gc.collect()
        torch.cuda.empty_cache()
        print(f"[lm] {MOE_ARCH} done in {time.perf_counter() - t_arch:.1f} s",
              flush=True)
    launches = {c.name: c.n for c in COUNTERS}
    print(f"[lm] phase 12 launches {launches}", flush=True)
    check(all(n == 0 for n in launches.values()),
          "no kernel launched in phase 12: the LM path reaches none")
    return dict(launches=launches, cells=res)


def tree_bits_equal(a, b) -> bool:
    """Two trees of tensors with the same paths, dtypes, shapes and bits
    (NaN and the sign of zero included)."""
    import torch

    from repro_torch.models.common import tree_paths
    pa, pb = tree_paths(a), tree_paths(b)
    if [p for p, _ in pa] != [p for p, _ in pb]:
        return False

    def raw(x):
        return x.detach().reshape(-1).contiguous().view(torch.uint8)
    return all(x.dtype == y.dtype and x.shape == y.shape
               and x.device == y.device and torch.equal(raw(x), raw(y))
               for (_, x), (_, y) in zip(pa, pb))


def step_parts(step) -> dict:
    """What a train cell's step closes over (``make_train_step``'s
    ``loss_fn``, ``optimizer``, ``n_microbatches``, ``compress``), through
    the molecule cell's wrapper (which adds the static ``n_graphs``)."""
    free = dict(zip(step.__code__.co_freevars,
                    (c.cell_contents for c in step.__closure__)))
    if "base_step" in free:
        inner = step_parts(free["base_step"])
        inner["n_graphs"] = free["n_graphs"]
        return inner
    return free


def adam_slack(m1, lr: float, b1: float, tol=None):
    """How far AdamW's first step may move a param between two runs whose
    grads agree within ``tol`` = (rtol, atol as a share of the leaf's
    largest |g|; default ``TRAIN_GRAD_RTOL``, ``TRAIN_GRAD_ATOL_REL``): lr
    times the spread of its direction g / (|g| + eps) over those grads,
    g = ``m1`` / (1 - b1), the first moment after one step. ~0 where the
    grad's sign is held, up to 2 · lr where it is not (a grad within the
    tolerance of zero). Made in pieces of 2^24 elements (a leaf can be
    GBs)."""
    import torch
    rtol, atol_rel = tol or (TRAIN_GRAD_RTOL, TRAIN_GRAD_ATOL_REL)
    flat = m1.reshape(-1)
    atol = atol_rel * float(flat.abs().max()) / (1 - b1)
    out = torch.empty_like(flat, dtype=torch.float32)
    for lo in range(0, flat.numel(), 1 << 24):
        g = flat[lo:lo + (1 << 24)].float() / (1 - b1)
        t = rtol * g.abs() + atol
        hi_, lo_ = g + t, g - t
        out[lo:lo + (1 << 24)] = lr * (hi_ / (hi_.abs() + 1e-8)
                                       - lo_ / (lo_.abs() + 1e-8))
    return out.reshape(m1.shape)


def params_within(got, want, m1_want, lr: float, b1: float, *,
                  steps: int = 1, tol=None) -> tuple[float, int, int]:
    """``got`` against ``want`` (param trees on one device) after
    ``steps`` AdamW steps: every element within ``TRAIN_PARAM_ATOL`` but
    where AdamW's first step was not held to a sign by the grads
    (``adam_slack`` past the atol, from ``want``'s first moment ``m1_want``
    after its first step, with the grad tolerance ``tol``): there within
    ``2 · steps · lr``. Returns (the
    largest error outside that set, the largest inside it, the size of
    the set)."""
    from repro_torch.models.common import tree_paths
    worst_held, worst_free, n_free = 0.0, 0.0, 0
    moments = dict(tree_paths(m1_want))
    for (path, a), (_, b) in zip(tree_paths(got), tree_paths(want),
                                 strict=True):
        err = (a.float() - b.float()).abs()
        slack = adam_slack(moments[path], lr, b1, tol)
        free = slack > TRAIN_PARAM_ATOL
        if steps == 1:
            bound = TRAIN_PARAM_ATOL + slack
            check(bool((err <= bound).all()), f"{path}: within the grads' "
                  f"tolerance through AdamW's first step")
        n_free += int(free.sum())
        if (~free).any():
            worst_held = max(worst_held, float(err[~free].max()))
        if free.any():
            worst_free = max(worst_free, float(err[free].max()))
    check(worst_held <= TRAIN_PARAM_ATOL,
          f"params within {TRAIN_PARAM_ATOL:g} where the sign is held "
          f"({worst_held:.3g})")
    check(worst_free <= 2 * steps * lr, f"params within 2 · {steps} · lr "
          f"where it is not ({worst_free:.3g})")
    return worst_held, worst_free, n_free


def train_probe(seed: int) -> dict:
    """Which sums repeat on the card: ``index_add_`` (the port's segment
    sum before this slice), ``index_select``'s backward, the backward of
    ``table[ids]`` (advanced indexing: ``index_put_`` with accumulate),
    and the port's fixed-order ``segment_sum`` and ``gather_rows``'
    backward, each run twice on ``PROBE_IDS`` Zipf-skewed ids into
    ``PROBE_ROWS`` rows of ``PROBE_D`` f32 columns; the port's two also
    against the CPU, bitwise. Only the port's are held to it."""
    import torch

    from repro_torch.sparse.segment_ops import gather_rows, segment_sum
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed * 100 + 31)
    # Zipf-ish ids: a few rows take thousands of adds each
    u = torch.rand(PROBE_IDS, generator=gen, device=dev)
    ids = (PROBE_ROWS * u.pow(3.0)).long().clamp_max(PROBE_ROWS - 1)
    vals = torch.randn(PROBE_IDS, PROBE_D, generator=gen, device=dev)
    table = torch.randn(PROBE_ROWS, PROBE_D, generator=gen, device=dev)

    def index_add():
        return torch.zeros_like(table).index_add_(0, ids, vals)

    def gather_grad(fn, t, vals):
        t = t.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(fn(t), t, grad_outputs=vals)
        return g

    def grad_of(fn):
        return lambda: gather_grad(fn, table, vals)

    ops_ = {"index_add_": index_add,
            "index_select backward": grad_of(
                lambda t: t.index_select(0, ids)),
            "table[ids] backward (index_put_ accumulate)": grad_of(
                lambda t: t[ids]),
            "segment_sum": lambda: segment_sum(vals, ids, PROBE_ROWS),
            "gather_rows backward": grad_of(lambda t: gather_rows(t, ids))}
    out = {}
    for name, fn in ops_.items():
        a = fn()
        b = fn()
        torch.cuda.synchronize()
        diff = int((a.view(torch.int32) != b.view(torch.int32)).sum())
        out[name] = diff
        print(f"[train] repeatable on the card? {name}: "
              f"{'yes' if diff == 0 else 'no'} ({diff:,} of {a.numel():,} "
              f"elements differ between two runs)", flush=True)
        del a, b
    check(out["segment_sum"] == 0 and out["gather_rows backward"] == 0,
          "the port's fixed-order sums repeat bitwise on the card")
    n = PROBE_IDS // 16
    cpu_ids, cpu_vals = ids[:n].cpu(), vals[:n].cpu()
    same_seg = bits_equal(segment_sum(vals[:n], ids[:n], PROBE_ROWS),
                          segment_sum(cpu_vals, cpu_ids, PROBE_ROWS))
    same_gather = bits_equal(
        gather_grad(lambda t: gather_rows(t, ids[:n]), table, vals[:n]),
        gather_grad(lambda t: gather_rows(t, cpu_ids), table.cpu(),
                    cpu_vals))
    print(f"[train] the port's segment_sum and gather_rows backward on "
          f"{n:,} ids: bitwise the CPU's {same_seg}, {same_gather}",
          flush=True)
    check(same_seg and same_gather, "fixed-order sums: the card's bits are "
          "the CPU's")
    del vals, table, ids
    torch.cuda.empty_cache()
    return out


def train_smoke_cases():
    """The card-against-CPU cases: (name, init_params, cfg, loss_fn, numpy
    batch, static extras) at each family's SMOKE (f32): gemma3-1b and mixtral-8x7b
    (local/global attention, the MoE dispatch), the four recsys archs,
    EGNN's node readout over a graph with padding edges and its graph
    readout over molecules."""
    import functools
    from dataclasses import replace

    from repro_torch import configs
    from repro_torch.data.clicklogs import ctr_batches, seq_rec_batches
    from repro_torch.data.graphs import batched_molecules, random_graph
    from repro_torch.data.lm import lm_batches
    from repro_torch.models import egnn, recsys, transformer
    out = []
    for arch in ("gemma3-1b", "mixtral-8x7b"):
        cfg = configs.get_smoke(arch)
        out.append((arch, transformer.init_params, cfg,
                    functools.partial(transformer.loss_fn, cfg),
                    next(lm_batches(vocab_size=cfg.vocab_size, batch=4,
                                    seq_len=32, seed=1)), {}))
    for arch in RECSYS_ARCHS:
        cfg = configs.get_smoke(arch)
        if cfg.model in ("dlrm", "autoint"):
            b = next(ctr_batches(vocab_sizes=cfg.vocab_sizes,
                                 n_dense=cfg.n_dense, batch=16, seed=1))
        else:
            b = next(seq_rec_batches(n_items=cfg.vocab_sizes[0],
                                     seq_len=cfg.seq_len, batch=16, seed=1,
                                     per_position=cfg.model == "sasrec"))
        out.append((arch, recsys.init_params, cfg,
                    functools.partial(recsys.loss_fn, cfg), b, {}))
    cfg = configs.get_smoke("egnn")
    g = random_graph(64, 4, d_feat=cfg.d_feat, n_classes=cfg.n_out, seed=1)
    pad = np.full((8, 2), -1, np.int32)
    out.append(("egnn-node", egnn.init_params, cfg,
                functools.partial(egnn.loss_fn, cfg), {
        "node_feat": g.node_feat, "coords": g.coords,
        "edges": np.concatenate([g.edges.astype(np.int32), pad]),
        "labels": g.labels.astype(np.int32)}, {}))
    cfgg = replace(cfg, readout="graph", n_out=1, d_feat=11)
    mb = batched_molecules(8, n_nodes=10, n_edges=16, seed=1)
    n_graphs = mb.pop("n_graphs")
    mb["edges"] = np.concatenate([mb["edges"], pad])
    out.append(("egnn-graph", egnn.init_params, cfgg,
                functools.partial(egnn.loss_fn, cfgg), mb,
                {"n_graphs": n_graphs}))
    return out


def train_card_vs_cpu(seed: int) -> dict:
    """Each family's SMOKE (f32, TF32 off) trained ``TRAIN_SMOKE_STEPS``
    steps on the CPU and twice on the card from the same params and
    batch: the card's two runs bitwise equal; the first step's grads
    within ``TRAIN_GRAD_RTOL`` / ``TRAIN_GRAD_ATOL_REL`` · max |g| of the
    CPU's; every step's loss within ``TRAIN_LOSS_RTOL``; the params within
    ``TRAIN_PARAM_ATOL`` after the first step and after the last
    (``params_within``)."""
    import torch

    from repro_torch.models.common import tree_map, tree_paths
    from repro_torch.train import AdamW, init_train_state, make_train_step
    from repro_torch.train.step import value_and_grad

    dev = torch.device("cuda")
    res = {}
    for i, (name, init, cfg, loss_fn, nb, extra) in enumerate(
            train_smoke_cases()):
        p_cpu = init(torch.Generator().manual_seed(seed + i), cfg,
                     device="cpu")
        b_cpu = dict({k: torch.as_tensor(v) for k, v in nb.items()},
                     **extra)
        b_dev = dict({k: torch.as_tensor(v, device=dev)
                      for k, v in nb.items()}, **extra)
        opt = AdamW(lr=1e-3)
        step = make_train_step(loss_fn, opt)
        (l_cpu, _), g_cpu = value_and_grad(loss_fn, p_cpu, b_cpu)
        (l_dev, _), g_dev = value_and_grad(
            loss_fn, tree_map(lambda t: t.to(dev), p_cpu), b_dev)
        worst_g = 0.0
        for (path, a), (_, w) in zip(tree_paths(g_dev), tree_paths(g_cpu)):
            a, top = a.cpu(), float(w.abs().max())
            err = (a - w).abs() - TRAIN_GRAD_RTOL * w.abs()
            check(bool((err <= TRAIN_GRAD_ATOL_REL * top).all()),
                  f"{name} {path}: grad on the card within tolerance")
            worst_g = max(worst_g, float(((a - w).abs()).max() / max(
                top, 1e-30)))
        runs = {}
        for where in ("cpu", "card", "card again"):
            d = torch.device("cpu") if where == "cpu" else dev
            p = tree_map(lambda t: t.to(d), p_cpu)
            s = init_train_state(p, opt)
            b = b_cpu if where == "cpu" else b_dev
            losses, first = [], None
            for k in range(TRAIN_SMOKE_STEPS):
                p, s, m = step(p, s, b)
                losses.append(float(m["loss"]))
                if k == 0:
                    first = (tree_map(lambda t: t.cpu(), p),
                             tree_map(lambda t: t.cpu(), s["m"]))
            runs[where] = (p, s, losses, first)
        same = tree_bits_equal(runs["card"][:2], runs["card again"][:2])
        check(same, f"{name}: two runs on the card bitwise equal")
        lc, ld = np.array(runs["cpu"][2]), np.array(runs["card"][2])
        check(bool(np.all(np.abs(ld - lc) <= TRAIN_LOSS_RTOL * np.abs(lc))),
              f"{name}: losses on the card within rtol "
              f"{TRAIN_LOSS_RTOL:g} of the CPU's ({ld} vs {lc})")
        check(abs(float(l_dev) - float(l_cpu)) <= TRAIN_LOSS_RTOL * abs(
            float(l_cpu)), f"{name}: loss before the first step")
        m1 = runs["cpu"][3][1]
        held1 = params_within(runs["card"][3][0], runs["cpu"][3][0], m1,
                              opt.lr, opt.b1)
        last = params_within(tree_map(lambda t: t.cpu(), runs["card"][0]),
                             runs["cpu"][0], m1, opt.lr, opt.b1,
                             steps=TRAIN_SMOKE_STEPS)
        res[name] = dict(losses_cpu=runs["cpu"][2],
                         losses_card=runs["card"][2], grad_rel=worst_g,
                         step1=held1, last=last, repeat=same)
        print(f"[train] card vs CPU {name} (SMOKE, f32): losses card "
              f"{[f'{x:.6f}' for x in ld]} CPU {[f'{x:.6f}' for x in lc]} "
              f"(max rel {float(np.max(np.abs(ld - lc) / np.abs(lc))):.2e});"
              f" grads max |card - CPU| / max |g| {worst_g:.2e}; params "
              f"after step 1 max err {held1[0]:.2e} where AdamW's sign is "
              f"held ({held1[2]} elements not held, max {held1[1]:.2e}); "
              f"after step {TRAIN_SMOKE_STEPS} {last[0]:.2e} ({last[1]:.2e});"
              f" two card runs bitwise {same}", flush=True)
    return res


def train_cell_run(key: str, step, make_state, batch, *, flops: float,
                   peak: float, peak_name: str, units: int, unit: str,
                   alt_step=None, compress_step=None, grad_tol=None
                   ) -> dict:
    """One train cell at full width on the card.

    ``make_state(compress=False)`` draws the cell's params afresh from a
    fixed seed (the same bits each call) and its optimizer state. Run B,
    through ``train.loop.run_training`` with a checkpoint directory:
    ``TRAIN_STEPS // 2`` steps from a fresh state and a checkpoint (the
    peak device memory is read over it). Run A: ``TRAIN_STEPS`` steps of
    ``step`` on the same fixed ``batch``, each timed (CUDA events), the
    loss required to fall, its state at ``TRAIN_STEPS // 2`` bitwise
    equal to run B's (two runs from one seed). Run C: a fresh state that
    ``run_training`` resumes from run B's checkpoint to ``TRAIN_STEPS``,
    bitwise equal to run A's final state (auto-resume is exact). The
    steps are functional, so a state is kept by keeping its tensors, on
    the card. ``alt_step`` (the cell's step with the other microbatch
    count), from a fresh state, against run A's first step: its first
    moment (its clipped grads) within ``grad_tol`` (rtol, atol as a share
    of the leaf's largest; default the f32 ``TRAIN_GRAD_RTOL``,
    ``TRAIN_GRAD_ATOL_REL``) and its params by ``params_within``;
    ``compress_step`` (int8 with error feedback) from a fresh state: its
    loss is run A's first loss and its params finite."""
    import itertools
    import os
    import shutil
    import tempfile

    import torch

    from repro_torch.models.common import tree_paths
    from repro_torch.train.checkpoint import (latest_complete_step,
                                              load_checkpoint)
    from repro_torch.train.loop import LoopConfig, run_training
    opt = step_parts(step)["optimizer"]
    half_steps = TRAIN_STEPS // 2
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    print(f"[train] {key}: {before / 1e9:.2f} GB on the card before the "
          f"cell", flush=True)
    torch.cuda.reset_peak_memory_stats()
    tmp = tempfile.mkdtemp(prefix="train-ckpt-")
    try:
        batches = itertools.repeat(batch)
        t0 = time.perf_counter()
        got_half = run_training(step, make_state(), batches, LoopConfig(
            total_steps=half_steps, ckpt_dir=tmp, ckpt_every=half_steps,
            log_every=TRAIN_STEPS))
        t_b = time.perf_counter() - t0
        peak_mem = torch.cuda.max_memory_allocated() - before
        ckpt_bytes = sum(os.path.getsize(os.path.join(r, f))
                         for r, _, fs in os.walk(tmp) for f in fs)

        params, state = make_state()
        losses, times, first, repeat = [], [], None, None
        for i in range(TRAIN_STEPS):
            out = {}
            times.append(cuda_ms(lambda: out.update(r=step(params, state,
                                                           batch))))
            params, state, met = out.pop("r")
            losses.append(float(met["loss"]))
            if i == 0:
                first = (params, state["m"], float(met["lr"]))
            if i + 1 == half_steps:
                repeat = tree_bits_equal((params, state), got_half)
                del got_half
        final = (params, state)
        del params, state, out

        # run C: the loop's resume (``latest_complete_step``, then
        # ``load_checkpoint`` into a fresh state), then the rest of the
        # steps; run through the loop itself it would also save the end,
        # 12 GB more to disk for the LM
        t0 = time.perf_counter()
        latest = latest_complete_step(tmp)
        check(latest == half_steps, f"{key}: the newest complete step is "
              f"{latest}")
        got = load_checkpoint(tmp, latest, make_state())
        t_load = time.perf_counter() - t0
        for _ in range(TRAIN_STEPS - latest):
            p_, s_, _m = step(*got, batch)
            got = (p_, s_)
            del p_, s_, _m
        t_c = time.perf_counter() - t0
        resumed = tree_bits_equal(got, final)
        del got, final
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    ms = float(np.median(times[1:]))
    share = flops / (ms * 1e-3) / peak
    check(all(np.isfinite(losses)), f"{key}: finite losses")
    check(losses[-1] < losses[0], f"{key}: the loss falls on a fixed batch "
          f"({losses})")
    check(repeat, f"{key}: two runs from one seed bitwise equal")
    check(resumed, f"{key}: resumed from step {half_steps} bitwise equal "
          f"to {TRAIN_STEPS} straight steps")
    res = dict(ms=ms, times=times, losses=losses, peak=peak_mem,
               share=share, rate=units / (ms * 1e-3), repeat=repeat,
               resumed=resumed, ckpt_bytes=ckpt_bytes,
               loop_s=(t_b, t_load, t_c), leftover=before)
    extra = ""
    if alt_step is not None:
        torch.cuda.reset_peak_memory_stats()
        p_alt, s_alt, m_alt = alt_step(*make_state(), batch)
        res["alt_peak"] = torch.cuda.max_memory_allocated()
        rtol, atol_rel = grad_tol or (TRAIN_GRAD_RTOL, TRAIN_GRAD_ATOL_REL)
        worst_m = 0.0
        for (path, a), (_, w) in zip(tree_paths(s_alt["m"]),
                                     tree_paths(first[1]), strict=True):
            top = float(w.abs().max())
            over = (a - w).abs() - rtol * w.abs() - atol_rel * top
            check(bool((over <= 0).all()), f"{key} {path}: M="
                  f"{step_parts(alt_step)['n_microbatches']}'s grads "
                  f"within ({rtol:g}, {atol_rel:g}) of the step's")
            worst_m = max(worst_m, float((a - w).abs().max()) / max(
                top, 1e-30))
        res["alt_grad_rel"] = worst_m
        res["alt"] = params_within(p_alt, first[0], first[1], first[2],
                                   opt.b1, tol=grad_tol)
        res["alt_loss"] = (float(m_alt["loss"]), losses[0])
        extra = (f"; M={step_parts(alt_step)['n_microbatches']} against "
                 f"M={step_parts(step)['n_microbatches']}: clipped grads max "
                 f"|diff| / max {worst_m:.2e}, params max err "
                 f"{res['alt'][0]:.2e} where AdamW's sign is held "
                 f"({res['alt'][2]} elements not held, max "
                 f"{res['alt'][1]:.2e}), loss {res['alt_loss'][0]:.6f} vs "
                 f"{losses[0]:.6f}, peak {res['alt_peak'] / 1e9:.2f} GB "
                 f"with run A's first step held")
        del p_alt, s_alt
    del first
    if compress_step is not None:
        p_c, _, m_c = compress_step(*make_state(compress=True), batch)
        res["compress_loss"] = float(m_c["loss"])
        check(res["compress_loss"] == losses[0],
              f"{key}: the compressed step's loss is the step's")
        check(all(bool(torch.isfinite(x).all()) for _, x in tree_paths(p_c)),
              f"{key}: finite params after a compressed step")
        del p_c, _
        extra += f"; compress=True: loss {res['compress_loss']:.6f}, finite"
    print(f"[train] {key}: step {ms:.3f} ms (median of steps 2-"
          f"{TRAIN_STEPS}; all {[round(t, 3) for t in times]}), "
          f"{res['rate']:,.1f} {unit}/s, peak {peak_mem / 1e9:.2f} GB "
          f"(over {half_steps} steps and a save; {before / 1e9:.2f} GB "
          f"held before), FLOP share {share:.4f} of {peak_name}; losses "
          f"{[round(x, 6) for x in losses]}; two runs bitwise {repeat}; "
          f"resumed bitwise {resumed} (checkpoint {ckpt_bytes:,} bytes; "
          f"the loop {t_b:.1f} s to step {half_steps} with its save; "
          f"resumed in {t_c:.1f} s, its load {t_load:.1f} s){extra}",
          flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    return res


def egnn_batch_on_card(cfg, n_nodes: int, n_edges: int, n_edges_pad: int,
                       gen) -> dict:
    """A node-readout EGNN batch drawn on the card: normal features and
    coordinates, ``n_edges`` edges by ``data.graphs.random_graph``'s rule
    (uniform sources, destinations ``N · U^(1/3)``: a power-law in-degree)
    and ``n_edges_pad - n_edges`` padding edges (-1), labels uniform in
    the classes."""
    import torch
    dev = gen.device
    src = torch.randint(0, n_nodes, (n_edges,), generator=gen, device=dev)
    u = torch.rand(n_edges, generator=gen, device=dev, dtype=torch.float64)
    dst = (n_nodes * u.pow(1.0 / 3.0)).long().clamp_max(n_nodes - 1)
    edges = torch.full((n_edges_pad, 2), -1, dtype=torch.int32, device=dev)
    edges[:n_edges, 0] = src.to(torch.int32)
    edges[:n_edges, 1] = dst.to(torch.int32)
    return {"node_feat": torch.randn(n_nodes, cfg.d_feat, generator=gen,
                                     device=dev),
            "coords": torch.randn(n_nodes, cfg.coord_dim, generator=gen,
                                  device=dev),
            "edges": edges,
            "labels": torch.randint(0, cfg.n_out, (n_nodes,), generator=gen,
                                    device=dev, dtype=torch.int32)}


def reddit_train_sample(graph, csr, seed: int) -> dict:
    """minibatch_lg's batch: ``data.graphs.neighbor_sample`` of
    ``SAMPLE_SEEDS`` seeds (nodes with an in-neighbour) at ``FANOUTS``
    over ``graph``, whose CSR ``csr`` is already made (numpy, host)."""
    from types import SimpleNamespace

    from repro_torch.data.graphs import neighbor_sample
    rng = np.random.default_rng(seed + 13)
    has_in = np.flatnonzero(np.diff(csr[0]) > 0)
    seeds = rng.choice(has_in, size=SAMPLE_SEEDS, replace=False)
    view = SimpleNamespace(csr=lambda: csr, node_feat=graph.node_feat,
                           coords=graph.coords, labels=graph.labels)
    return neighbor_sample(view, seeds, FANOUTS, rng=rng)


def phase_train(seed: int, mesh, reddit=None) -> dict:
    """Phase 13: training at full width on the card (one rank).

    First which sums repeat on the card (``train_probe``) and each
    family's SMOKE on the card against the CPU (``train_card_vs_cpu``).
    Then the train cells of ``configs.get_cells``, each through
    ``train_cell_run``: gemma3-1b ``train_4k`` at full width and 4,096
    positions, its global batch **cut** to ``TRAIN_LM_BATCH`` (M = 2, as
    the config says; M = 1 beside it); the four recsys ``train_batch``
    cells at B = 65,536 (DLRM's table **cut** to ``DLRM_TRAIN_ROW_CAP``
    rows a field; M = 2 beside M = 1); EGNN on Cora, Reddit's (15, 10)
    sample (``reddit``: phase 7's, else drawn here), ogb_products with
    every node and its edges **cut** to ``PRODUCTS_TRAIN_EDGES``, and the
    128 molecules. Every cell also takes one compressed step. Returns the
    phase's launch counts (all 0: the training path reaches no kernel)
    and the numbers."""
    import functools
    from dataclasses import replace

    import torch

    from repro_torch import configs
    from repro_torch.configs import egnn as egnn_cfg
    from repro_torch.configs.common import (gnn_train_cell, lm_train_cell,
                                            recsys_cells)
    from repro_torch.data.graphs import batched_molecules, random_graph
    from repro_torch.data.lm import lm_batches
    from repro_torch.kernels import COUNTERS
    from repro_torch.models import egnn, recsys, transformer
    from repro_torch.models.common import count_params
    from repro_torch.train import init_train_state, make_train_step

    dev = torch.device("cuda")
    for c in COUNTERS:
        c.reset()
    res = {"probe": train_probe(seed),
           "card_vs_cpu": train_card_vs_cpu(seed)}

    def variant(step, **kw):
        parts = step_parts(step)
        base = make_train_step(parts["loss_fn"], parts["optimizer"], **{
            "n_microbatches": parts["n_microbatches"], "compress": False,
            **kw})
        if "n_graphs" not in parts:
            return base
        n_graphs = parts["n_graphs"]
        return lambda p, s, b: base(p, s, dict(b, n_graphs=n_graphs))

    def state_maker(init, cfg, opt, s):
        def make_state(compress=False):
            p = init(torch.Generator(device=dev).manual_seed(s), cfg,
                     device=dev)
            return p, init_train_state(p, opt, compress=compress)
        return make_state

    # -- LM: gemma3-1b train_4k, global batch cut ---------------------------
    t_fam = time.perf_counter()
    cfg = configs.get_config(LM_ARCH)
    (full,) = [c for c in configs.get_cells(LM_ARCH) if c.kind == "train"]
    seq = full.build(None)[1][2]["tokens"].shape[1]
    m = configs.get_module(LM_ARCH).N_MICROBATCHES
    cell = lm_train_cell(LM_ARCH, cfg, global_batch=TRAIN_LM_BATCH,
                         seq_len=seq, n_microbatches=m)
    check(cell.key == full.key, "the cut train_4k is train_4k")
    step, (specs, _, bspec) = cell.build(mesh)
    print(f"[train] CUT {full.key}: global batch "
          f"{full.build(None)[1][2]['tokens'].shape[0]} -> {TRAIN_LM_BATCH} "
          f"sequences of {seq:,} ({m} microbatches of "
          f"{TRAIN_LM_BATCH // m}): at B = 256 one step is "
          f"{full.model_flops / 1e15:.0f} PFLOP, minutes at the bf16 peak; "
          f"d_model {cfg.d_model}, {cfg.n_layers} layers, vocab "
          f"{cfg.vocab_size:,} kept; f32 params, grads, m and v of "
          f"{count_params(specs):,} params are "
          f"{4 * 4 * count_params(specs) / 1e9:.1f} GB", flush=True)
    nb = next(lm_batches(vocab_size=cfg.vocab_size, batch=TRAIN_LM_BATCH,
                         seq_len=seq, seed=seed))
    batch = {k: torch.as_tensor(v, device=dev) for k, v in nb.items()}
    check(all(tuple(batch[k].shape) == tuple(bspec[k].shape)
              and batch[k].dtype == bspec[k].dtype for k in bspec),
          "the LM batch is made as its spec")
    opt = step_parts(step)["optimizer"]
    res[full.key] = train_cell_run(
        full.key, step, state_maker(transformer.init_params, cfg, opt,
                                    seed * 100 + 41), batch,
        flops=cell.model_flops, peak=BF16_OPS_PER_S,
        peak_name="989 TFLOP/s (bf16)", units=TRAIN_LM_BATCH * seq,
        unit="tokens", alt_step=variant(step, n_microbatches=1),
        compress_step=variant(step, compress=True),
        grad_tol=(0.0, TRAIN_BF16_GRAD_REL))
    del batch
    print(f"[train] lm done in {time.perf_counter() - t_fam:.1f} s",
          flush=True)

    # -- recsys: train_batch at B = 65,536 ----------------------------------
    t_fam = time.perf_counter()
    for a, arch in enumerate(RECSYS_ARCHS):
        rcfg = configs.get_config(arch)
        (cell,) = [c for c in configs.get_cells(arch) if c.kind == "train"]
        if arch == "dlrm-mlperf":
            fullcfg = rcfg
            rcfg = replace(fullcfg, vocab_sizes=tuple(
                min(v, DLRM_TRAIN_ROW_CAP) for v in fullcfg.vocab_sizes))
            table = rcfg.padded_rows * rcfg.embed_dim * 4
            print(f"[train] CUT {cell.key}: table rows "
                  f"{fullcfg.padded_rows:,} -> {rcfg.padded_rows:,} "
                  f"({fullcfg.padded_rows * fullcfg.embed_dim * 4 / 1e9:.1f}"
                  f" -> {table / 1e9:.2f} GB in f32), at most "
                  f"{DLRM_TRAIN_ROW_CAP:,} rows a field: a step holds the "
                  f"table's params, grads, m, v and the new params, m and "
                  f"v (7 x {table / 1e9:.2f} = {7 * table / 1e9:.1f} GB) "
                  f"and its temporaries (about 13 tables at M = 2), and "
                  f"the checks keep up to 5 more copies; the 26 fields, "
                  f"dim 128, both MLPs and the interaction are kept",
                  flush=True)
            (cut,) = [c for c in recsys_cells(arch, rcfg,
                                              train_microbatches=1)
                      if c.kind == "train"]
            check(cut.key == cell.key, "the cut DLRM has its train cell")
            cell = cut
        step, (specs, _, bspec) = cell.build(mesh)
        gen = torch.Generator(device=dev).manual_seed(seed * 100 + 50 + a)
        batch = recsys_inputs(rcfg, bspec, gen, serve=False)
        opt = step_parts(step)["optimizer"]
        b = int(bspec["labels" if "labels" in bspec else "history"].shape[0])
        res[cell.key] = train_cell_run(
            cell.key, step, state_maker(recsys.init_params, rcfg, opt,
                                        seed * 100 + 60 + a), batch,
            flops=cell.model_flops, peak=FP32_OPS_PER_S,
            peak_name="67 TFLOP/s (f32)", units=b, unit="samples",
            alt_step=variant(step, n_microbatches=2),
            compress_step=variant(step, compress=True),
            grad_tol=(TRAIN_GRAD_RTOL, TRAIN_SPLIT_GRAD_REL))
        del batch
    print(f"[train] recsys done in {time.perf_counter() - t_fam:.1f} s",
          flush=True)

    # -- GNN: EGNN at its four shapes ----------------------------------------
    t_fam = time.perf_counter()
    cells = {c.shape: c for c in configs.get_cells("egnn")}
    for i, shape in enumerate(egnn_cfg.SHAPE_DEFS):
        d = egnn_cfg.SHAPE_DEFS[shape]
        ecfg = egnn_cfg.shape_config(shape)
        cell = cells[shape]
        gen = torch.Generator(device=dev).manual_seed(seed * 100 + 70 + i)
        t0 = time.perf_counter()
        if shape == "ogb_products":
            per_edge = EGNN_BYTES_PER_EDGE
            print(f"[train] CUT {cell.key}: edges {d['n_edges']:,} -> "
                  f"{PRODUCTS_TRAIN_EDGES:,}, all {d['n_nodes']:,} nodes "
                  f"kept: one layer's recompute and backward hold about "
                  f"{per_edge:,} bytes an edge (h_i, h_j, the [E, 129] "
                  f"concat, phi_e's and phi_x's activations and their "
                  f"grads), {d['n_edges'] * per_edge / 1e9:.0f} GB at full "
                  f"size, {PRODUCTS_TRAIN_EDGES * per_edge / 1e9:.0f} GB "
                  f"cut", flush=True)
            cell = gnn_train_cell("egnn", ecfg, shape, n_nodes=d["n_nodes"],
                                  n_edges=PRODUCTS_TRAIN_EDGES)
            check(cell.key == cells[shape].key, "the cut products cell")
        step, (specs, _, bspec) = cell.build(mesh)
        n_pad = bspec["edges"].shape[0]
        if shape == "molecule":
            mb = batched_molecules(d["n_graphs"], n_nodes=30, n_edges=64,
                                   d_feat=ecfg.d_feat, seed=seed)
            mb.pop("n_graphs")
            batch = {k: torch.as_tensor(v, device=dev)
                     for k, v in mb.items()}
            units, unit = d["n_graphs"], "graphs"
        elif shape == "minibatch_lg":
            if reddit is None:
                g = random_graph(**REDDIT, seed=seed)
                reddit = reddit_train_sample(g, g.csr(), seed)
                del g
            batch = {k: torch.as_tensor(v, device=dev)
                     for k, v in reddit.items()}
            batch["edges"] = torch.cat([batch["edges"], torch.full(
                (n_pad - batch["edges"].shape[0], 2), -1, dtype=torch.int32,
                device=dev)])
            units, unit = SAMPLE_SEEDS, "seeds"
        else:
            n_real = (PRODUCTS_TRAIN_EDGES if shape == "ogb_products"
                      else d["n_edges"])
            batch = egnn_batch_on_card(ecfg, d["n_nodes"], n_real, n_pad,
                                       gen)
            units, unit = d["n_nodes"], "nodes"
        check(all(tuple(batch[k].shape) == tuple(bspec[k].shape)
                  and batch[k].dtype == bspec[k].dtype for k in bspec),
              f"{cell.key}: the batch is made as its spec")
        print(f"[train] {cell.key}: batch of {d['n_nodes']:,} nodes, "
              f"{n_pad:,} edge slots ({int((batch['edges'][:, 0] >= 0).sum()):,}"
              f" edges) on the card in {time.perf_counter() - t0:.1f} s",
              flush=True)
        opt = step_parts(step)["optimizer"]
        res[cell.key] = train_cell_run(
            cell.key, step, state_maker(egnn.init_params, ecfg, opt,
                                        seed * 100 + 80 + i), batch,
            flops=cell.model_flops, peak=FP32_OPS_PER_S,
            peak_name="67 TFLOP/s (f32)", units=units, unit=unit,
            compress_step=variant(step, compress=True))
        del batch
    print(f"[train] gnn done in {time.perf_counter() - t_fam:.1f} s",
          flush=True)
    launches = {c.name: c.n for c in COUNTERS}
    print(f"[train] phase 13 launches {launches}", flush=True)
    check(all(n == 0 for n in launches.values()),
          "no kernel launched in phase 13: the training path reaches none")
    return dict(launches=launches, cells=res)


def phase_bm25(args) -> tuple[list, dict]:
    """Phases 3-6, 8-10: the BM25 query paths at full width (retriever,
    front-end, snapshots, ladder, kernels, dense path, sharded step).
    Returns the ``kernels`` entries of K1-K6 and phase 10's launch counts;
    every tensor of these phases is freed on return."""
    import torch

    from repro_torch.core import BM25Params, ScipyBM25, build_index
    from repro_torch.core.retrieval import default_doc_ids
    from repro_torch.core.scoring import bucket_pow2
    from repro_torch.kernels import COUNTERS
    from repro_torch.kernels import bm25_block_score as k2
    from repro_torch.kernels import bm25_gather_score as k1
    from repro_torch.serve import DeviceRetriever
    from repro_torch.sparse.block_csr import (TRANSFERS,
                                              estimate_prune_survivors,
                                              fragment_plan,
                                              gather_posting_runs,
                                              reset_transfer_stats)
    from repro_torch.sparse.fragment_device import plan_fragments_device

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
    for name in (k1.LAUNCHES.name, k2.LAUNCHES.name,
                 k1.LAUNCHES_PRUNED.name):    # K4 serves the ladder only
        check(launches[name] > 0, f"{name} launched on the main path")

    t0 = time.perf_counter()
    oracle = ScipyBM25(idx)
    worst = 0.0
    for regime, i, qs, res in served[:len(REGIMES)]:
        worst = max(worst, sampled_exact(oracle, qs, res, rng, 5))
    print(f"[full] {5 * len(REGIMES)} sampled queries ({len(REGIMES)} "
          f"regimes) exact against ScipyBM25, max |score - oracle| "
          f"{worst:.3g} (atol {EXACT_ATOL}; "
          f"{time.perf_counter() - t0:.1f}s)", flush=True)

    # -- phase 8: the micro-batching front-end ----------------------------
    t0 = time.perf_counter()
    fe_launches = phase_frontend(
        dr, oracle, np.random.default_rng(args.seed + 8),
        [(i, qs, res) for regime, i, qs, res in served if regime == "auto"])
    print(f"[frontend] done in {time.perf_counter() - t0:.1f}s", flush=True)

    # -- phase 9: K1/K3 past 512 rows, cold start, reordering --------------
    t0 = time.perf_counter()
    p9 = phase_snapshot(
        dr, idx, oracle, np.random.default_rng(args.seed + 9),
        {regime: (qs, res) for regime, i, qs, res in served if i == 0},
        args.seed)
    print(f"[snapshot] phase 9 done in {time.perf_counter() - t0:.1f}s",
          flush=True)

    # -- phase 4: the ladder through the engine ---------------------------
    t0 = time.perf_counter()
    ladder_launches, shards, shard_drs, host_qs = phase_ladder(idx, oracle,
                                                               rng)
    print(f"[ladder] done in {time.perf_counter() - t0:.1f}s", flush=True)

    # -- phase 5: the kernels at the main path's shapes -------------------
    t_k = time.perf_counter()
    dev = dr.device
    kernels = []
    tol = f"atol {ATOL} + rtol {RTOL} vs the twin on the card"
    group_at = (f"full width, query columns 0-{len(GROUP_TWIN_COLS) - 1} "
                "(the first CTA column group, every lane), CPU twin; phase "
                "2: all columns, 100,003 docs, B 8 and 64")
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
    cuts1 = timed_cuts(k1.bm25_resident_score_topk, ops1, ms,
                       dict(kw1, frag=dr.dindex.frag), "K1", w.shape[1])
    # the first 32 query columns: one column group, so no posting is read
    # by two groups' CTAs
    ops32 = (ops1[0], ops1[1][:, :32].contiguous(), *ops1[2:])
    cuts1[f"k{TOP_K}_b32"] = cuda_ms(lambda: k1.bm25_resident_score_topk(
        *ops32, frag=dr.dindex.frag, **kw1), reps=3)
    print(f"[kernels] K1 at the first 32 columns: "
          f"{cuts1[f'k{TOP_K}_b32']:.3f} ms", flush=True)
    del ops32
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
        tolerance=tol, twin_bitwise=bitwise, twin_bitwise_at=group_at,
        ms=ms, plain_ms=plain_ms, split_ms=cuts1, bytes=nbytes, ops=nops))
    # K2
    tab, w = pk.uniq_tab, pk.weights
    di = dr.dindex
    ops2 = (di.blk_tok, di.blk_loc, di.blk_sc,
            torch.as_tensor(tab, device=dev), torch.as_tensor(w, device=dev))
    kw2 = dict(block_size=DOC_BLOCK, k=TOP_K, n_docs=n_docs)
    got = k2.bm25_block_score_topk(*ops2, **kw2)
    ms = cuda_ms(lambda: k2.bm25_block_score_topk(*ops2, **kw2), reps=3)
    cuts2 = timed_cuts(k2.bm25_block_score_topk, ops2, ms, kw2, "K2",
                       w.shape[1])
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
    if args.save_board_operands is not None:
        args.save_board_operands.mkdir(parents=True, exist_ok=True)
        torch.save({"ops": ops2, "kw": kw2},
                   args.save_board_operands / "k2.pt")
    hits = int(torch.isin(di.blk_tok, ops2[3]).sum())
    b = w.shape[1]
    # the token of every slot; the row and score of a matched posting only
    nbytes = (di.blk_tok.numel() * 4 + hits * 8 + tab.nbytes + w.nbytes
              + got[0].numel() * 8)
    nops = 2.0 * hits * b
    # the bound as first stated, 12 bytes for every slot (pads included),
    # kept for comparison with the first kernel's rows
    every_slot_ms = max(
        (di.blk_tok.numel() * 12 + tab.nbytes + w.nbytes
         + got[0].numel() * 8) / HBM_BYTES_PER_S * 1e3,
        nops / FP32_OPS_PER_S * 1e3)
    print(f"[kernels] K2 reads: {di.blk_tok.numel()} posting slots, {hits} "
          f"matched; bound with 12 bytes every slot {every_slot_ms:.4f} ms",
          flush=True)
    kernels.append(dict(
        name="bm25_block_score_topk", route="cuda",
        source="src/repro_torch/kernels/csrc/bm25_block_score.cu",
        replaces="src/repro/kernels/bm25_block_score.py:184",
        launches=launches["bm25_block_score_topk"], max_abs_err=err,
        tolerance=tol, twin_bitwise=bitwise, twin_bitwise_at=group_at,
        ms=ms, plain_ms=plain_ms, split_ms=cuts2,
        bound_ms_every_slot=every_slot_ms, bytes=nbytes, ops=nops))
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
          f"(mean over column groups); board bitwise equal to K1 on the same "
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
        twin_bitwise_at=group_at, fragments=int(desc3.shape[1]),
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
    cuts4 = timed_cuts(k1.bm25_gather_score_topk, ops4, ms, kw4, "K4",
                       pk0.weights.shape[1])
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
    if args.save_board_operands is not None:
        torch.save({"ops": ops4, "kw": kw4},
                   args.save_board_operands / "k4.pt")
    del ref, ops4
    b = pk0.weights.shape[1]
    # the token of every slot; the slot and score of a real posting only
    nbytes = (gp.token_ids.nbytes + gp.sum_df * 8 + gp.candidates.nbytes
              + pk0.uniq_tab.nbytes + pk0.weights.nbytes + TOP_K * b * 8)
    nops = 2.0 * gp.sum_df * b
    kernels.append(dict(
        name="bm25_gather_score_topk", route="cuda",
        source="src/repro_torch/kernels/csrc/bm25_gather_score.cu",
        replaces="src/repro/kernels/bm25_gather_score.py:177",
        launches=ladder_launches["bm25_gather_score_topk"],
        max_abs_err=err, tolerance=tol, twin_bitwise=bitwise,
        twin_bitwise_at=(f"shard 0's host-rung gather, query columns "
                         f"0-{len(GROUP_TWIN_COLS) - 1} (the first CTA "
                         "column group, every lane), CPU twin; phase 2: "
                         "all columns, 100,003 docs, B 8 and 64"),
        n_chunks=gp.n_chunks, p_pad=gp.p_pad, sum_df=gp.sum_df,
        gather_ms=gather_ms, ms=ms, plain_ms=plain_ms, split_ms=cuts4,
        bytes=nbytes, ops=nops))
    for kd in kernels[:3]:
        kd["launches_ladder"] = ladder_launches[kd["name"]]
    print(f"[kernels] done in {time.perf_counter() - t_k:.1f}s", flush=True)

    # -- phase 6: the dense path at full width ----------------------------
    del shards, shard_drs, sh0, dr0, got
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    kernels += phase_dense(dr, idx, oracle, rng)
    print(f"[dense] done in {time.perf_counter() - t0:.1f}s", flush=True)

    # -- phase 10: the sharded step at world size 1, the launcher ----------
    del dr
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    p10 = phase_sharded(
        idx, oracle, np.random.default_rng(args.seed + 10),
        [(qs, res) for regime, i, qs, res in served if regime == "gathered"])
    print(f"[sharded] phase 10 done in {time.perf_counter() - t0:.1f}s",
          flush=True)
    for kd in kernels:
        kd["launches_frontend"] = fe_launches[kd["name"]]
        kd["launches_phase9"] = p9["launches"][kd["name"]]
    rows_key = f"ms_rows{p9['rows']}_k{F3_K}"
    kernels[0][rows_key] = p9["k1_rows_ms"]          # K1
    kernels[2][rows_key] = p9["k3_rows_ms"]          # K3
    for kd in (kernels[0], kernels[2]):
        kd[f"bound_ms_rows{p9['rows']}_k{F3_K}"] = p9["rows_bound_ms"]
    kernels[4]["phase10_ms"] = p10["times"]                 # K5's path
    return kernels, p10["launches"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-docs", type=int, default=2_097_152)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batches", type=int, default=3,
                    help="batches served under each regime")
    ap.add_argument("--save-board-operands", type=Path, default=None,
                    metavar="DIR", help="write K2's and K4's phase 5 "
                    "operands to DIR (for tools/time_board_kernels.py)")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
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
    phase_topk_vs_twin(args.seed)
    phase_k6_k7_vs_twins(args.seed)
    phase_k2_k4_vs_twins(args.seed)
    print(f"[kernel-vs-twin] done in {time.perf_counter() - t0:.1f}s",
          flush=True)

    kernels, p10_launches = phase_bm25(args)
    gc.collect()
    torch.cuda.empty_cache()

    # -- phase 7: the sparse substrate at full width -----------------------
    t0 = time.perf_counter()
    keep = {}
    kernels += phase_sparse(args.seed, keep)
    print(f"[sparse] done in {time.perf_counter() - t0:.1f}s", flush=True)
    gc.collect()
    torch.cuda.empty_cache()

    # -- phases 11-13: recsys and LM serving, training at full width -------
    import shutil

    import torch.distributed as tdist
    mesh, rdv = one_rank_mesh()
    try:
        t0 = time.perf_counter()
        p11 = phase_recsys(args.seed, mesh)
        print(f"[recsys] phase 11 done in {time.perf_counter() - t0:.1f}s",
              flush=True)
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        p12 = phase_lm(args.seed, mesh)
        print(f"[lm] phase 12 done in {time.perf_counter() - t0:.1f}s",
              flush=True)
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        p13 = phase_train(args.seed, mesh, keep.pop("reddit", None))
        print(f"[train] phase 13 done in {time.perf_counter() - t0:.1f}s",
              flush=True)
    finally:
        tdist.destroy_process_group()
        shutil.rmtree(rdv, ignore_errors=True)
    kernels[4]["phase11_ms"] = p11["k5_ms"]                 # K5 alone
    kernels[4]["phase11_topk_ms"] = p11["topk_ms"]          # all of ops.topk
    for kd in kernels:
        kd["launches_phase10"] = p10_launches[kd["name"]]
        kd["launches_phase11"] = p11["launches"][kd["name"]]
        kd["launches_phase12"] = p12["launches"][kd["name"]]
        kd["launches_phase13"] = p13["launches"][kd["name"]]
        t_bytes = kd.pop("bytes") / HBM_BYTES_PER_S * 1e3
        t_ops = kd.pop("ops") / FP32_OPS_PER_S * 1e3
        kd["bound_ms"] = max(t_bytes, t_ops)
        kd["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        kd.setdefault("library_ms", None)   # K1-K4: no single torch call
        print(f"[bound] {kd['name']}: {kd['ms']:.4f} ms against a bound of "
              f"{kd['bound_ms']:.4f} ms by {kd['bound_by']} ({t_bytes:.4f} "
              f"ms of bytes at 3.35 TB/s, {t_ops:.4f} ms of FP32 operations "
              f"at 67 TFLOP/s)", flush=True)
    print(f"[done] {time.perf_counter() - t_all:.1f}s in all", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
