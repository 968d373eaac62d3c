"""The device retriever: one scorer, three regimes, zero per-batch copies.

The port's counterpart of ``repro.serve.retrieval_engine`` — the query
path of ``DeviceRetriever`` on a resident index:

1. ``pack_batch`` turns the batch into pow2-bucketed ``[U]`` / ``[U, B]``
   query tables and a ``[B]`` §2.1 shift (host numpy);
2. ``core.retrieval.plan_retrieval`` picks full scan, gathered or pruned
   from Σ df, nnz and (under ``auto``) the host survivor estimate;
3. the regime runs on the device: gathered through the fragment table
   (built on the device by ``sparse.fragment_device``, or on the host by
   ``fragment_plan``) and kernel K1; pruned through a seed pass (K1), the
   threshold compaction and kernel K3; full scan through kernel K2;
4. the ``[B, k]`` board is spliced with default documents, shifted, and
   finite-checked.

Not ported yet (later slices, see ROADMAP): the host-gather execution,
the degradation ladder, breakers and watchdog, doc-id reordering, shards,
the front-end and snapshots. Asking for one raises
:class:`~repro_torch.serve.errors.RetrievalConfigError`; a typed failure
raises, and no fall-back hides a failing kernel.
"""

from __future__ import annotations

import time
from dataclasses import replace
from typing import Sequence

import numpy as np
import torch

from ..core.index import BM25Index
from ..device import resolve_device
from .errors import (ResidencyError, RetrievalConfigError,
                     ScoreIntegrityError)
from .results import PackedBatch, RetrievalResult


def _empty_batch(n_queries: int):
    ids = np.zeros((n_queries, 0), dtype=np.int64)
    scores = np.zeros((n_queries, 0), dtype=np.float32)
    return ids, scores


class DeviceRetriever:
    """ONE device scorer, three regimes, zero per-batch posting copies.

    Builds a device-resident ``sparse.block_csr.DeviceIndex`` at
    construction (posting arrays uploaded ONCE — the block-bucketed
    full-scan layout, the CSC arrays the resident kernels read, and the
    block-max table of the pruned regime) and plans every batch through
    ``core.retrieval.plan_retrieval``:

    * ``regime="auto"`` (default) — full scan O(nnz), gathered
      O(crossover × Σ df) and, with the block-max table resident, pruned
      (the gathered cost × the estimated surviving fraction /
      ``PRUNE_DISCOUNT``); the decision and the pruning evidence are kept
      in ``self.last_plan``.
    * ``regime="blocked"`` / ``"gathered"`` / ``"pruned"`` — force that
      regime (the planner still runs, so the evidence is logged).

    The pruned regime is the resident gather plus exact block-max pruning
    (:meth:`_retrieve_pruned`): the same board, less work.

    ``gather="resident"`` is the only execution of this slice (the
    host-gather rung comes with its kernel). Where the fragment table is
    built is the ``plan`` axis:

    - ``plan="device"`` (the default on a CUDA device) — built from the
      resident CSC tensors (``sparse.fragment_device``): per batch the host
      reads no posting array and uploads zero posting AND zero descriptor
      bytes. ``host_arrays="drop"`` then releases the host posting copy.
    - ``plan="host"`` (the default on the CPU) — ``fragment_plan`` walks
      the host CSC copy and ships the descriptor table per batch.

    ``double_buffer`` is accepted for signature parity (one CUDA kernel
    serves both TPU schedules, which are bit-identical by contract).
    ``device`` defaults to ``"cuda"`` and raises without a GPU; the CPU
    tests pass ``device="cpu"``, where every kernel runs its plain twin.
    """

    def __init__(self, index: BM25Index, *, regime: str = "auto",
                 block_size: int = 512, tile: int = 512, q_max: int = 32,
                 frag: int = 512, crossover: float | None = None,
                 gather: str | None = None, plan: str | None = None,
                 double_buffer: bool = True, host_arrays: str = "keep",
                 bmax_dtype: str = "auto", device=None):
        from ..sparse.block_csr import DeviceIndex
        if regime not in ("auto", "blocked", "gathered", "pruned"):
            raise RetrievalConfigError(f"unknown regime {regime!r}")
        gather = "resident" if gather is None else gather
        if gather not in ("resident", "host"):
            raise RetrievalConfigError(f"unknown gather mode {gather!r}")
        if regime == "pruned" and gather != "resident":
            raise RetrievalConfigError(
                'regime="pruned" gates resident fragment reads against the '
                'block-max table — it requires gather="resident"')
        self.device = resolve_device(device)
        if plan is None:
            plan = "device" if self.device.type == "cuda" else "host"
        if plan not in ("host", "device"):
            raise RetrievalConfigError(f"unknown plan mode {plan!r}")
        if plan == "device" and gather != "resident":
            raise RetrievalConfigError(
                'plan="device" builds fragment tables from the resident '
                'CSC arrays — it requires gather="resident"')
        if host_arrays not in ("keep", "drop"):
            raise RetrievalConfigError(
                f"unknown host_arrays mode {host_arrays!r}")
        if host_arrays == "drop" and plan != "device":
            raise RetrievalConfigError(
                'host_arrays="drop" removes the arrays the host fragment '
                'planner reads — it requires plan="device"')
        if gather == "host":
            raise RetrievalConfigError(
                'gather="host" is not yet ported to repro_torch')
        self.index = index
        self.regime = regime
        self.plan_mode = plan
        self.double_buffer = double_buffer
        self.q_max = q_max                       # bucket floor, not a cap
        self.block_size = block_size
        self.crossover = crossover
        self.n_docs = int(index.doc_lens.size)
        with_csc = regime in ("auto", "gathered", "pruned")
        self.dindex = DeviceIndex.build(
            index, device=self.device, block_size=block_size, tile=tile,
            frag=frag, with_blocked=regime in ("auto", "blocked"),
            with_csc=with_csc,
            with_bmax=with_csc and regime in ("auto", "pruned"),
            bmax_dtype=bmax_dtype, host_arrays=host_arrays)
        self._nf_state = {}                      # steady-state nf bucket
        if host_arrays == "drop":
            # serving now reads only metadata: a private stripped view (the
            # caller's index object is untouched)
            self.index = replace(index, doc_ids=np.zeros(0, np.int32),
                                 scores=np.zeros(0, np.float32))
        self.last_plan = None

    def _host_postings_intact(self) -> bool:
        """False once ``host_arrays="drop"`` released the host copy."""
        return int(self.index.doc_ids.size) == int(self.index.indptr[-1])

    def warmup(self, *, k: int) -> None:
        """Run each regime this retriever serves once (builds the kernels).

        ``auto`` warms blocked and gathered; the pruned kernels build on
        the first batch the cost model routes there, as in the reference.
        """
        if self.n_docs == 0 or k <= 0:
            return
        q = np.zeros(1, dtype=np.int32)
        kk = min(k, self.n_docs)
        if (self.regime in ("auto", "blocked")
                and self.dindex.blk_tok is not None):
            self.retrieve_batch([q], kk, regime="blocked")
        if (self.regime in ("auto", "gathered")
                and self.dindex.csc_doc_ids is not None):
            self.retrieve_batch([q], kk, regime="gathered")
        if self.regime == "pruned":
            self.retrieve_batch([q], kk, regime="pruned")

    def _pack_batch(self, query_tokens):
        """Batch -> padded query tables, every device dim pow2-bucketed.

        The batch ``B`` is padded with empty queries, the per-query width
        is bucketed from the longest query (so ``pad_queries`` never
        truncates), and the unique-token table ``u_max`` is bucketed from
        the batch's distinct-token count.

        Returns ``(b_true, uniq_batch, uniq_tab [u], weights [u, B],
        shift [B])`` — callers slice device outputs back to ``b_true``.
        """
        from ..core.scoring import bucket_pow2, pad_queries
        from ..sparse.block_csr import (pack_query_batch,
                                        query_nonoccurrence_shift)
        qs = [np.asarray(q).ravel() for q in query_tokens]
        b_true = len(qs)
        b_pad = bucket_pow2(max(b_true, 1), floor=8)
        qs += [np.zeros(0, np.int32)] * (b_pad - b_true)
        width = bucket_pow2(max((q.size for q in qs), default=1) or 1,
                            floor=self.q_max)
        toks, wts, uniq_batch = pad_queries(qs, width, return_uniq=True)
        u_max = bucket_pow2(max(uniq_batch.size, 1), floor=self.q_max)
        uniq_tab, weights = pack_query_batch(toks, wts, u_max=u_max,
                                             uniq=uniq_batch)
        shift = query_nonoccurrence_shift(self.index.nonoccurrence, toks,
                                          wts)
        return b_true, uniq_batch, uniq_tab, weights, shift

    def pack_batch(self, query_tokens: Sequence[np.ndarray]) -> PackedBatch:
        """Host half of :meth:`retrieve_batch`: sanitizer + pow2 pack.

        ``retrieve_batch(None, k, packed=pack_batch(qs))`` equals
        ``retrieve_batch(qs, k)``.
        """
        from ..core.retrieval import validate_query_batch
        t0 = time.perf_counter()
        qs = validate_query_batch(query_tokens, self.index.n_vocab)
        if self.n_docs == 0:
            return PackedBatch(qs, len(qs), np.zeros(0, np.int32), None,
                               None, None,
                               pack_s=time.perf_counter() - t0)
        b, uniq_batch, uniq_tab, weights, shift = self._pack_batch(qs)
        return PackedBatch(qs, b, uniq_batch, uniq_tab, weights, shift,
                           pack_s=time.perf_counter() - t0)

    def retrieve(self, query_tokens: np.ndarray, k: int
                 ) -> RetrievalResult:
        """One query -> :class:`RetrievalResult` with ``[k]`` boards."""
        r = self.retrieve_batch([np.asarray(query_tokens)], k)
        return RetrievalResult(
            ids=r.ids[0], scores=r.scores[0], plan=r.plan,
            timings=r.timings, latency_s=r.latency_s)

    def retrieve_batch(self, query_tokens: Sequence[np.ndarray] | None,
                       k: int, *, regime: str | None = None,
                       packed: PackedBatch | None = None
                       ) -> RetrievalResult:
        """B queries -> :class:`RetrievalResult` with ``[B, k]`` boards.

        ``regime`` overrides this call's plan. Every returned board passes
        a ``[B, k]`` finite-check; a NaN/Inf entry raises
        :class:`~repro_torch.serve.errors.ScoreIntegrityError`.
        """
        from ..core.retrieval import plan_retrieval
        if packed is None:
            packed = self.pack_batch(query_tokens)
        t_start = time.perf_counter()            # exec clock excludes pack
        if self.n_docs == 0 or k <= 0:
            ids0, sc0 = _empty_batch(len(packed.qs))
            return RetrievalResult(
                ids=ids0, scores=sc0,
                timings={"pack_s": packed.pack_s, "execute_s": 0.0,
                         "total_s": packed.pack_s},
                latency_s=packed.pack_s)
        b = packed.b
        kk = min(k, self.n_docs)
        # the pruned regime needs the block-max table and an accumulator
        # window matching its block grid (k can outgrow the block height)
        prune_ok = (self.dindex.bmax is not None
                    and self.dindex.csc_doc_ids is not None
                    and kk <= self.dindex.block_size)
        want = regime or self.regime
        survivor_frac, prune_ub = None, None
        # the host estimate feeds the auto cost model and (under host
        # planning) hands its bounds to the execution; a FORCED pruned
        # batch under device planning needs neither
        if prune_ok and (want == "auto"
                         or (want == "pruned" and self.plan_mode == "host")):
            from ..sparse.block_csr import estimate_prune_survivors
            survivor_frac, prune_ub = estimate_prune_survivors(
                self.dindex.bmax, packed.uniq_tab, packed.weights, k=kk,
                b_true=b)
        plan = plan_retrieval(self.dindex.sum_df(packed.uniq_batch),
                              self.dindex.nnz, regime=want,
                              crossover=self.crossover, plan=self.plan_mode,
                              survivor_frac=survivor_frac)
        if plan.regime == "pruned" and not prune_ok:
            if self.dindex.csc_doc_ids is None or self.dindex.bmax is None:
                raise ResidencyError("pruned regime requested but this "
                                     "retriever was built without the "
                                     "resident CSC index + block-max "
                                     "table")
            # k outgrew the block-max grid (the board spans whole blocks,
            # nothing can prune): the exact unpruned resident path, under
            # the pruned label
            plan = plan_retrieval(plan.sum_df, plan.nnz, regime="gathered",
                                  crossover=self.crossover,
                                  plan=self.plan_mode)
            plan.regime = "pruned"
            pruned = False
        else:
            pruned = plan.regime == "pruned"
        self.last_plan = plan
        dev = self.device
        weights = torch.as_tensor(packed.weights, device=dev)
        shift = torch.as_tensor(packed.shift, device=dev)
        if pruned:
            ids, vals = self._retrieve_pruned(packed, weights, shift, kk,
                                              plan, ub=prune_ub)
        elif plan.regime == "blocked":
            ids, vals = self._exec_blocked(packed.uniq_tab, weights, shift,
                                           kk)
        else:
            ids, vals = self._exec_resident(packed.uniq_batch,
                                            packed.uniq_tab, weights, shift,
                                            kk, plan)
        board = vals[:b].cpu().numpy()
        # cheap integrity gate on the [B, k] board — the full score matrix
        # never materializes on these paths
        if not np.isfinite(board).all():
            raise ScoreIntegrityError(
                f"non-finite entries in the [{b}, {kk}] score board "
                f"returned by the {plan.regime!r} regime")
        ids = ids[:b].cpu().numpy().astype(np.int64)
        exec_s = time.perf_counter() - t_start
        return RetrievalResult(
            ids=ids + self.index.doc_offset, scores=board, plan=plan,
            timings={"pack_s": packed.pack_s, "execute_s": exec_s,
                     "total_s": packed.pack_s + exec_s},
            latency_s=packed.pack_s + exec_s)

    def _exec_blocked(self, uniq_tab, weights, shift, kk):
        from ..kernels import ops
        if self.dindex.blk_tok is None:
            raise ResidencyError("blocked regime requested but this "
                                 "retriever was built without the blocked "
                                 "layout")
        return ops.bm25_retrieve_blocked(
            self.dindex.blk_tok, self.dindex.blk_loc, self.dindex.blk_sc,
            torch.as_tensor(uniq_tab, device=self.device), weights, shift,
            block_size=self.dindex.block_size, n_docs=self.n_docs, k=kk)

    def _plan_fragments(self, uniq_batch, uniq_tab, kk, sum_df, rblock):
        """The batch's full fragment table and default ids, on the device.

        Under ``plan="device"`` both are born on the device; under
        ``plan="host"`` the host plans and ships the table. Returns
        ``(desc [6, nf_pad] i32, def_ids [kk] i32, n_frags, fp)``, ``fp``
        the host ``FragmentPlan`` (None under device planning).
        """
        from ..core.retrieval import default_doc_ids
        from ..sparse.block_csr import fragment_plan, put_descriptor_array
        if self.plan_mode == "device":
            from ..sparse.fragment_device import plan_fragments_device
            desc, dids, _ = plan_fragments_device(
                self.dindex, uniq_tab, sum_df=sum_df, k=kk,
                block_size=rblock, state=self._nf_state)
            return desc, dids, int((desc[1] > 0).sum()), None
        if not self._host_postings_intact():
            raise ResidencyError('plan="host" fragment planning needs the '
                                 'host posting arrays')
        fp = fragment_plan(self.index, uniq_batch, block_size=rblock,
                           frag=self.dindex.frag)
        dids = torch.as_tensor(
            default_doc_ids(fp.vis_blocks, kk, self.n_docs, rblock),
            device=self.device)
        return (put_descriptor_array(fp.desc, device=self.device), dids,
                fp.n_frags, fp)

    def _exec_resident(self, uniq_batch, uniq_tab, weights, shift, kk,
                       plan):
        from ..core.scoring import bucket_pow2
        from ..kernels import ops
        if self.dindex.csc_doc_ids is None:
            raise ResidencyError("resident gather requested but this "
                                 "retriever was built blocked-only")
        # the accumulator window grows only if k outruns it (the board
        # needs k ≤ block height)
        rblock = bucket_pow2(kk, floor=self.block_size)
        desc, dids, plan.frags_planned, _ = self._plan_fragments(
            uniq_batch, uniq_tab, kk, plan.sum_df, rblock)
        return ops.bm25_retrieve_resident(
            desc, weights, self.dindex.csc_doc_ids, self.dindex.csc_scores,
            dids, shift, block_size=rblock, frag=self.dindex.frag, k=kk,
            n_docs=self.n_docs, double_buffer=self.double_buffer)

    def _plan_pruned(self, packed: PackedBatch, weights, kk: int, sum_df,
                     *, ub=None):
        """Seed pass + threshold compaction: the pruned regime's K3
        operands for one packed batch.

        1. **Seed** — the full fragment table is compacted to each query's
           few highest-bound blocks and scored through K1; the board's
           k-th row is a REAL document's full score per query, a certified
           lower bound on each final k-th score (the threshold τ).
        2. **Compact** — fragments of blocks whose bound reaches τ for NO
           query are compacted out before launch, and the fragment bucket
           re-sizes with the surviving work.

        Under ``plan="device"`` every step runs on the resident tensors
        (zero descriptor bytes); under ``plan="host"`` the numpy helpers
        run and the compacted table and the block bounds ship as
        descriptors. Default ids always come from the UNPRUNED
        visited-block set.

        Returns ``(desc, bounds [nb_pad, B], def_ids, n_frags,
        n_survivors)``.
        """
        from ..core.scoring import bucket_pow2
        from ..kernels.bm25_gather_score import bm25_resident_score_topk
        from ..sparse.block_csr import (block_upper_bounds,
                                        prune_fragment_plan,
                                        put_descriptor_array,
                                        seed_block_budget,
                                        select_seed_blocks)
        bm = self.dindex.bmax
        rblock = self.dindex.block_size
        b_true = packed.b
        kw = dict(block_size=rblock, frag=self.dindex.frag, k=kk,
                  n_docs=self.n_docs, double_buffer=False)
        csc = (self.dindex.csc_doc_ids, self.dindex.csc_scores)
        desc_full, dids, nf_planned, fp = self._plan_fragments(
            packed.uniq_batch, packed.uniq_tab, kk, sum_df, rblock)
        if self.plan_mode == "device":
            from ..sparse.fragment_device import (block_bounds_device,
                                                  compact_fragment_table,
                                                  prune_fragment_mask,
                                                  seed_fragment_mask)
            ub = block_bounds_device(
                bm.device, bm.scale_dev,
                torch.as_tensor(packed.uniq_tab, device=self.device),
                weights, quantized=bm.quantized)
            # pow2 batch-padding columns are sliced off after retrieval:
            # their trivial thresholds must not veto pruning (real empty
            # queries keep theirs)
            ub[:, b_true:] = -torch.inf
            seed_keep = seed_fragment_mask(desc_full, ub,
                                           n_seed=seed_block_budget(kk))
            seed_desc, n_seed = compact_fragment_table(desc_full, seed_keep)
            sv, _ = bm25_resident_score_topk(
                seed_desc[:, :bucket_pow2(max(n_seed, 1), floor=8)],
                weights, *csc, **kw)
            keep = prune_fragment_mask(desc_full, ub, sv[kk - 1])
            desc, nf_surv = compact_fragment_table(desc_full, keep)
            desc = desc[:, :bucket_pow2(max(nf_surv, 1), floor=8)]
            return desc, ub, dids, nf_planned, nf_surv
        if ub is None:
            ub = block_upper_bounds(bm, packed.uniq_tab, packed.weights)
            ub[:, b_true:] = -np.inf          # see the device branch
        if fp.n_frags:
            seed_keep = select_seed_blocks(ub, fp.vis_blocks, k=kk,
                                           block_size=rblock)
            seed_fp = prune_fragment_plan(fp, seed_keep)
            sv, _ = bm25_resident_score_topk(
                put_descriptor_array(seed_fp.desc, device=self.device),
                weights, *csc, **kw)
            tau = sv[kk - 1].cpu().numpy()                       # [B]
            fp = prune_fragment_plan(fp, (ub >= tau[None, :]).any(1))
        return (put_descriptor_array(fp.desc, device=self.device),
                put_descriptor_array(ub, device=self.device),
                dids, nf_planned, fp.n_frags)

    def _retrieve_pruned(self, packed: PackedBatch, weights, shift, kk,
                         plan, *, ub=None):
        """Block-max pruned resident execution (exact).

        :meth:`_plan_pruned` seeds the threshold and compacts the table;
        K3 then runs the survivors, skipping the spans that only become
        losers once its running board saturates mid-launch. Records
        ``frags_planned/pruned/skipped`` on ``plan``.
        """
        from ..kernels import ops
        desc, bounds, dids, nf_planned, nf_surv = self._plan_pruned(
            packed, weights, kk, plan.sum_df, ub=ub)
        ids, vals, skipped = ops.bm25_retrieve_resident_pruned(
            desc, weights, self.dindex.csc_doc_ids, self.dindex.csc_scores,
            bounds, dids, shift, block_size=self.dindex.block_size,
            frag=self.dindex.frag, k=kk, n_docs=self.n_docs)
        plan.frags_planned = nf_planned
        plan.frags_pruned = nf_planned - nf_surv
        plan.frags_skipped = int(skipped)
        return ids, vals
