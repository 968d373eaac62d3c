"""The device retriever: one scorer, two regimes, zero per-batch posting copies.

The port's counterpart of ``repro.serve.retrieval_engine`` — the query
path of ``DeviceRetriever`` on a resident index:

1. ``pack_batch`` turns the batch into pow2-bucketed ``[U]`` / ``[U, B]``
   query tables and a ``[B]`` §2.1 shift (host numpy);
2. ``core.retrieval.plan_retrieval`` picks full scan or gathered from
   Σ df versus nnz;
3. the regime runs on the device: gathered through ``fragment_plan`` and
   kernel K1 (``kernels.bm25_gather_score``), full scan through kernel K2
   (``kernels.bm25_block_score``);
4. the ``[B, k]`` board is spliced with default documents, shifted, and
   finite-checked.

Not ported yet (later slices, see ROADMAP): the pruned regime, device
fragment planning, the host-gather execution, the degradation ladder,
breakers and watchdog, shards, the front-end and snapshots. Asking for
one raises :class:`~repro_torch.serve.errors.RetrievalConfigError`; no
fall-back hides a failing kernel.
"""

from __future__ import annotations

import time
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
    """ONE device scorer, two regimes, zero per-batch posting copies.

    Builds a device-resident ``sparse.block_csr.DeviceIndex`` at
    construction (posting arrays uploaded ONCE — the block-bucketed
    full-scan layout and the CSC arrays the resident gather kernel reads)
    and plans every batch through ``core.retrieval.plan_retrieval``:

    * ``regime="auto"`` (default) — full scan O(nnz) against gathered
      O(crossover × Σ df); the decision is kept in ``self.last_plan``.
    * ``regime="blocked"`` / ``"gathered"`` — force that regime (the
      planner still runs, so the evidence is logged).

    ``gather="resident"`` and ``plan="host"`` are the only execution modes
    of this slice: the host builds each batch's fragment table from its
    CSC metadata and ships ``24 · nf`` descriptor bytes — never postings.
    ``double_buffer`` is accepted for signature parity (one CUDA kernel
    serves both TPU schedules, which are bit-identical by contract).

    ``device`` defaults to ``"cuda"`` and raises without a GPU; the CPU
    tests pass ``device="cpu"``, where every kernel runs its plain twin.
    """

    def __init__(self, index: BM25Index, *, regime: str = "auto",
                 block_size: int = 512, tile: int = 512, q_max: int = 32,
                 frag: int = 512, crossover: float | None = None,
                 gather: str | None = None, plan: str | None = None,
                 double_buffer: bool = True, device=None):
        from ..sparse.block_csr import DeviceIndex
        if regime == "pruned":
            raise RetrievalConfigError(
                'regime="pruned" is not yet ported to repro_torch')
        if regime not in ("auto", "blocked", "gathered"):
            raise RetrievalConfigError(f"unknown regime {regime!r}")
        gather = "resident" if gather is None else gather
        plan = "host" if plan is None else plan
        if gather == "host":
            raise RetrievalConfigError(
                'gather="host" is not yet ported to repro_torch')
        if gather != "resident":
            raise RetrievalConfigError(f"unknown gather mode {gather!r}")
        if plan == "device":
            raise RetrievalConfigError(
                'plan="device" is not yet ported to repro_torch')
        if plan != "host":
            raise RetrievalConfigError(f"unknown plan mode {plan!r}")
        self.device = resolve_device(device)
        self.index = index
        self.regime = regime
        self.double_buffer = double_buffer
        self.q_max = q_max                       # bucket floor, not a cap
        self.block_size = block_size
        self.crossover = crossover
        self.n_docs = int(index.doc_lens.size)
        self.dindex = DeviceIndex.build(
            index, device=self.device, block_size=block_size, tile=tile,
            frag=frag, with_blocked=regime in ("auto", "blocked"),
            with_csc=regime in ("auto", "gathered"))
        self.last_plan = None

    def warmup(self, *, k: int) -> None:
        """Run BOTH resident regimes once (builds the kernels)."""
        if self.n_docs == 0 or k <= 0:
            return
        q = np.zeros(1, dtype=np.int32)
        kk = min(k, self.n_docs)
        if self.dindex.blk_tok is not None:
            self.retrieve_batch([q], kk, regime="blocked")
        if self.dindex.csc_doc_ids is not None:
            self.retrieve_batch([q], kk, regime="gathered")

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
        if regime == "pruned":
            raise RetrievalConfigError(
                'regime="pruned" is not yet ported to repro_torch')
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
        plan = plan_retrieval(self.dindex.sum_df(packed.uniq_batch),
                              self.dindex.nnz, regime=regime or self.regime,
                              crossover=self.crossover)
        self.last_plan = plan
        dev = self.device
        weights = torch.as_tensor(packed.weights, device=dev)
        shift = torch.as_tensor(packed.shift, device=dev)
        if plan.regime == "blocked":
            ids, vals = self._exec_blocked(packed.uniq_tab, weights, shift,
                                           kk)
        else:
            ids, vals = self._exec_resident(packed.uniq_batch, weights,
                                            shift, kk, plan)
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
                                 "retriever was built gathered-only")
        return ops.bm25_retrieve_blocked(
            self.dindex.blk_tok, self.dindex.blk_loc, self.dindex.blk_sc,
            torch.as_tensor(uniq_tab, device=self.device), weights, shift,
            block_size=self.dindex.block_size, n_docs=self.n_docs, k=kk)

    def _exec_resident(self, uniq_batch, weights, shift, kk, plan):
        from ..core.retrieval import default_doc_ids
        from ..core.scoring import bucket_pow2
        from ..kernels import ops
        from ..sparse.block_csr import fragment_plan, put_descriptor_array
        if self.dindex.csc_doc_ids is None:
            raise ResidencyError("resident gather requested but this "
                                 "retriever was built blocked-only")
        # the accumulator window grows only if k outruns it (the board
        # needs k ≤ block height)
        rblock = bucket_pow2(kk, floor=self.block_size)
        fp = fragment_plan(self.index, uniq_batch, block_size=rblock,
                           frag=self.dindex.frag)
        plan.frags_planned = fp.n_frags
        dids = torch.as_tensor(
            default_doc_ids(fp.vis_blocks, kk, self.n_docs, rblock),
            device=self.device)
        desc = put_descriptor_array(fp.desc, device=self.device)
        return ops.bm25_retrieve_resident(
            desc, weights, self.dindex.csc_doc_ids, self.dindex.csc_scores,
            dids, shift, block_size=rblock, frag=self.dindex.frag, k=kk,
            n_docs=self.n_docs, double_buffer=self.double_buffer)
