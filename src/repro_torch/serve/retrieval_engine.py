"""The device retriever, its exact degradation ladder, and the sharded engine.

The port's counterpart of ``repro.serve.retrieval_engine``.

:class:`DeviceRetriever` serves one shard's query path on a resident
index:

1. ``pack_batch`` runs the ``query.batch`` fault hook and the shared
   sanitizer, and turns the batch into pow2-bucketed ``[U]`` / ``[U, B]``
   query tables and a ``[B]`` §2.1 shift (host numpy);
2. ``core.retrieval.plan_retrieval`` picks full scan, gathered or pruned
   from Σ df, nnz and (under ``auto``) the survivor estimate — on the
   resident block-max table (``sparse.fragment_device``) under
   ``plan="device"``, in numpy under ``plan="host"`` — the entry rung of
   the ladder;
3. the rung runs on the device: pruned (a seed pass through K1, the
   threshold compaction, K3), resident (the fragment table — built on the
   device by ``sparse.fragment_device`` or on the host by
   ``fragment_plan`` — and K1), host (the host gather
   ``gather_posting_runs``, one counted posting upload, K4), blocked (K2),
   or the oracle (``ScipyBM25`` on the host);
4. the ``[B, k]`` board is spliced with default documents, shifted, and
   finite-checked.

Any typed failure (a :class:`~repro_torch.serve.errors.RetrievalError`)
in a rung walks the exact ladder pruned → resident → host → blocked →
oracle, under per-rung circuit breakers, a watchdog, and a seeded retry
of transient residency faults; every hop is recorded in the result's
``degradations`` and in ``health()``. Any other exception — a kernel that
does not build or launch raises ``RuntimeError`` — surfaces: no rung hides
a failing kernel.

:class:`RetrievalEngine` scatters a batch over shard runtimes (each a
``DeviceRetriever`` or the scipy scorer) on a thread pool, merges the
shards' top-k with quorum and deadline hedging, and rescales with runtime
and donor reuse. Unlike the reference, whose engine defaults to
``scorer="scipy"``, the port's defaults to ``"auto"``: an entry point of
the port runs on the card unless asked otherwise.

``DeviceRetriever(reorder=)`` serves a doc-id reordered index
(``sparse.reorder``) and maps each board back to client ids;
``DeviceRetriever.save`` / ``device_index=`` and ``RetrievalEngine.save``
/ ``load`` / ``device_indexes=`` persist and cold-start the resident
layouts (``sparse.snapshot``).
"""

from __future__ import annotations

import contextlib
import threading
import time
import warnings
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait
from dataclasses import dataclass, field, replace
from functools import partial
from typing import Callable, Sequence

import numpy as np
import torch

from ..core.index import BM25Index, reshard_index
from ..core.reference import ScipyBM25
from ..core.retrieval import merge_topk
from ..device import resolve_device
from .errors import (ExecutionStalledError, ResidencyError,
                     RetrievalConfigError, RetrievalError,
                     ScoreIntegrityError)
from .health import health_envelope, merge_fault_counts
from .overload import CircuitBreaker, RetryPolicy, WatchdogExecutor
from .results import PackedBatch, RetrievalResult


def _empty_batch(n_queries: int):
    ids = np.zeros((n_queries, 0), dtype=np.int64)
    scores = np.zeros((n_queries, 0), dtype=np.float32)
    return ids, scores


def _faults_module():
    """The fault harness, if (and only if) something already imported it."""
    import sys
    return sys.modules.get("repro_torch.serve.faults")


def _host(x) -> np.ndarray:
    """A rung's output (a torch tensor, or numpy from the oracle) on the
    host."""
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


class DeviceRetriever:
    """ONE device scorer, three regimes, the exact ladder around them.

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
    * ``regime="blocked"`` / ``"gathered"`` / ``"pruned"`` — that regime
      is the entry rung (a per-call ``regime=`` forces it strictly).

    The pruned regime is the resident gather plus exact block-max pruning
    (:meth:`_retrieve_pruned`): the same board, less work.

    The gathered regime has two executions (``gather``):

    * ``"resident"`` (default) — the fragment table names runs of the
      resident CSC tensors and K1 reads them. Where the table is built is
      the ``plan`` axis: ``"device"`` (the default on a CUDA device) builds
      it from the resident tensors (``sparse.fragment_device``), so a batch
      uploads zero posting AND zero descriptor bytes (``host_arrays="drop"``
      then releases the host posting copy); ``"host"`` (the default
      elsewhere) walks the host CSC copy with ``fragment_plan`` and ships
      the descriptor table.
    * ``"host"`` — the candidate-compacted host gather
      (``gather_posting_runs``) and K4; ships O(Σ df) postings per batch,
      with a hot-token LRU (``run_cache`` entries,
      :class:`~repro_torch.sparse.block_csr.PostingRunCache`). It is also
      the ladder's third rung.

    ``acc_block`` is the host gather's chunk height (candidate slots per
    K4 CTA). ``double_buffer`` is accepted for signature parity (one CUDA
    kernel serves both TPU schedules, which are bit-identical by
    contract). ``reuse_from`` adopts a donor ``DeviceIndex``'s resident
    tensors when the postings are unchanged (engine rescale).

    Fault handling (``on_fault``): ``"degrade"`` (default) walks the ladder
    on a typed failure; ``"raise"`` makes every call strict. ``watchdog_s``
    runs each rung under a deadline (a miss is a typed
    ``ExecutionStalledError``); ``retry_budget`` retries a transient
    ``ResidencyError`` on the same rung with seeded backoff
    (``retry_backoff_s``, ``retry_seed``); ``breaker_threshold`` faults in
    ``breaker_window_s`` open a rung's breaker for ``breaker_cooldown_s``
    (None disables the breakers).

    ``device`` defaults to ``"cuda"`` and raises without a GPU; the CPU
    tests pass ``device="cpu"``, where every kernel runs its plain twin.
    """

    def __init__(self, index: BM25Index, *, regime: str = "auto",
                 block_size: int = 512, tile: int = 512,
                 acc_block: int = 512, q_max: int = 32, frag: int = 512,
                 crossover: float | None = None, gather: str | None = None,
                 plan: str | None = None, double_buffer: bool = True,
                 host_arrays: str = "keep", run_cache: int = 256,
                 bmax_dtype: str = "auto", reorder: str = "none",
                 reuse_from=None, device_index=None,
                 on_fault: str = "degrade",
                 watchdog_s: float | None = None, retry_budget: int = 0,
                 retry_backoff_s: float = 0.005, retry_seed: int = 0,
                 breaker_threshold: int | None = 3,
                 breaker_window_s: float = 30.0,
                 breaker_cooldown_s: float = 5.0, device=None):
        from ..sparse.block_csr import DeviceIndex, PostingRunCache
        if regime not in ("auto", "blocked", "gathered", "pruned"):
            raise RetrievalConfigError(f"unknown regime {regime!r}")
        if on_fault not in ("degrade", "raise"):
            raise RetrievalConfigError(f"unknown on_fault mode {on_fault!r}")
        if watchdog_s is not None and watchdog_s <= 0:
            raise RetrievalConfigError("watchdog_s must be positive "
                                       "(or None to disable)")
        if retry_budget < 0:
            raise RetrievalConfigError("retry_budget must be >= 0")
        if breaker_threshold is not None and breaker_threshold < 1:
            raise RetrievalConfigError("breaker_threshold must be >= 1 "
                                       "(or None to disable breakers)")
        from ..sparse.reorder import REORDER_MODES
        if reorder not in REORDER_MODES:
            raise RetrievalConfigError(
                f"unknown reorder mode {reorder!r}; expected one of "
                f"{REORDER_MODES}")
        if device_index is not None:
            # ADOPT a pre-built DeviceIndex (snapshot cold start:
            # ``DeviceIndex.load`` already uploaded the resident arrays —
            # no rebuild, no re-upload). Geometry and device come from the
            # adopted index; regime / gather / plan resolve to the layouts
            # the snapshot actually holds.
            if index is None:
                index = device_index.host
            if index is None:
                raise RetrievalConfigError(
                    "device_index= adoption needs a host BM25Index (the "
                    "adopted DeviceIndex was built with host=None)")
            block_size = device_index.block_size
            frag = device_index.frag
            if device is None:
                device = device_index.device
            if regime == "auto" and device_index.blk_tok is None:
                regime = ("pruned" if device_index.bmax is not None
                          else "gathered")
            if regime == "auto" and device_index.csc_doc_ids is None:
                regime = "blocked"
            host_intact = (int(index.doc_ids.size) == int(index.indptr[-1]))
            if not host_intact:
                # the snapshot was loaded host_arrays="drop": every
                # host-side path (host gather / host planner / oracle) is
                # gone, so force the resident device plan
                gather, plan, host_arrays = "resident", "device", "keep"
        gather = "resident" if gather is None else gather
        if gather not in ("resident", "host"):
            raise RetrievalConfigError(f"unknown gather mode {gather!r}")
        if regime == "pruned" and gather != "resident":
            raise RetrievalConfigError(
                'regime="pruned" gates resident fragment reads against the '
                'block-max table — it requires gather="resident"')
        self.device = resolve_device(device)
        if device_index is not None and device_index.device != self.device:
            raise RetrievalConfigError(
                f"the adopted DeviceIndex lives on {device_index.device}, "
                f"not on {self.device}")
        if plan is None:
            plan = ("device" if gather == "resident"
                    and self.device.type == "cuda" else "host")
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
        self.index = index
        self.regime = regime
        self.gather_mode = gather
        self.plan_mode = plan
        self.double_buffer = double_buffer
        self.q_max = q_max                       # bucket floor, not a cap
        self.block_size = block_size
        self.tile = tile
        self.acc_block = acc_block               # host-gather chunk height
        self.crossover = crossover
        self.n_docs = int(index.doc_lens.size)
        self.run_cache = (PostingRunCache(run_cache)
                          if gather == "host" and run_cache > 0 else None)
        if device_index is not None:
            self.dindex = device_index
        else:
            with_csc = (regime in ("auto", "gathered", "pruned")
                        and gather == "resident")
            self.dindex = DeviceIndex.build(
                index, device=self.device, block_size=block_size, tile=tile,
                frag=frag, with_blocked=regime in ("auto", "blocked"),
                with_csc=with_csc,
                with_bmax=with_csc and regime in ("auto", "pruned"),
                bmax_dtype=bmax_dtype, reorder=reorder,
                host_arrays=host_arrays, reuse_from=reuse_from)
        if self.dindex.perm is not None and self.dindex.host is not None:
            # doc-id reordering: serve in the PERMUTED id space end to
            # end — host fragment planning, the host-gather rung and the
            # oracle rung all read the permuted host copy, so EVERY
            # ladder hop yields permuted local ids and one host-side
            # gather at the merge maps winners back to client ids (the
            # survivor estimate reads the permuted block-max table and
            # matching fragment plans)
            self.index = self.dindex.host
        self._nf_state = {}                      # steady-state nf bucket
        self.on_fault = on_fault
        # overload protection: watchdog-guarded execution, seeded bounded
        # retry on transient residency faults, and per-rung circuit
        # breakers giving the ladder memory across batches
        self.watchdog_s = watchdog_s
        self._watchdog = (WatchdogExecutor(watchdog_s,
                                           name="retriever-watchdog")
                          if watchdog_s is not None else None)
        self._retry = RetryPolicy(budget=retry_budget,
                                  base_s=retry_backoff_s, seed=retry_seed)
        self._breakers = ({hop: CircuitBreaker(
            threshold=breaker_threshold, window_s=breaker_window_s,
            cooldown_s=breaker_cooldown_s) for hop in self._LADDER}
            if breaker_threshold is not None else None)
        # observability: ladder + sanitizer counters feeding health().
        # Mutations go through _health_lock — concurrent callers (the
        # engine's pool) must leave counts that sum exactly.
        self._health_lock = threading.RLock()
        self.fault_counters: dict[str, int] = {}
        self.query_counters: dict[str, int] = {}
        self.degradation_counts: dict[str, int] = {}
        self.batches_served = 0
        self.batches_degraded = 0
        self.retry_count = 0
        self.last_queries: list[np.ndarray] = []
        self._oracle = None                      # lazy ScipyBM25 (last rung)
        if host_arrays == "drop" and self.dindex.perm is None:
            # serving now reads only metadata: a private stripped view (the
            # caller's index object is untouched). Under reordering
            # ``self.index`` is already DeviceIndex.build's stripped PERMUTED
            # metadata copy — re-stripping from the client-order index
            # would hand the merge the wrong doc_lens order.
            self.index = replace(index, doc_ids=np.zeros(0, np.int32),
                                 scores=np.zeros(0, np.float32))
        self.last_plan = None

    def warmup(self, *, k: int) -> None:
        """Run each rung this retriever enters on a one-token batch (builds
        the kernels). ``auto`` warms blocked and gathered (through the
        configured gather); the pruned kernels build on the first batch
        the cost model routes there, as in the reference."""
        if self.n_docs == 0 or k <= 0:
            return
        q = np.zeros(1, dtype=np.int32)
        kk = min(k, self.n_docs)
        if (self.regime in ("auto", "blocked")
                and self.dindex.blk_tok is not None):
            self.retrieve_batch([q], kk, regime="blocked")
        if (self.regime in ("auto", "gathered")
                and (self.gather_mode == "host"
                     or self.dindex.csc_doc_ids is not None)):
            self.retrieve_batch([q], kk, regime="gathered")
        if self.regime == "pruned":
            self.retrieve_batch([q], kk, regime="pruned")

    def health(self) -> dict:
        """Schema-2 health report (see ``repro_torch.serve``).

        ``served``/``degraded`` count BATCHES at this level; ``degraded``
        means the exact-fallback ladder hopped at least once. Level extras:
        the legacy spellings ``batches_served``/``batches_degraded``,
        ``degradations`` (hop counts keyed ``"from->to"``), ``breakers``
        (per-rung state snapshots), ``retries`` (seeded-backoff
        re-attempts that saved a hop) and ``watchdog`` (armed deadline and
        stall count).
        """
        now = time.monotonic()
        with self._health_lock:
            breakers = ({hop: br.snapshot(now)
                         for hop, br in self._breakers.items()}
                        if self._breakers is not None else {})
            return health_envelope(
                served=self.batches_served,
                degraded=self.batches_degraded,
                faults=dict(self.fault_counters),
                queries=dict(self.query_counters),
                batches_served=self.batches_served,
                batches_degraded=self.batches_degraded,
                degradations=dict(self.degradation_counts),
                breakers=breakers,
                retries=self.retry_count,
                watchdog=({"timeout_s": self._watchdog.timeout_s,
                           "stalls": self._watchdog.stalls}
                          if self._watchdog is not None else {}),
                snapshot=dict(self.dindex.snapshot_report or {}),
            )

    def save(self, path, *, algo: str | None = None) -> dict:
        """Persist this retriever's resident index (see
        ``sparse.snapshot``)."""
        return self.dindex.save(path, index=self.index, algo=algo)

    # -- the graceful-degradation ladder ---------------------------------
    #
    # Five rungs, all EXACT: pruned -> gathered-resident -> host-gather ->
    # blocked full-scan -> ScipyBM25 oracle. A typed RetrievalError in one
    # rung triggers the hop to the next AVAILABLE rung (capability depends
    # on the layouts this retriever was built with); results never change
    # across hops — only the cost. The trail is recorded in
    # ``last_plan.degradations`` and aggregated into ``health()``.

    _LADDER = ("pruned", "resident", "host", "blocked", "oracle")

    def _host_postings_intact(self) -> bool:
        """False once ``host_arrays="drop"`` released the host copy."""
        return int(self.index.doc_ids.size) == int(self.index.indptr[-1])

    def _hop_available(self, hop: str, kk: int) -> bool:
        """Can this rung run with the layouts this retriever holds?"""
        if hop == "pruned":
            return (self.gather_mode == "resident"
                    and self.dindex.bmax is not None
                    and self.dindex.csc_doc_ids is not None
                    and kk <= self.dindex.block_size)
        if hop == "resident":
            return self.dindex.csc_doc_ids is not None and (
                self.plan_mode == "device" or self._host_postings_intact())
        if hop in ("host", "oracle"):
            return self._host_postings_intact()
        if hop == "blocked":
            return self.dindex.blk_tok is not None
        return False

    def _breaker_allow(self, hop: str) -> bool:
        """May the ladder run this rung now? (half-open claims its probe)."""
        if self._breakers is None:
            return True
        with self._health_lock:
            return self._breakers[hop].allow(time.monotonic())

    def _breaker_record(self, hop: str, *, ok: bool) -> None:
        if self._breakers is None:
            return
        with self._health_lock:
            br = self._breakers[hop]
            if ok:
                br.record_success(time.monotonic())
            else:
                br.record_fault(time.monotonic())

    def trip_breaker(self, hop: str, *,
                     cooldown_s: float | None = None) -> None:
        """Operator override: force a rung's breaker open for a cooldown.

        The ladder then skips ``hop`` (recording a ``BreakerOpen`` trail
        entry) and serves exactly from the remaining rungs until the
        cooldown's half-open probe closes the breaker again. Raises
        :class:`RetrievalConfigError` when breakers are disabled
        (``breaker_threshold=None``) or ``hop`` is not a ladder rung.
        """
        if self._breakers is None:
            raise RetrievalConfigError(
                "circuit breakers are disabled on this retriever "
                "(breaker_threshold=None)")
        if hop not in self._breakers:
            raise RetrievalConfigError(
                f"unknown ladder rung {hop!r}; available: "
                f"{list(self._LADDER)}")
        with self._health_lock:
            self._breakers[hop].force_open(time.monotonic(),
                                           cooldown_s=cooldown_s)

    def _run_hop(self, hop, packed, weights, shift, kk, plan, prune_ub, *,
                 strict, guard_cm):
        """One execution attempt of a rung: the ``kernel.stall`` fault
        site, then ``_exec_hop`` — under the watchdog deadline when armed.

        The watchdog runs the body on its supervised worker thread, so the
        ladder guard scope (thread-local) is re-entered ON that thread via
        ``ctx=``; a deadline miss abandons the stalled worker and surfaces
        as :class:`ExecutionStalledError` tagged with the rung. Strict
        calls bypass the watchdog: warmup's forced-regime calls pay
        one-off kernel builds that a serving-sized deadline would misread
        as stalls.
        """
        def body():
            _f = _faults_module()
            if _f is not None and _f.ACTIVE:
                _f.fire("kernel.stall")
            return self._exec_hop(hop, packed, weights, shift, kk, plan,
                                  prune_ub)

        if self._watchdog is not None and not strict:
            try:
                return self._watchdog.run(body, ctx=guard_cm)
            except ExecutionStalledError as e:
                e.hop = hop
                raise
        with guard_cm():
            return body()

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

    def pack_batch(self, query_tokens: Sequence[np.ndarray], *,
                   strict: bool | None = None) -> PackedBatch:
        """Host half of :meth:`retrieve_batch`: fault hook + sanitizer +
        pow2 pack.

        Runs exactly the stages ``retrieve_batch`` runs before planning —
        the ``query.batch`` fault site, the shared sanitizer
        (``core.retrieval.validate_query_batch``, counting repairs into
        ``query_counters``), and ``_pack_batch``'s pow2 bucketing — so
        ``retrieve_batch(None, k, packed=pack_batch(qs))`` equals
        ``retrieve_batch(qs, k)``. ``strict`` mirrors the retrieve-side
        strictness (default: the constructor's ``on_fault``); strict packs
        surface faults instead of entering the recoverable guard scope.
        """
        from ..core.retrieval import validate_query_batch
        t0 = time.perf_counter()
        if strict is None:
            strict = self.on_fault == "raise"
        _f = _faults_module()
        # guarded faults target RECOVERABLE scopes only: a strict call
        # re-raises instead of degrading, so it never enters the guard
        guard = (_f.guard if _f is not None and not strict
                 else contextlib.nullcontext)
        if _f is not None and _f.ACTIVE:
            with guard():
                query_tokens = _f.fire("query.batch", list(query_tokens),
                                       n_vocab=self.index.n_vocab)
        # sanitize into a LOCAL counter dict, merged under the health lock
        # (concurrent callers must not drop increments)
        local_counts: dict[str, int] = {}
        qs = validate_query_batch(
            query_tokens, self.index.n_vocab, counters=local_counts,
            on_invalid="raise" if self.on_fault == "raise" else "sanitize")
        if local_counts:
            with self._health_lock:
                for key, v in local_counts.items():
                    self.query_counters[key] = \
                        self.query_counters.get(key, 0) + v
        if self.n_docs == 0:                     # empty shard post-rescale
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
            degradations=r.degradations, timings=r.timings,
            degraded=r.degraded, latency_s=r.latency_s)

    def retrieve_batch(self, query_tokens: Sequence[np.ndarray] | None,
                       k: int, *, regime: str | None = None,
                       packed: PackedBatch | None = None
                       ) -> RetrievalResult:
        """B queries -> :class:`RetrievalResult` with ``[B, k]`` boards.

        ``regime`` overrides this call's plan and makes the call STRICT —
        a typed failure surfaces instead of degrading (a forced regime that
        cannot run is an operator error, not traffic to absorb). Normal
        traffic leaves it None: the cost model picks the entry rung and any
        typed failure walks the exact ladder, recording each hop in the
        result's ``degradations`` (also ``last_plan.degradations``).
        ``on_fault="raise"`` (constructor) makes every call strict. Every
        returned board passes a ``[B, k]`` finite-check; a NaN/Inf entry
        is a :class:`~repro_torch.serve.errors.ScoreIntegrityError` —
        degraded around like any other typed fault.

        ``packed`` resumes from a prior :meth:`pack_batch` (``query_tokens``
        is then ignored and may be None).
        """
        from ..core.retrieval import plan_retrieval
        strict = regime is not None or self.on_fault == "raise"
        _f = _faults_module()
        guard = (_f.guard if _f is not None and not strict
                 else contextlib.nullcontext)
        if packed is None:
            packed = self.pack_batch(query_tokens, strict=strict)
        t_start = time.perf_counter()            # exec clock excludes pack
        qs = packed.qs
        self.last_queries = qs
        if self.n_docs == 0 or k <= 0:           # empty shard post-rescale
            ids0, sc0 = _empty_batch(len(qs))
            return RetrievalResult(
                ids=ids0, scores=sc0,
                timings={"pack_s": packed.pack_s, "execute_s": 0.0,
                         "total_s": packed.pack_s},
                latency_s=packed.pack_s)
        b = packed.b
        kk = min(k, self.n_docs)
        # the pruned regime needs the block-max table and an accumulator
        # window matching its block grid (k can outgrow the block height)
        prune_ok = self._hop_available("pruned", kk)
        want = regime or self.regime
        dev = self.device
        weights = torch.as_tensor(packed.weights, device=dev)
        shift = torch.as_tensor(packed.shift, device=dev)
        survivor_frac, prune_ub = None, None
        # the survivor estimate feeds the auto cost model and hands its
        # bounds to the pruned execution: under device planning on the
        # resident block-max table, under host planning in numpy (a FORCED
        # pruned batch under device planning needs neither)
        if prune_ok and want == "auto" and self.plan_mode == "device":
            from ..sparse.fragment_device import estimate_survivors_device
            bm = self.dindex.bmax
            survivor_frac, prune_ub = estimate_survivors_device(
                bm.device, bm.scale_dev,
                torch.as_tensor(packed.uniq_tab, device=dev), weights,
                quantized=bm.quantized, k=kk, b_true=b)
        elif prune_ok and want in ("auto", "pruned") \
                and self.plan_mode == "host":
            from ..sparse.block_csr import estimate_prune_survivors
            survivor_frac, prune_ub = estimate_prune_survivors(
                self.dindex.bmax, packed.uniq_tab, packed.weights, k=kk,
                b_true=b)
        plan = plan_retrieval(self.dindex.sum_df(packed.uniq_batch),
                              self.dindex.nnz, regime=want,
                              crossover=self.crossover, plan=self.plan_mode,
                              survivor_frac=survivor_frac)
        self.last_plan = plan
        if plan.regime == "pruned" and not prune_ok:
            if self.gather_mode != "resident":
                raise RetrievalConfigError('regime="pruned" requires '
                                           'gather="resident"')
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
            plan.regime, plan.forced = "pruned", True
            self.last_plan = plan
            entry = "resident"
        elif plan.regime == "pruned":
            entry = "pruned"
        elif plan.regime == "blocked":
            entry = "blocked"
        else:
            entry = "resident" if self.gather_mode == "resident" else "host"

        trail = plan.degradations
        hops = ((entry,) if strict
                else self._LADDER[self._LADDER.index(entry):])
        last_err = None
        with self._health_lock:
            self.batches_served += 1
        for hop in hops:
            if hop != entry and not self._hop_available(hop, kk):
                continue
            if not strict and not self._breaker_allow(hop):
                # the breaker remembers this rung's recent faults: skip it
                # WITHOUT execution and let the next rung fill the trail
                # entry's "to"
                trail.append({"from": hop, "to": None,
                              "error": "BreakerOpen",
                              "detail": f"circuit breaker open for rung "
                                        f"{hop!r} (skipped without "
                                        f"execution)"})
                continue
            if trail and trail[-1]["to"] is None:
                trail[-1]["to"] = hop
            # transient-fault retry: seeded exponential backoff with a
            # bounded budget before burning a ladder hop (strict calls
            # surface the first fault instead)
            delays = self._retry.delays() if not strict else []
            board = None
            while board is None:
                try:
                    ids, vals = self._run_hop(
                        hop, packed, weights, shift, kk, plan, prune_ub,
                        strict=strict, guard_cm=guard)
                    cand = _host(vals)[:b].astype(np.float32, copy=False)
                    # cheap integrity gate on the [B, k] board — the full
                    # score matrix never materializes on these paths
                    if not np.isfinite(cand).all():
                        raise ScoreIntegrityError(
                            f"non-finite entries in the [{b}, {kk}] "
                            f"score board returned by the {hop!r} hop")
                    board = cand
                except RetrievalError as e:
                    name = type(e).__name__
                    with self._health_lock:
                        self.fault_counters[name] = \
                            self.fault_counters.get(name, 0) + 1
                    if strict:
                        raise
                    if isinstance(e, ResidencyError) and delays:
                        with self._health_lock:
                            self.retry_count += 1
                        time.sleep(delays.pop(0))
                        continue
                    self._breaker_record(hop, ok=False)
                    trail.append({"from": hop, "to": None, "error": name,
                                  "detail": str(e)})
                    last_err = e
                    break
            if board is None:
                continue
            self._breaker_record(hop, ok=True)
            if trail:
                with self._health_lock:
                    self.batches_degraded += 1
                    for t in trail:
                        key = f"{t['from']}->{t['to']}"
                        self.degradation_counts[key] = \
                            self.degradation_counts.get(key, 0) + 1
            ids = _host(ids)[:b].astype(np.int64)
            if self.dindex.perm is not None:
                # doc-id reordering: every hop scored in the permuted id
                # space — ONE host-side gather on the [B, k] board maps
                # winners back to client ids (zero extra device bytes),
                # each tie run re-sorted by client id
                from ..sparse.reorder import remap_board
                ids = remap_board(ids, board, self.dindex.perm)
            exec_s = time.perf_counter() - t_start
            return RetrievalResult(
                ids=ids + self.index.doc_offset, scores=board, plan=plan,
                degradations=list(trail), degraded=bool(trail),
                timings={"pack_s": packed.pack_s, "execute_s": exec_s,
                         "total_s": packed.pack_s + exec_s},
                latency_s=packed.pack_s + exec_s)
        raise RetrievalError(
            f"every ladder hop failed or is unavailable (entry "
            f"{entry!r}, degradations {trail!r})") from last_err

    def _exec_hop(self, hop, packed, weights, shift, kk, plan, prune_ub):
        if hop == "pruned":
            return self._retrieve_pruned(packed, weights, shift, kk, plan,
                                         ub=prune_ub)
        if hop == "resident":
            return self._exec_resident(packed.uniq_batch, packed.uniq_tab,
                                       weights, shift, kk, plan)
        if hop == "host":
            return self._exec_host(packed.uniq_batch, packed.uniq_tab,
                                   weights, shift, kk)
        if hop == "blocked":
            return self._exec_blocked(packed.uniq_tab, weights, shift, kk)
        if hop == "oracle":
            return self._exec_oracle(packed.qs, kk)
        raise AssertionError(f"unknown ladder hop {hop!r}")

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

    def _exec_host(self, uniq_batch, uniq_tab, weights, shift, kk):
        """The host-gather rung: gather the batch's posting runs on the
        host, upload them (the per-batch posting copy the resident path
        eliminates, routed through the counting helper on purpose) and
        score them with K4."""
        from ..core.scoring import bucket_pow2
        from ..kernels import ops
        from ..sparse.block_csr import (gather_posting_runs,
                                        put_posting_arrays)
        if not self._host_postings_intact():
            raise ResidencyError("host gather needs the host posting "
                                 'arrays, which host_arrays="drop" '
                                 "released")
        # the chunk height grows only if k outruns it
        acc_block = bucket_pow2(kk, floor=self.acc_block)
        gp = gather_posting_runs(self.index, uniq_batch,
                                 acc_block=acc_block, tile=self.tile,
                                 cache=self.run_cache)
        tok, slot, sc, cand = put_posting_arrays(
            gp.token_ids, gp.slot_ids, gp.scores, gp.candidates,
            device=self.device)
        return ops.bm25_retrieve_gathered(
            tok, slot, sc, torch.as_tensor(uniq_tab, device=self.device),
            weights, cand, shift, acc_block=gp.acc_block, k=kk,
            n_docs=self.n_docs)

    def _exec_oracle(self, qs, kk):
        """Terminal rung: the paper-faithful numpy/scipy scorer.

        Host-side and slow, but it cannot fail for device reasons — the
        ladder's floor. Exact by definition: it IS the reference the
        device regimes are tested against. Ids come back shard-local (the
        caller adds ``doc_offset``, as for every other hop).
        """
        if not self._host_postings_intact():
            raise ResidencyError('oracle fallback needs the host posting '
                                 'arrays, which host_arrays="drop" '
                                 "released")
        from ..core.retrieval import topk_numpy
        if self._oracle is None:
            self._oracle = ScipyBM25(self.index)
        b = len(qs)
        ids = np.zeros((b, kk), np.int64)
        vals = np.zeros((b, kk), np.float32)
        for i, q in enumerate(qs):
            s = self._oracle.score(q)
            idx, v = topk_numpy(s[None], kk)
            ids[i], vals[i] = idx[0], v[0]
        return ids, vals

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
            if ub is None:                    # else auto's estimate made it
                ub = block_bounds_device(
                    bm.device, bm.scale_dev,
                    torch.as_tensor(packed.uniq_tab, device=self.device),
                    weights, quantized=bm.quantized)
                # pow2 batch-padding columns are sliced off after
                # retrieval: their trivial thresholds must not veto
                # pruning (real empty queries keep theirs)
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


# -- deprecated regime aliases -------------------------------------------
#
# The forced-regime subclasses predate ``DeviceRetriever(regime=...)``;
# they add nothing the keyword does not, so they are deprecation shims.
# Each warns ONCE per process, tracked in ``_ALIAS_WARNED``; tests reset it
# via :func:`_reset_alias_warnings`.

_ALIAS_WARNED: set[str] = set()


def _reset_alias_warnings() -> None:
    """Re-arm the once-per-alias deprecation warnings (test hook)."""
    _ALIAS_WARNED.clear()


def _warn_alias(name: str, regime: str) -> None:
    if name in _ALIAS_WARNED:
        return
    _ALIAS_WARNED.add(name)
    warnings.warn(
        f"{name} is deprecated; use DeviceRetriever(index, "
        f"regime={regime!r}) instead",
        DeprecationWarning, stacklevel=3)


class BlockedRetriever(DeviceRetriever):
    """Deprecated alias for ``DeviceRetriever(regime="blocked")``."""

    def __init__(self, index: BM25Index, *, block_size: int = 512,
                 tile: int = 512, q_max: int = 32, **kwargs):
        _warn_alias("BlockedRetriever", "blocked")
        super().__init__(index, regime="blocked", block_size=block_size,
                         tile=tile, q_max=q_max, **kwargs)


class GatheredRetriever(DeviceRetriever):
    """Deprecated alias for ``DeviceRetriever(regime="gathered")``."""

    def __init__(self, index: BM25Index, *, tile: int = 512,
                 acc_block: int = 512, q_max: int = 32, **kwargs):
        _warn_alias("GatheredRetriever", "gathered")
        super().__init__(index, regime="gathered", tile=tile,
                         acc_block=acc_block, q_max=q_max, **kwargs)


class PrunedRetriever(DeviceRetriever):
    """Deprecated alias for ``DeviceRetriever(regime="pruned")``."""

    def __init__(self, index: BM25Index, *, tile: int = 512,
                 q_max: int = 32, **kwargs):
        _warn_alias("PrunedRetriever", "pruned")
        super().__init__(index, regime="pruned", tile=tile, q_max=q_max,
                         **kwargs)


# partials, not the alias classes: engine-internal construction must not
# fire the deprecation warnings users are being migrated off of
_SCORERS = {"scipy": ScipyBM25, "auto": DeviceRetriever,
            "blocked": partial(DeviceRetriever, regime="blocked"),
            "gathered": partial(DeviceRetriever, regime="gathered"),
            "pruned": partial(DeviceRetriever, regime="pruned")}


@dataclass
class ShardRuntime:
    """One shard's scorer (thread-simulated shard server)."""

    index: BM25Index
    delay: Callable[[], float] | None = None     # test hook: seconds to sleep
    scorer: str = "auto"           # "scipy"|"auto"|"blocked"|"gathered"|...
    scorer_opts: dict = field(default_factory=dict)  # device-scorer kwargs

    def __post_init__(self):
        if self.scorer not in _SCORERS:
            raise RetrievalConfigError(f"unknown scorer {self.scorer!r}; "
                                       f"available: {sorted(_SCORERS)}")
        self._scorer = _SCORERS[self.scorer](self.index, **self.scorer_opts)

    def health(self) -> dict:
        """Schema-2 health report for this shard. ``served``/``degraded``
        count this shard's batches (the scipy scorer has no counters —
        zeros)."""
        sc = self._scorer
        return health_envelope(
            served=getattr(sc, "batches_served", 0),
            degraded=getattr(sc, "batches_degraded", 0),
            faults=dict(getattr(sc, "fault_counters", {})),
            queries=dict(getattr(sc, "query_counters", {})),
            scorer=self.scorer,
            batches_served=getattr(sc, "batches_served", 0),
            batches_degraded=getattr(sc, "batches_degraded", 0),
            degradations=dict(getattr(sc, "degradation_counts", {})),
            snapshot=dict(
                getattr(getattr(sc, "dindex", None), "snapshot_report",
                        None)
                or getattr(self.index, "snapshot_report", None) or {}),
        )

    def warmup(self, k: int) -> None:
        """Build the device scorer's kernels so query #1 skips the build."""
        fn = getattr(self._scorer, "warmup", None)
        if fn is not None:
            fn(k=k)

    def topk(self, query_tokens: np.ndarray, k: int
             ) -> tuple[np.ndarray, np.ndarray]:
        if self.delay is not None:
            time.sleep(self.delay())
        return self._scorer.retrieve(query_tokens, k)

    def topk_batch(self, query_batch: Sequence[np.ndarray], k: int
                   ) -> tuple[np.ndarray, np.ndarray]:
        """[B queries] -> (ids [B, k'], scores [B, k']) for this shard."""
        if self.delay is not None:
            time.sleep(self.delay())
        fn = getattr(self._scorer, "retrieve_batch", None)
        if fn is not None:                       # one launch for B
            return fn(query_batch, k)
        parts = [self._scorer.retrieve(q, k) for q in query_batch]
        kk = min((p[0].size for p in parts), default=0)
        ids = np.stack([p[0][:kk] for p in parts]) if parts else \
            np.zeros((0, 0), np.int64)
        sc = np.stack([p[1][:kk] for p in parts]) if parts else \
            np.zeros((0, 0), np.float32)
        return ids.astype(np.int64), sc.astype(np.float32)


def _same_shard(a: BM25Index, b: BM25Index) -> bool:
    """Byte-identical postings, doc range AND shift vector — safe to keep
    the resident device tensors of ``a``'s runtime for ``b``. ``doc_lens``
    must match too: a boundary moving through posting-less documents
    changes the shard's doc range without changing a single posting, and
    reusing the old runtime would then serve documents a neighbor shard
    now owns (duplicate results after the merge)."""
    return a is b or (
        int(a.doc_offset) == int(b.doc_offset)
        and np.array_equal(a.doc_lens, b.doc_lens)
        and np.array_equal(a.indptr, b.indptr)
        and np.array_equal(a.doc_ids, b.doc_ids)
        and np.array_equal(a.scores, b.scores)
        and np.array_equal(a.nonoccurrence, b.nonoccurrence))


class RetrievalEngine:
    """Hedged scatter-gather over document shards, with elastic rescale.

    Each shard runs in a :class:`ShardRuntime` (``scorer``: ``"auto"``, the
    default — a :class:`DeviceRetriever` on the card; ``"blocked"`` /
    ``"gathered"`` / ``"pruned"``, its forced-regime variants; or
    ``"scipy"``, the host reference). ``scorer_opts`` go to every device
    scorer (``device="cpu"`` runs the kernels' plain twins). A batch is
    submitted to every shard on a thread pool; the merge proceeds once a
    ``quorum`` of the shards has answered by ``deadline_s`` (late shards
    are dropped from that response, which is then ``degraded``) — the
    answered shards' winners keep their exact scores.
    ``rescale(n_shards)`` re-buckets the postings (host re-slicing,
    ``core.index.reshard_index``); runtimes whose shard is byte-identical
    are kept, and a rebuilt shard whose postings did not change adopts its
    donor's resident tensors (``last_build_stats``).
    """

    def __init__(self, shards: Sequence[BM25Index], *, k: int = 10,
                 deadline_s: float = 0.5, quorum: float = 0.75,
                 max_workers: int = 8,
                 delay: Callable[[int], Callable[[], float] | None] = None,
                 scorer: str = "auto", warmup: bool = True,
                 scorer_opts: dict | None = None,
                 device_indexes: Sequence | None = None):
        self.k = k
        self.deadline_s = deadline_s
        self.quorum = quorum
        self.scorer = scorer
        self.scorer_opts = dict(scorer_opts or {})
        self.warmup = warmup
        self._delay_factory = delay
        self._pool = ThreadPoolExecutor(max_workers=max_workers)
        self.query_counters: dict[str, int] = {}
        self._responses = 0
        self._degraded_responses = 0
        # pre-built per-shard DeviceIndexes (snapshot cold start through
        # ``RetrievalEngine.load``) — adopted by the FIRST build only;
        # rescale re-buckets postings, so loaded runtimes can't outlive it
        self._adopt = list(device_indexes or [])
        if self._adopt and len(self._adopt) != len(shards):
            raise RetrievalConfigError(
                f"device_indexes has {len(self._adopt)} entries for "
                f"{len(shards)} shards")
        self._build_runtimes(list(shards))

    def _build_runtimes(self, shards: list[BM25Index]) -> None:
        """(Re)build shard runtimes, REUSING any whose postings didn't move.

        A runtime whose index is byte-identical to a new shard keeps its
        resident tensors and built kernels (no upload, no warmup); a new
        shard whose postings equal an old runtime's (its doc range moved
        through posting-less documents) adopts that donor's resident
        layouts through ``DeviceIndex.build(reuse_from=)``.
        ``last_build_stats`` records the split.
        """
        from ..sparse.block_csr import DeviceIndex
        old = list(getattr(self, "runtimes", []))
        pool: dict[tuple, list[ShardRuntime]] = {}
        for rt in old:
            key = (int(rt.index.doc_offset), int(rt.index.doc_ids.size))
            pool.setdefault(key, []).append(rt)
        runtimes, reused, blockmax_reused = [], 0, 0
        for i, s in enumerate(shards):
            delay = self._delay_factory(i) if self._delay_factory else None
            cands = pool.get((int(s.doc_offset), int(s.doc_ids.size)), [])
            hit = next((rt for rt in cands if _same_shard(rt.index, s)),
                       None)
            if hit is not None:
                cands.remove(hit)
                hit.delay = delay
                runtimes.append(hit)
                reused += 1
                continue
            opts = self.scorer_opts
            if self.scorer != "scipy":
                # a boundary that moved through posting-LESS documents
                # changes a shard's doc range but not one posting byte:
                # the runtime cannot be reused wholesale (global ids
                # shift), but its resident layouts can
                donor = next(
                    (rt for rt in old
                     if getattr(rt._scorer, "dindex", None) is not None
                     and DeviceIndex._postings_identical(s, rt.index)),
                    None)
                if donor is not None:
                    opts = {**opts, "reuse_from": donor._scorer.dindex}
                if i < len(self._adopt) and self._adopt[i] is not None:
                    opts = {**opts, "device_index": self._adopt[i]}
            rt = ShardRuntime(s, delay=delay, scorer=self.scorer,
                              scorer_opts=opts)
            di = getattr(rt._scorer, "dindex", None)
            if di is not None and di.reused and (
                    di.reused.get("bmax") or di.reused.get("blocked")):
                blockmax_reused += 1
            if self.warmup:
                # build the device kernels at build time (and after every
                # rescale) so the first live query never pays for it
                rt.warmup(self.k)
            runtimes.append(rt)
        self.shards = shards
        self.runtimes = runtimes
        self._adopt = []                  # adoption is first-build-only
        self.last_build_stats = {"reused": reused,
                                 "built": len(shards) - reused,
                                 "blockmax_reused": blockmax_reused}

    # -- control plane ------------------------------------------------------
    def rescale(self, n_shards: int) -> None:
        """Elastic re-shard (device pool grew or shrank)."""
        self._build_runtimes(reshard_index(self.shards, n_shards))

    ENGINE_FORMAT = "repro-bm25s-engine"
    ENGINE_VERSION = 1

    def save(self, path: str, *, algo: str | None = None) -> dict:
        """Snapshot every shard runtime + the engine config under ``path``.

        Layout: ``engine.json`` (config, written last — tmp + fsync +
        ``os.replace``) next to one ``shard-NNNN/`` snapshot root per
        runtime, each an atomic generation store (see ``sparse.snapshot``).
        Device runtimes persist their resident layouts
        (``save_device_index``: padded CSC + blocked + block-max, every
        file memmap-able); scipy runtimes persist the bare index
        (``save_index``). Re-saving into the same path adds a generation
        per shard and rewrites ``engine.json`` — a crash mid-save leaves
        every shard's previous generation committed.
        """
        import json
        import os

        from ..sparse import snapshot
        os.makedirs(path, exist_ok=True)
        for i, rt in enumerate(self.runtimes):
            sdir = os.path.join(path, f"shard-{i:04d}")
            di = getattr(rt._scorer, "dindex", None)
            if di is not None:
                snapshot.save_device_index(di, sdir,
                                           index=rt._scorer.index,
                                           algo=algo)
            else:
                snapshot.save_index(rt.index, sdir, algo=algo)
        body = {"format": self.ENGINE_FORMAT,
                "version": self.ENGINE_VERSION,
                "n_shards": len(self.runtimes), "k": self.k,
                "deadline_s": self.deadline_s, "quorum": self.quorum,
                "scorer": self.scorer}
        data = json.dumps(body, indent=1, sort_keys=True).encode("utf-8")
        tmp = os.path.join(path, "engine.json.tmp")
        with open(tmp, "wb") as fh:
            fh.write(data)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, os.path.join(path, "engine.json"))
        return body

    @classmethod
    def load(cls, path: str, *, mmap: bool = False,
             host_arrays: str = "keep", verify: bool = True, corpus=None,
             **kwargs) -> "RetrievalEngine":
        """Cold-start an engine from :meth:`save` — no shard rebuilds.

        Device shards come back through ``sparse.snapshot
        .load_device_index`` (checksummed read, memmap when ``mmap=True``,
        resident tensors uploaded straight from the files, onto
        ``scorer_opts["device"]``, default ``cuda``) and are ADOPTED by
        their runtimes via ``device_index=`` — ``DeviceIndex.build`` never
        runs. Scipy shards come back through ``load_index``. ``corpus``
        (the full tokenized corpus) arms the last recovery rung: each
        shard slices its own document range out of it. ``kwargs``
        override the saved engine config (``RetrievalEngine.__init__``
        keywords).
        """
        import json
        import os

        from ..sparse import snapshot
        from .errors import SnapshotVersionError
        with open(os.path.join(path, "engine.json"),
                  encoding="utf-8") as fh:
            cfg = json.load(fh)
        if cfg.get("format") != cls.ENGINE_FORMAT:
            raise SnapshotVersionError(
                f"{path}: not a {cls.ENGINE_FORMAT} store "
                f"(format={cfg.get('format')!r})")
        v = cfg.get("version")
        if not isinstance(v, int) or not 1 <= v <= cls.ENGINE_VERSION:
            raise SnapshotVersionError(
                f"{path}: engine store version {v!r} not supported")
        scorer = kwargs.pop("scorer", cfg["scorer"])
        opts = dict(k=cfg["k"], deadline_s=cfg["deadline_s"],
                    quorum=cfg["quorum"])
        opts.update(kwargs)
        device = (opts.get("scorer_opts") or {}).get("device")
        shards, dis = [], []
        for i in range(int(cfg["n_shards"])):
            sdir = os.path.join(path, f"shard-{i:04d}")
            # corpus is the FULL corpus — each shard's loader slices its
            # own manifest-recorded doc range with global stats
            if scorer == "scipy":
                shards.append(snapshot.load_index(sdir, mmap=mmap,
                                                  verify=verify,
                                                  corpus=corpus))
            else:
                di = snapshot.load_device_index(sdir, mmap=mmap,
                                                host_arrays=host_arrays,
                                                verify=verify,
                                                corpus=corpus,
                                                device=device)
                host = di.host
                if di.perm is not None and host is not None:
                    # engine shards stay in CLIENT doc order — rescale's
                    # reshard_index and the shard-reuse keys operate on
                    # global client ids; the adopted DeviceIndex keeps
                    # its permuted host for the retriever
                    from ..sparse.reorder import unpermute_index
                    host = unpermute_index(host, di.perm)
                shards.append(host)
                dis.append(di)
        return cls(shards, scorer=scorer,
                   device_indexes=dis if dis else None, **opts)

    def health(self) -> dict:
        """One operational snapshot of the engine's fault surface.

        Schema-2 envelope: ``served``/``degraded`` count scatter-gather
        rounds and how many missed shards (quorum + deadline hedging);
        ``faults`` sums the shards' typed-fault counts; ``queries`` are the
        engine-boundary sanitizer counters. Extras: ``responses`` /
        ``degraded_responses`` (legacy spellings), ``build`` (the last
        reuse split) and ``shards`` (each :meth:`ShardRuntime.health`, with
        its ladder hops keyed ``"from->to"``).
        """
        shard_reports = [rt.health() for rt in self.runtimes]
        return health_envelope(
            served=self._responses,
            degraded=self._degraded_responses,
            faults=merge_fault_counts(shard_reports),
            queries=self.query_counters,
            responses=self._responses,
            degraded_responses=self._degraded_responses,
            build=dict(self.last_build_stats),
            shards=shard_reports,
        )

    # -- data plane ----------------------------------------------------------
    def _scatter_gather(self, submit, merge, k: int):
        """Shared hedged scatter-gather: quorum + deadline + merge."""
        t0 = time.time()
        futures = {submit(rt): i for i, rt in enumerate(self.runtimes)}
        need = max(1, int(np.ceil(self.quorum * len(self.runtimes))))
        done: dict[int, tuple[np.ndarray, np.ndarray]] = {}
        pending = set(futures)
        deadline = t0 + self.deadline_s
        while pending:
            timeout = deadline - time.time()
            if timeout <= 0 and len(done) >= need:
                break                     # quorum met, deadline passed
            finished, pending = wait(
                pending, timeout=max(timeout, 0.005),
                return_when=FIRST_COMPLETED)
            for f in finished:
                done[futures[f]] = f.result()
            if not finished and len(done) >= need:
                break
        for f in pending:                 # backfill continues off-path
            f.cancel()
        ids, scores = merge(done.values(), k)
        degraded = len(done) < len(self.runtimes)
        self._responses += 1
        self._degraded_responses += int(degraded)
        latency = time.time() - t0
        return RetrievalResult(
            ids=ids, scores=scores, degraded=degraded,
            shards_answered=len(done), latency_s=latency,
            timings={"total_s": latency})

    def _sanitize(self, query_batch):
        """Engine-boundary pass of the shared sanitizer — covers scipy
        runtimes (which have no device-scorer validation of their own)."""
        from ..core.retrieval import validate_query_batch
        n_vocab = self.shards[0].n_vocab if self.shards else 0
        return validate_query_batch(query_batch, n_vocab,
                                    counters=self.query_counters)

    def retrieve(self, query_tokens: np.ndarray, *, k: int | None = None
                 ) -> RetrievalResult:
        k = k or self.k
        query_tokens = self._sanitize([query_tokens])[0]
        return self._scatter_gather(
            lambda rt: self._pool.submit(rt.topk, query_tokens, k),
            self._merge, k)

    def retrieve_batch(self, query_batch: Sequence[np.ndarray], *,
                       k: int | None = None) -> RetrievalResult:
        """B queries in one hedged scatter-gather round.

        Each shard serves the whole batch in ONE retriever call
        (``ShardRuntime.topk_batch``); the merge is the batched stage-2
        (``core.retrieval.merge_topk_batch``). Returns a single
        :class:`RetrievalResult` with ``ids``/``scores`` of shape [B, k].
        """
        k = k or self.k
        query_batch = self._sanitize(query_batch)
        return self._scatter_gather(
            lambda rt: self._pool.submit(rt.topk_batch, query_batch, k),
            self._merge_batch, k)

    @staticmethod
    def _merge(parts, k: int) -> tuple[np.ndarray, np.ndarray]:
        # stage 2 of the paper's two-stage top-k (concatenate +
        # argpartition)
        return merge_topk(parts, k)

    @staticmethod
    def _merge_batch(parts, k: int) -> tuple[np.ndarray, np.ndarray]:
        from ..core.retrieval import merge_topk_batch
        return merge_topk_batch(parts, k)
