"""Async micro-batching front-end: single-query in, batched launches out.

The port's counterpart of ``repro.serve.frontend``, the same code with the
port's imports. The device scorers amortize kernel-launch and query-table
cost over a batch (``DeviceRetriever.retrieve_batch`` is ONE launch for B
queries), but real serving traffic arrives one query at a time. The naive
bridge — launch per arrival — pays the whole fixed cost per query; the
naive batcher — wait for B arrivals — blows the latency SLO at low rates.
:class:`ServingFrontend` is the standard middle path:

* **Admission** — :meth:`submit` enqueues one query and returns a
  ``concurrent.futures.Future`` resolving to a
  :class:`~repro_torch.serve.results.RetrievalResult` (:meth:`asubmit` is
  the ``asyncio`` face of the same future). A full queue REJECTS at the
  door with :class:`~repro_torch.serve.errors.QueueOverflowError` —
  backpressure, not an unbounded queue whose tail latency lies to every
  client.
* **Batch forming** — arrivals group into buckets keyed by their pow2
  width bucket (floor ``retriever.q_max``) and requested k: the shape keys
  ``DeviceRetriever._pack_batch`` buckets by, so the port forms the same
  batches as the reference (whose keys are its jit-cache keys). A bucket
  flushes when it reaches ``max_batch`` (size flush) or when its oldest
  request has waited ``batch_deadline_s`` (deadline flush), whichever
  comes first.
* **Pipelined execution** — each formed batch runs pack -> execute on two
  single-thread stages, so the host pack of batch i+1 OVERLAPS device
  execution of batch i (the double-buffer idiom one level above the
  kernel DMAs). The pack stage is the retriever's own
  :meth:`~DeviceRetriever.pack_batch` — the same fault hook + shared
  sanitizer + pow2 pack every direct call runs — and the execute stage
  resumes ``retrieve_batch(packed=...)``, so every frontend batch walks
  the same sanitizer and exact degradation ladder as a direct call and
  results are bit-identical by construction (tier-1 asserts this). The
  execute stage is a pool thread: the retriever names its device on every
  tensor and kernel launch, so it never relies on the thread's current
  CUDA device, and a kernel's ``RuntimeError`` fails that batch's futures
  with the error.
* **SLO accounting** — ``request_timeout_s`` arms a per-request serving
  deadline, checked when its batch forms: ``on_miss="raise"`` fails the
  future with :class:`~repro_torch.serve.errors.DeadlineExceededError`
  (carrying the wait), ``on_miss="degrade"`` (default) still serves it —
  exactly — but counts it degraded in :meth:`health`, which speaks the
  schema-2 envelope like every other serving level (see the
  ``repro_torch.serve`` package docstring).
* **Overload protection** — ``admission_rate_qps`` / ``codel_target_s``
  arm an :class:`~repro_torch.serve.overload.AdmissionController` in
  front of :meth:`submit`: load above the sustainable rate (token bucket)
  or a standing queue delay above the CoDel target is shed at the door with
  :class:`~repro_torch.serve.errors.AdmissionRejectedError` (carrying
  ``retry_after_s``) BEFORE it consumes any device work, so sustained
  overload converges to bounded p99 for admitted requests instead of an
  ever-growing queue. A stage supervisor absorbs batch-former crashes:
  in-flight requests fail typed (:class:`StageFailedError`), the stage
  restarts (bounded by ``max_stage_restarts``), and a former found dead
  at submit time is restarted after failing what it stranded —
  clients never hang on a dead stage.

The front-end wraps either a :class:`DeviceRetriever` (overlap path) or
any object with a ``retrieve_batch(batch, k)`` / ``retrieve_batch(batch,
k=...)`` surface, e.g. a :class:`RetrievalEngine` (single-stage path).
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np

from .errors import (AdmissionRejectedError, DeadlineExceededError,
                     QueueOverflowError, StageFailedError)
from .health import health_envelope
from .overload import AdmissionController
from .results import RetrievalResult


def _faults_module():
    """The fault harness, if (and only if) something already imported it."""
    import sys
    return sys.modules.get("repro_torch.serve.faults")


@dataclass
class _Request:
    """One admitted query waiting in the batch former."""

    q: np.ndarray
    k: int
    t_submit: float                      # monotonic admission time
    future: Future = field(default_factory=Future)
    waited_s: float = 0.0                # set at flush time


class ServingFrontend:
    """Micro-batching serving front-end (see module docstring).

    Parameters
    ----------
    retriever:
        The scorer every batch routes through. A ``pack_batch``-capable
        retriever gets the two-stage pack/execute pipeline; anything
        else (e.g. ``RetrievalEngine``) is called in one stage.
    k:
        Default top-k per request (``submit(k=...)`` overrides per call).
    max_batch:
        Size flush threshold — a bucket launches as soon as it holds
        this many requests.
    batch_deadline_s:
        Deadline flush threshold — the longest the OLDEST request in a
        bucket waits before its batch launches regardless of size. The
        latency/throughput knob: higher forms fuller batches.
    max_queue:
        Admission cap across all buckets; :meth:`submit` raises
        :class:`QueueOverflowError` beyond it.
    request_timeout_s / on_miss:
        Optional per-request SLO, checked when the batch forms.
        ``"raise"`` fails the future with
        :class:`DeadlineExceededError`; ``"degrade"`` serves the request
        and counts it degraded.
    autostart:
        Start the former/pipeline threads in the constructor. Tests that
        want deterministic queue states pass False and call
        :meth:`start` themselves.
    record_batches:
        Keep ``(queries, k, batch_result)`` per formed batch in
        ``self.recorded`` — the bit-identity tests and the serving
        benchmark replay these against direct ``retrieve_batch`` calls.
    admission_rate_qps / admission_burst:
        Token-bucket admission gate: sustained load above this rate is
        shed at :meth:`submit` with :class:`AdmissionRejectedError`
        (``retry_after_s`` = time until a token accrues). ``None``
        (default) disables the bucket. Size it just under measured
        capacity so admitted traffic never outruns the device.
    codel_target_s / codel_interval_s:
        CoDel-style queue-delay controller: when the standing queueing
        delay of admitted requests (each batch's oldest-request age at
        execution start) sits above ``codel_target_s`` for a full
        ``codel_interval_s``, submissions are shed at the classic
        ``interval/sqrt(n)`` cadence until the delay recovers — the
        backstop for a mis-estimated bucket rate. ``None`` disables.
    max_stage_restarts:
        Crash budget for the batch-former stage supervisor: a crash
        fails the in-flight batch typed and restarts the stage; beyond
        this many restarts the frontend stops and fails everything
        pending (:class:`StageFailedError`) instead of crash-looping.
    """

    def __init__(self, retriever, *, k: int = 10, max_batch: int = 32,
                 batch_deadline_s: float = 0.002, max_queue: int = 1024,
                 request_timeout_s: float | None = None,
                 on_miss: str = "degrade", autostart: bool = True,
                 record_batches: bool = False,
                 admission_rate_qps: float | None = None,
                 admission_burst: int | None = None,
                 codel_target_s: float | None = None,
                 codel_interval_s: float = 0.1,
                 max_stage_restarts: int = 3):
        if on_miss not in ("degrade", "raise"):
            raise ValueError(f"on_miss must be 'degrade' or 'raise', "
                             f"got {on_miss!r}")
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if max_stage_restarts < 0:
            raise ValueError("max_stage_restarts must be >= 0")
        self.retriever = retriever
        self.k = int(k)
        self.max_batch = int(max_batch)
        self.batch_deadline_s = float(batch_deadline_s)
        self.max_queue = int(max_queue)
        self.request_timeout_s = request_timeout_s
        self.on_miss = on_miss
        self.record_batches = bool(record_batches)
        self.recorded: list[tuple[list, int, RetrievalResult]] = []
        # pow2 floor of the width bucket — mirror the retriever's, so the
        # frontend's grouping key equals _pack_batch's shape key
        self._q_floor = int(getattr(retriever, "q_max", 32))
        self._two_stage = hasattr(retriever, "pack_batch")

        self.max_stage_restarts = int(max_stage_restarts)
        self._admission = (AdmissionController(
            rate_qps=admission_rate_qps, burst=admission_burst,
            codel_target_s=codel_target_s,
            codel_interval_s=codel_interval_s)
            if (admission_rate_qps is not None
                or codel_target_s is not None) else None)

        self._cond = threading.Condition()
        self._buckets: dict[tuple, list[_Request]] = {}
        self._pending = 0
        self._stopping = False
        self._started = False
        self._inflight: list[_Request] | None = None   # former mid-dispatch
        # counters (under self._cond's lock)
        self._submitted = 0
        self._served = 0
        self._degraded = 0
        self._rejected = 0
        self._shed = 0
        self._aborted = 0
        self._restarts = 0
        self._deadline_missed = 0
        self._batches = 0
        self._flushes = {"size": 0, "deadline": 0, "drain": 0}
        self._fault_counters: dict[str, int] = {}

        self._former: threading.Thread | None = None
        self._pack_pool: ThreadPoolExecutor | None = None
        self._exec_pool: ThreadPoolExecutor | None = None
        if autostart:
            self.start()

    # -- lifecycle --------------------------------------------------------

    def start(self) -> None:
        """Start the former thread + the two pipeline stages (idempotent)."""
        with self._cond:
            if self._started:
                return
            self._started = True
            self._stopping = False
        self._pack_pool = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="frontend-pack")
        self._exec_pool = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="frontend-exec")
        self._former = threading.Thread(target=self._former_loop,
                                        name="frontend-former", daemon=True)
        self._former.start()

    def close(self, *, drain: bool = True) -> None:
        """Stop the frontend. Drain-vs-abort semantics:

        ``drain=True`` (default) stops admission, SERVES everything
        already queued (the former's drain flushes), then stops the
        threads. ``drain=False`` aborts: queued requests that have not
        reached the pipeline fail immediately with a typed
        :class:`StageFailedError` (``stage="close"``); batches already
        dispatched still complete (their device work is sunk either way).

        Either way, close() never strands a caller in ``.result()``:
        after the stages stop, any future still unresolved (e.g. the
        former crashed beyond its restart budget with requests queued)
        is failed with the same typed error.
        """
        aborted: list[_Request] = []
        with self._cond:
            self._stopping = True
            if not drain:
                aborted = [r for reqs in self._buckets.values()
                           for r in reqs]
                self._buckets.clear()
                self._pending -= len(aborted)
                self._aborted += len(aborted)
                self._count_fault("StageFailedError", n=len(aborted))
            self._cond.notify_all()
        self._fail_typed(aborted, StageFailedError(
            "request aborted: ServingFrontend.close(drain=False) shut "
            "the frontend down before this request's batch formed",
            stage="close"))
        if self._former is not None:
            self._former.join()
            self._former = None
        # pack before exec: shutdown(wait=True) drains in pipeline order
        if self._pack_pool is not None:
            self._pack_pool.shutdown(wait=True)
            self._pack_pool = None
        if self._exec_pool is not None:
            self._exec_pool.shutdown(wait=True)
            self._exec_pool = None
        with self._cond:
            # sweep: whatever is STILL queued after the stages stopped
            # was stranded (a former crash past its restart budget) —
            # fail it typed rather than leave unresolved futures
            leftovers = [r for reqs in self._buckets.values()
                         for r in reqs]
            self._buckets.clear()
            self._pending -= len(leftovers)
            self._aborted += len(leftovers)
            if leftovers:
                self._count_fault("StageFailedError", n=len(leftovers))
            self._started = False
        self._fail_typed(leftovers, StageFailedError(
            "request stranded: the batch-former stage stopped before "
            "this request's batch formed", stage="close"))

    @staticmethod
    def _fail_typed(reqs: list[_Request], exc: BaseException) -> None:
        """Resolve still-pending futures with ``exc`` (counters already
        accounted; futures the pipeline already resolved are skipped)."""
        for r in reqs:
            if r.future.done():
                continue
            if r.future.set_running_or_notify_cancel():
                r.future.set_exception(exc)

    def __enter__(self) -> "ServingFrontend":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- admission --------------------------------------------------------

    def _bucket_key(self, q: np.ndarray, k: int) -> tuple:
        from ..core.scoring import bucket_pow2
        return (bucket_pow2(max(int(q.size), 1), floor=self._q_floor),
                int(k))

    def submit(self, query_tokens, k: int | None = None) -> Future:
        """Admit one query; the future resolves to its
        :class:`RetrievalResult` row (which unpacks as ``(ids, scores)``).

        Raises synchronously — the request was never admitted and
        consumed no device work — on :class:`QueueOverflowError` (queue
        full) or :class:`AdmissionRejectedError` (the overload gate
        shed it; ``.retry_after_s`` is the backoff hint).
        """
        q = np.asarray(query_tokens).ravel()
        kk = self.k if k is None else int(k)
        req = _Request(q=q, k=kk, t_submit=time.monotonic())
        revive = False
        with self._cond:
            if self._stopping or not self._started:
                raise RuntimeError("ServingFrontend is not running "
                                   "(start() it, or submit before close())")
            if self._former is not None and not self._former.is_alive():
                # former died between supervisor restarts (budget spent
                # mid-crash, or a non-restartable exit): don't queue onto
                # a dead stage — fail what it stranded and revive it if
                # the budget allows
                revive = True
            else:
                self._admit_locked(req)
        if not revive:
            return req.future
        self._revive_former()
        with self._cond:
            if self._stopping or not self._started:
                raise RuntimeError("ServingFrontend is not running "
                                   "(the batch former died beyond its "
                                   "restart budget)")
            self._admit_locked(req)
        return req.future

    def _admit_locked(self, req: _Request) -> None:
        """The admission gate proper (caller holds ``self._cond``)."""
        pending = self._pending
        _f = _faults_module()
        if _f is not None:
            # inject an apparent queue flood: the gate sees an inflated
            # depth and sheds (typed) — the real queue is untouched
            pending = int(_f.fire("queue.flood", pending))
        if self._admission is not None:
            ra = self._admission.admit(time.monotonic(), pending)
            if ra is not None:
                self._shed += 1
                self._rejected += 1
                self._count_fault("AdmissionRejectedError")
                raise AdmissionRejectedError(
                    f"admission gate shed this request ({pending} "
                    f"pending); retry after {ra * 1e3:.1f} ms",
                    retry_after_s=ra, pending=pending)
        if pending >= self.max_queue:
            self._rejected += 1
            raise QueueOverflowError(
                f"admission queue full ({pending} pending >= "
                f"max_queue={self.max_queue})", pending=pending)
        self._submitted += 1
        self._pending += 1
        self._buckets.setdefault(self._bucket_key(req.q, req.k),
                                 []).append(req)
        self._cond.notify_all()

    def _revive_former(self) -> None:
        """Replace a dead former thread found at submit time.

        Fails every request the dead stage stranded (typed), then either
        restarts the stage (budget permitting) or marks the frontend
        stopped so subsequent submits raise instead of hanging.
        """
        with self._cond:
            if self._former is not None and self._former.is_alive():
                return                       # raced with another reviver
            stranded = [r for reqs in self._buckets.values() for r in reqs]
            self._buckets.clear()
            self._pending -= len(stranded)
            if stranded:
                self._count_fault("StageFailedError", n=len(stranded))
            out_of_budget = self._restarts >= self.max_stage_restarts
            if out_of_budget:
                self._stopping = True
                self._started = False
            else:
                self._restarts += 1
        self._fail_typed(stranded, StageFailedError(
            "request stranded: the batch-former thread died before this "
            "request's batch formed", stage="former"))
        if out_of_budget:
            return
        former = threading.Thread(target=self._former_loop,
                                  name="frontend-former", daemon=True)
        with self._cond:
            self._former = former
        former.start()

    async def asubmit(self, query_tokens, k: int | None = None
                      ) -> RetrievalResult:
        """``await``-able :meth:`submit` (asyncio face of the same future)."""
        import asyncio
        return await asyncio.wrap_future(self.submit(query_tokens, k=k))

    # -- batch forming ----------------------------------------------------

    def _pick_flush(self, now: float):
        """(key, reason) of the ripest bucket, or None if nothing's ripe."""
        for key, reqs in self._buckets.items():
            if len(reqs) >= self.max_batch:
                return key, "size"
        for key, reqs in self._buckets.items():
            if reqs and now - reqs[0].t_submit >= self.batch_deadline_s:
                return key, "deadline"
        if self._stopping:
            for key, reqs in self._buckets.items():
                if reqs:
                    return key, "drain"
        return None

    def _next_wait(self, now: float) -> float | None:
        """Seconds until the earliest deadline flush (None: sleep forever)."""
        oldest = [reqs[0].t_submit for reqs in self._buckets.values()
                  if reqs]
        if not oldest:
            return None
        return max(min(oldest) + self.batch_deadline_s - now, 0.0)

    def _former_loop(self) -> None:
        """Supervised former stage: crashes fail the in-flight batch
        typed and restart the iteration, bounded by
        ``max_stage_restarts`` — a crash-looping former stops the
        frontend instead of spinning."""
        while True:
            try:
                if self._former_step():
                    return
            except BaseException as e:      # noqa: BLE001 — supervisor
                if self._supervise_former(e):
                    return

    def _former_step(self) -> bool:
        """One former iteration; True = clean exit (stopping + drained)."""
        _f = _faults_module()
        if _f is not None:
            with _f.guard():
                # thread-death injection point: nothing is in flight at
                # the top of the iteration, so supervisor recovery is
                # exact — queued requests just ride the next iteration
                _f.fire("frontend.former", None)
        with self._cond:
            while True:
                now = time.monotonic()
                pick = self._pick_flush(now)
                if pick is not None:
                    break
                if self._stopping:
                    return True
                self._cond.wait(timeout=self._next_wait(now))
            key, reason = pick
            whole = self._buckets.pop(key)
            reqs, tail = whole[:self.max_batch], whole[self.max_batch:]
            if tail:
                # burst admitted between flushes: the overflow stays
                # queued as the bucket's next generation
                self._buckets[key] = tail
            self._flushes[reason] += 1
            self._batches += 1
            self._inflight = reqs
        try:
            self._dispatch(reqs, key[1], now)
        finally:
            with self._cond:
                self._inflight = None
        return False

    def _supervise_former(self, exc: BaseException) -> bool:
        """Absorb one former crash; True = the loop should exit.

        The in-flight batch (if the crash hit mid-dispatch) fails typed;
        within budget the loop just continues (the stage logically
        restarts in place); beyond it everything pending fails typed and
        the frontend stops.
        """
        with self._cond:
            inflight = self._inflight or []
            self._inflight = None
            victims = [r for r in inflight if not r.future.done()]
            self._pending -= len(victims)
            if victims:
                self._count_fault("StageFailedError", n=len(victims))
            out_of_budget = self._restarts >= self.max_stage_restarts
            if out_of_budget:
                stranded = [r for reqs in self._buckets.values()
                            for r in reqs]
                self._buckets.clear()
                self._pending -= len(stranded)
                if stranded:
                    self._count_fault("StageFailedError", n=len(stranded))
                self._stopping = True
                self._started = False
            else:
                stranded = []
                self._restarts += 1
            self._cond.notify_all()
        self._fail_typed(victims, StageFailedError(
            f"batch was in flight when the former stage crashed "
            f"({type(exc).__name__}: {exc})", stage="former"))
        self._fail_typed(stranded, StageFailedError(
            f"request stranded: the former stage exhausted its restart "
            f"budget (max_stage_restarts={self.max_stage_restarts}) on "
            f"{type(exc).__name__}: {exc}", stage="former"))
        return out_of_budget

    def _dispatch(self, reqs: list[_Request], kk: int, t_flush: float
                  ) -> None:
        """SLO-check a formed batch, then hand it to the pipeline."""
        live = []
        for r in reqs:
            r.waited_s = t_flush - r.t_submit
            missed = (self.request_timeout_s is not None
                      and r.waited_s > self.request_timeout_s)
            if missed and self.on_miss == "raise":
                with self._cond:
                    self._deadline_missed += 1
                    self._pending -= 1
                    self._count_fault("DeadlineExceededError")
                if r.future.set_running_or_notify_cancel():
                    r.future.set_exception(DeadlineExceededError(
                        f"request waited {r.waited_s * 1e3:.2f} ms > "
                        f"timeout {self.request_timeout_s * 1e3:.2f} ms "
                        f"before its micro-batch launched",
                        waited_s=r.waited_s))
                continue
            if missed:
                with self._cond:
                    self._deadline_missed += 1
            live.append(r)
        if not live:
            return
        if self._two_stage:
            self._pack_pool.submit(self._pack_stage, live, kk)
        else:
            self._exec_pool.submit(self._exec_stage, live, kk, None)

    # -- pipeline stages --------------------------------------------------

    def _pack_stage(self, reqs: list[_Request], kk: int) -> None:
        """Host pack (stage 1) — overlaps the previous batch's execute."""
        try:
            packed = self.retriever.pack_batch([r.q for r in reqs])
        except BaseException as e:
            self._fail(reqs, e)
            return
        self._exec_pool.submit(self._exec_stage, reqs, kk, packed)

    def _exec_stage(self, reqs: list[_Request], kk: int, packed) -> None:
        """Device execute (stage 2) + per-request future resolution."""
        if self._admission is not None and reqs:
            # CoDel input: this batch's oldest-request age at execution
            # start IS the standing queueing delay (the exec-pool queue
            # is the real backlog under overload, not the former's)
            now = time.monotonic()
            with self._cond:
                self._admission.observe(
                    now - min(r.t_submit for r in reqs), now)
        try:
            if packed is not None:
                res = self.retriever.retrieve_batch(None, kk,
                                                    packed=packed)
            else:
                res = self.retriever.retrieve_batch([r.q for r in reqs],
                                                    k=kk)
        except BaseException as e:
            self._fail(reqs, e)
            return
        if self.record_batches:
            self.recorded.append(([r.q for r in reqs], kk, res))
        t_done = time.monotonic()
        batch_degraded = bool(getattr(res, "degraded", False))
        for i, r in enumerate(reqs):
            missed = (self.request_timeout_s is not None
                      and r.waited_s > self.request_timeout_s)
            row = RetrievalResult(
                ids=res.ids[i], scores=res.scores[i],
                plan=getattr(res, "plan", None),
                degradations=list(getattr(res, "degradations", [])),
                degraded=batch_degraded or missed,
                shards_answered=getattr(res, "shards_answered", None),
                latency_s=t_done - r.t_submit,
                timings={**getattr(res, "timings", {}),
                         "queue_s": r.waited_s,
                         "total_s": t_done - r.t_submit})
            with self._cond:
                self._pending -= 1
                self._served += 1
                if row.degraded:
                    self._degraded += 1
            if not r.future.set_running_or_notify_cancel():
                continue                 # client cancelled while queued
            r.future.set_result(row)

    def _fail(self, reqs: list[_Request], exc: BaseException) -> None:
        with self._cond:
            self._pending -= len(reqs)
            self._count_fault(type(exc).__name__, n=len(reqs))
        for r in reqs:
            if r.future.set_running_or_notify_cancel():
                r.future.set_exception(exc)

    def _count_fault(self, name: str, n: int = 1) -> None:
        self._fault_counters[name] = self._fault_counters.get(name, 0) + n

    # -- observability ----------------------------------------------------

    def health(self) -> dict:
        """Schema-2 health report (see the ``repro_torch.serve`` package
        docstring).

        ``served``/``degraded`` count client REQUESTS (a degraded request
        either rode a ladder-hopped batch or missed its SLO under
        ``on_miss="degrade"``; both are still exact). Frontend extras:
        ``pending``/``submitted``/``rejected``/``deadline_missed``,
        ``batches`` + per-reason ``flushes``, mean formed-batch size, the
        batching knobs, overload counters (``shed`` requests the
        admission gate refused — also counted in ``rejected`` —
        ``aborted`` futures failed by close/crash sweeps, ``restarts``
        of the former stage, and the gate's ``admission`` snapshot), and
        the wrapped retriever's own report under ``retriever``.
        """
        with self._cond:
            batches = self._batches
            stats = dict(
                pending=self._pending, submitted=self._submitted,
                rejected=self._rejected,
                deadline_missed=self._deadline_missed,
                batches=batches, flushes=dict(self._flushes),
                served=self._served, degraded=self._degraded,
                shed=self._shed, aborted=self._aborted,
                restarts=self._restarts,
                admission=(self._admission.snapshot()
                           if self._admission is not None else {}),
                faults=dict(self._fault_counters))
        sub = (self.retriever.health()
               if hasattr(self.retriever, "health") else {})
        return health_envelope(
            served=stats["served"], degraded=stats["degraded"],
            faults=stats["faults"],
            queries=dict(getattr(self.retriever, "query_counters", {})),
            pending=stats["pending"], submitted=stats["submitted"],
            rejected=stats["rejected"],
            deadline_missed=stats["deadline_missed"],
            batches=stats["batches"],
            flushes=stats["flushes"],
            mean_batch=(stats["served"] / batches if batches else 0.0),
            max_batch=self.max_batch,
            batch_deadline_s=self.batch_deadline_s,
            shed=stats["shed"], aborted=stats["aborted"],
            restarts=stats["restarts"], admission=stats["admission"],
            retriever=sub,
        )


__all__ = ["ServingFrontend"]
