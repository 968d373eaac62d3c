"""Overload-protection primitives for the serving path.

The port's copy of ``repro.serve.overload`` (numpy and threading only),
whole: the retriever uses the breakers, the watchdog and the retry policy,
and the micro-batching front-end (``serve/frontend.py``) gates on
:class:`AdmissionController`.

BM25S's eager-scoring speed only matters if the serving path stays up
when traffic exceeds capacity or a regime starts failing repeatedly.
This module holds the four mechanisms the front-end and retriever thread
through their hot paths — all of them trade latency and availability,
NEVER scores (every ladder rung stays exact):

* :class:`AdmissionController` — a token-bucket rate gate plus a
  CoDel-style controller on measured queue delay. The bucket sheds load
  above a configured sustainable rate; the CoDel half watches the
  *standing* queue delay (the windowed minimum of ``queue_s``, the same
  number ``health()`` reports per request) and, when it stays above
  ``codel_target_s`` for a full ``codel_interval_s``, starts shedding at
  the classic ``interval / sqrt(drop_count)`` cadence until the standing
  delay drops back under target. Sheds surface as
  :class:`~repro_torch.serve.errors.AdmissionRejectedError` carrying
  ``retry_after_s`` — typed backpressure at the door, so sustained
  overload converges to bounded p99 instead of an ever-growing queue.
  Deterministic: no RNG — the shed decision is a pure function of the
  observed clock/queue-delay sequence.
* :class:`CircuitBreaker` — the per-rung memory the degradation ladder
  lacked: ``threshold`` typed faults on a rung within ``window_s`` open
  the breaker, the ladder skips the rung for ``cooldown_s`` (no
  fault-then-hop tax per batch), then ONE half-open probe batch is let
  through — success closes the breaker, another fault re-opens it.
* :class:`WatchdogExecutor` — runs device execution on a supervised
  single worker thread under a deadline. A deadline miss abandons the
  (presumed hung) worker, replaces the thread so the next rung has a
  live stage, and raises
  :class:`~repro_torch.serve.errors.ExecutionStalledError` — typed, so the
  existing exact ladder absorbs a stall like any other rung fault.
* :class:`RetryPolicy` — seeded exponential backoff with a bounded
  budget for transient faults (the retriever retries a rung on
  :class:`~repro_torch.serve.errors.ResidencyError` before hopping). The
  jitter sequence is a pure function of ``seed`` — replayable, like
  every other piece of the fault story.

Knobs live on the ``ServingFrontend`` / ``DeviceRetriever``
constructors; every shed / open / trip / restart event is a schema-2
``health()`` counter (see the ``repro_torch.serve`` package docstring).
"""

from __future__ import annotations

import math
import threading
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as _FutTimeout

import numpy as np

from .errors import ExecutionStalledError


class AdmissionController:
    """Token-bucket + CoDel-style admission gate (see module docstring).

    Not internally locked: the front-end calls :meth:`admit` /
    :meth:`observe` under its own condition lock, which also orders the
    controller's state transitions with the queue counters they gate.

    Parameters
    ----------
    rate_qps:
        Sustainable admission rate for the token bucket (None disables
        the bucket — CoDel alone then gates).
    burst:
        Bucket capacity: how many back-to-back arrivals are admitted
        from a full bucket before the rate limit bites (default
        ``max(2 * rate_qps // 10, 8)`` — a ~200ms burst allowance).
    codel_target_s:
        Standing queue-delay target (None disables the CoDel half).
        When the windowed minimum of observed ``queue_s`` stays above
        this for ``codel_interval_s``, the controller sheds.
    codel_interval_s:
        CoDel control interval: the patience window before shedding
        starts, and the base of the ``interval / sqrt(n)`` shed cadence.
    """

    def __init__(self, *, rate_qps: float | None = None,
                 burst: int | None = None,
                 codel_target_s: float | None = None,
                 codel_interval_s: float = 0.1):
        if rate_qps is not None and rate_qps <= 0:
            raise ValueError("rate_qps must be positive (or None)")
        if codel_target_s is not None and codel_target_s <= 0:
            raise ValueError("codel_target_s must be positive (or None)")
        self.rate_qps = rate_qps
        self.burst = int(burst if burst is not None
                         else max((rate_qps or 0) // 5, 8))
        self.codel_target_s = codel_target_s
        self.codel_interval_s = float(codel_interval_s)
        self._tokens = float(self.burst)
        self._t_refill: float | None = None
        # CoDel state: when did queue_s first sit above target, are we
        # shedding, when is the next shed due, how many sheds this episode
        self._first_above: float | None = None
        self._min_delay: float | None = None
        self._dropping = False
        self._drop_next = 0.0
        self._drop_count = 0
        # counters (reported through the owner's health())
        self.shed_bucket = 0
        self.shed_codel = 0
        self.admitted = 0

    # -- CoDel input -----------------------------------------------------

    def observe(self, queue_s: float, now: float) -> None:
        """Feed one measured queue delay (called as each batch forms)."""
        if self.codel_target_s is None:
            return
        if queue_s < self.codel_target_s:
            # standing delay back under target: leave the episode
            self._first_above = None
            self._dropping = False
            self._drop_count = 0
        elif self._first_above is None:
            self._first_above = now

    # -- the gate --------------------------------------------------------

    def admit(self, now: float, pending: int) -> float | None:
        """None = admitted; otherwise the ``retry_after_s`` of the shed."""
        if self.rate_qps is not None:
            if self._t_refill is None:
                self._t_refill = now
            self._tokens = min(
                float(self.burst),
                self._tokens + (now - self._t_refill) * self.rate_qps)
            self._t_refill = now
            if self._tokens < 1.0:
                self.shed_bucket += 1
                return (1.0 - self._tokens) / self.rate_qps
        if self.codel_target_s is not None:
            if (not self._dropping and self._first_above is not None
                    and now - self._first_above >= self.codel_interval_s):
                # delay stood above target a whole interval: start shedding
                self._dropping = True
                self._drop_count = 0
            if self._dropping:
                if self._drop_count == 0 or now >= self._drop_next:
                    self._drop_count += 1
                    gap = (self.codel_interval_s
                           / math.sqrt(self._drop_count))
                    self._drop_next = now + gap
                    self.shed_codel += 1
                    return gap
        if self.rate_qps is not None:
            self._tokens -= 1.0
        self.admitted += 1
        return None

    def snapshot(self) -> dict:
        """Health-report view of the gate's state and counters."""
        out = {"admitted": self.admitted, "shed_bucket": self.shed_bucket,
               "shed_codel": self.shed_codel}
        if self.rate_qps is not None:
            out.update(rate_qps=self.rate_qps, burst=self.burst,
                       tokens=round(self._tokens, 3))
        if self.codel_target_s is not None:
            out.update(codel_target_s=self.codel_target_s,
                       codel_interval_s=self.codel_interval_s,
                       codel_dropping=self._dropping)
        return out


class CircuitBreaker:
    """Per-rung breaker: closed → open → half-open → closed (or re-open).

    ``threshold`` faults within ``window_s`` open the breaker;
    :meth:`allow` then refuses the rung until ``cooldown_s`` elapses, at
    which point exactly ONE probe is allowed (half-open). A recorded
    success closes the breaker; a recorded fault re-opens it for another
    cooldown. Not internally locked — the retriever serializes calls
    under its health lock.
    """

    def __init__(self, *, threshold: int = 3, window_s: float = 30.0,
                 cooldown_s: float = 5.0):
        if threshold < 1:
            raise ValueError("threshold must be >= 1")
        self.threshold = int(threshold)
        self.window_s = float(window_s)
        self.cooldown_s = float(cooldown_s)
        self._faults: list[float] = []       # timestamps inside the window
        self._open_until: float | None = None
        self._probing = False
        self.opened = 0                      # open transitions (health)
        self.skips = 0                       # batches the open breaker shed

    def state(self, now: float) -> str:
        if self._open_until is None:
            return "closed"
        return "open" if now < self._open_until else "half-open"

    def allow(self, now: float) -> bool:
        """May the ladder run this rung now? (May claim the probe slot.)"""
        st = self.state(now)
        if st == "closed":
            return True
        if st == "open" or self._probing:
            self.skips += 1
            return False
        self._probing = True                 # the one half-open probe
        return True

    def record_success(self, now: float) -> None:
        if self._open_until is not None and self._probing:
            # probe succeeded: close
            self._open_until = None
            self._probing = False
            self._faults.clear()

    def record_fault(self, now: float) -> None:
        if self._open_until is not None:
            if self._probing:
                # probe failed: re-open for another cooldown
                self._probing = False
                self._open_until = now + self.cooldown_s
                self.opened += 1
            return
        self._faults.append(now)
        self._faults = [t for t in self._faults if now - t <= self.window_s]
        if len(self._faults) >= self.threshold:
            self._open_until = now + self.cooldown_s
            self._probing = False
            self._faults.clear()
            self.opened += 1

    def force_open(self, now: float, *, cooldown_s: float | None = None
                   ) -> None:
        """Operator override: open the breaker without waiting for faults."""
        self._open_until = now + (cooldown_s if cooldown_s is not None
                                  else self.cooldown_s)
        self._probing = False
        self.opened += 1

    def snapshot(self, now: float) -> dict:
        return {"state": self.state(now), "opened": self.opened,
                "skips": self.skips,
                "faults_in_window": len(self._faults)}


class WatchdogExecutor:
    """Deadline-guarded execution on a supervised single worker thread.

    ``run(fn, *args)`` executes on the worker and waits ``timeout_s``; a
    miss abandons the stalled worker (its eventual result is discarded),
    REPLACES the thread so the next call has a live stage, and raises
    :class:`ExecutionStalledError`. The worker's death-by-exception is
    already safe — the future carries the exception — so the supervisor
    half here is the replacement-on-stall; stage supervision for the
    front-end's former thread lives in ``frontend.py``.
    """

    def __init__(self, timeout_s: float, *, name: str = "watchdog"):
        if timeout_s <= 0:
            raise ValueError("watchdog timeout_s must be positive")
        self.timeout_s = float(timeout_s)
        self.name = name
        self.stalls = 0
        self._lock = threading.Lock()
        self._pool = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix=name)

    def run(self, fn, *args, ctx=None, timeout_s: float | None = None):
        """Run ``fn(*args)`` under the deadline; ``ctx`` (a context-manager
        factory, e.g. ``faults.guard``) is entered ON the worker thread so
        thread-local guard scopes survive the thread hop."""
        def _call():
            if ctx is None:
                return fn(*args)
            with ctx():
                return fn(*args)

        budget = self.timeout_s if timeout_s is None else float(timeout_s)
        with self._lock:
            fut = self._pool.submit(_call)
        try:
            return fut.result(timeout=budget)
        except _FutTimeout:
            with self._lock:
                self.stalls += 1
                # abandon the stalled worker; a fresh thread takes the stage
                self._pool.shutdown(wait=False)
                self._pool = ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix=self.name)
            raise ExecutionStalledError(
                f"device execution stalled past the {budget * 1e3:.0f} ms "
                f"watchdog deadline ({self.name}); the launch was "
                f"abandoned and its worker thread replaced",
                waited_s=budget) from None

    def close(self) -> None:
        with self._lock:
            self._pool.shutdown(wait=False)


class RetryPolicy:
    """Seeded exponential backoff with a bounded budget.

    ``delays()`` yields ``budget`` sleep durations:
    ``base_s * factor**i * (1 + jitter * u_i)`` with ``u_i`` drawn from
    ``default_rng(seed)`` — the whole sequence is a pure function of the
    constructor arguments, so a retried fault replays byte-for-byte.
    """

    def __init__(self, *, budget: int = 0, base_s: float = 0.005,
                 factor: float = 2.0, jitter: float = 0.5, seed: int = 0):
        if budget < 0:
            raise ValueError("retry budget must be >= 0")
        self.budget = int(budget)
        self.base_s = float(base_s)
        self.factor = float(factor)
        self.jitter = float(jitter)
        self.seed = int(seed)

    def delays(self) -> list[float]:
        rng = np.random.default_rng(self.seed)
        return [self.base_s * self.factor ** i
                * (1.0 + self.jitter * float(rng.random()))
                for i in range(self.budget)]


__all__ = ["AdmissionController", "CircuitBreaker", "WatchdogExecutor",
           "RetryPolicy"]
