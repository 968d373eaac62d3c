"""Typed error taxonomy for the serving stack.

The port's copy of ``repro.serve.errors``: the same classes with the same
bases. Every failure the serving API can surface derives from
:class:`RetrievalError` so callers catch ONE base class instead of fishing
bare ``ValueError``s out of the engine, the planners and the kernels. Each
subclass also inherits the builtin exception it shadows (``ValueError``
for query/config misuse, ``RuntimeError`` for runtime faults) so
``except ValueError`` call sites keep working.

The taxonomy maps one-to-one onto the graceful-degradation ladder in
``serve.retrieval_engine.DeviceRetriever.retrieve_batch``: a typed failure
in one rung triggers the hop to the next — every rung is exact, so
degradation never changes results, only cost. A kernel that fails to
build or launch raises a plain ``RuntimeError``, which is not typed here:
the ladder lets it surface.

* :class:`InvalidQueryError`     — malformed client input (out-of-range or
  negative token ids, non-integral dtypes, NaN) that ``on_invalid="raise"``
  surfaces instead of sanitizing.
* :class:`PlanOverflowError`     — an adaptive pow2 budget (posting bucket,
  fragment-count bucket) exhausted its cap; carries the attempted bucket
  sizes so the operator sees the regrowth trail.
* :class:`ResidencyError`        — device-resident state is missing or an
  upload failed (HBM pressure, a retriever built without the needed layout).
* :class:`ScoreIntegrityError`   — the returned ``[B, k]`` score board
  failed the cheap finite-check (NaN/Inf tiles from a bad kernel launch).
* :class:`RetrievalConfigError`  — incompatible constructor arguments
  (unknown regime/gather/plan modes, their invalid combinations, and
  modes not yet ported).
* :class:`SnapshotIntegrityError` — an on-disk snapshot failed checksum /
  size / structure verification and the recovery ladder (duplicate copy →
  rebuild layout from surviving arrays → corpus rebuild) ran dry.
* :class:`SnapshotVersionError`  — a snapshot's format name, version, or
  checksum algorithm is not one this build can read; never silently
  reinterpreted as a different layout.
* :class:`DeadlineExceededError` — a queued request missed its serving
  deadline before its micro-batch launched (the front-end's SLO miss);
  carries how long the request waited so operators can see whether the
  queue or the device was the bottleneck.
* :class:`QueueOverflowError`    — the front-end's admission queue is
  full; the submission is REJECTED at the door (backpressure) instead of
  growing an unbounded queue whose tail latency lies to every client.
* :class:`AdmissionRejectedError` — the overload-protection gate (token
  bucket / CoDel queue-delay controller) shed the submission at the
  door; carries ``retry_after_s`` so well-behaved clients back off.
* :class:`ExecutionStalledError` — device execution of a formed batch
  exceeded the watchdog deadline; the (presumed hung) launch is
  abandoned and the typed error feeds the exact degradation ladder.
* :class:`StageFailedError`      — a serving pipeline stage (the batch
  former, a pack/execute worker) died or was shut down with requests
  still pending; every affected future fails with this instead of
  hanging its client.
* :class:`TruncationWarning`     — results are exact over a truncated
  posting set (budget overflow in the convenience API); a warning, not an
  error, because callers asked for a fixed budget.
"""

from __future__ import annotations


class RetrievalError(Exception):
    """Base class for every typed serving failure."""


class InvalidQueryError(RetrievalError, ValueError):
    """Client query batch is malformed (bad token ids, dtype, or shape)."""


class PlanOverflowError(RetrievalError, RuntimeError):
    """An adaptive pow2 budget exhausted its cap without fitting the batch.

    ``attempted`` records the bucket sizes tried (ascending), ``cap`` the
    final bucket — both appear in ``str(exc)`` for operators.
    """

    def __init__(self, message: str, *, attempted: list[int] | None = None,
                 cap: int | None = None):
        super().__init__(message)
        self.attempted = list(attempted or [])
        self.cap = cap


class ResidencyError(RetrievalError, RuntimeError, ValueError):
    """Device-resident index state is missing or failed to upload.

    Also inherits ``ValueError``: the raises it replaced (asking a
    retriever built without a layout to use it) historically surfaced as
    ``ValueError``, and existing callers catch that.
    """


class ScoreIntegrityError(RetrievalError, RuntimeError):
    """The top-k score board contains non-finite entries."""


class RetrievalConfigError(RetrievalError, ValueError):
    """Incompatible or unknown retriever construction arguments."""


class SnapshotIntegrityError(RetrievalError, RuntimeError):
    """An on-disk snapshot is corrupt beyond exact recovery.

    Raised when a manifest or array file fails checksum/size verification
    AND every recovery hop (duplicate copy, rebuild-from-surviving-layout,
    corpus rebuild) is unavailable. ``corrupt`` lists the offending
    manifest entries so operators see exactly which files to inspect.
    """

    def __init__(self, message: str, *, corrupt: list[str] | None = None):
        super().__init__(message)
        self.corrupt = list(corrupt or [])


class SnapshotVersionError(RetrievalError, ValueError):
    """A snapshot's format/version/checksum-algo is unknown to this build."""


class DeadlineExceededError(RetrievalError, TimeoutError):
    """A queued request missed its serving deadline before launch.

    Raised on (or set as the exception of) a front-end request future
    when the request's SLO budget (``ServingFrontend(request_timeout_s=
    ...)``) expired while it was still waiting in the batch former.
    ``waited_s`` records how long the request sat queued — also inherits
    the builtin ``TimeoutError`` so generic timeout handlers catch it.
    """

    def __init__(self, message: str, *, waited_s: float | None = None):
        super().__init__(message)
        self.waited_s = waited_s


class QueueOverflowError(RetrievalError, RuntimeError):
    """The serving front-end's admission queue is full (backpressure).

    Raised synchronously by ``ServingFrontend.submit`` — the request was
    never admitted, so the caller can shed load or retry elsewhere.
    ``pending`` carries the queue depth at rejection time.
    """

    def __init__(self, message: str, *, pending: int | None = None):
        super().__init__(message)
        self.pending = pending


class AdmissionRejectedError(RetrievalError, RuntimeError):
    """The overload-protection admission gate shed this submission.

    Raised synchronously by ``ServingFrontend.submit`` when the token
    bucket is dry or the CoDel-style queue-delay controller is shedding —
    the request was never admitted and consumed no device work.
    ``retry_after_s`` is the gate's backoff hint (seconds until a token
    accrues, or the controller's current shedding interval); ``pending``
    carries the queue depth the gate saw.
    """

    def __init__(self, message: str, *, retry_after_s: float | None = None,
                 pending: int | None = None):
        super().__init__(message)
        self.retry_after_s = retry_after_s
        self.pending = pending


class ExecutionStalledError(RetrievalError, TimeoutError):
    """Device execution exceeded the watchdog deadline (presumed hung).

    The watchdog abandons the stalled launch (its worker thread is
    replaced; a late result is discarded) and raises this typed error,
    which feeds the exact degradation ladder like any other rung fault —
    a stall trades latency and availability, never scores. ``waited_s``
    records how long the watchdog waited; ``hop`` names the ladder rung
    whose execution stalled.
    """

    def __init__(self, message: str, *, waited_s: float | None = None,
                 hop: str | None = None):
        super().__init__(message)
        self.waited_s = waited_s
        self.hop = hop


class StageFailedError(RetrievalError, RuntimeError):
    """A serving pipeline stage died (or closed) with requests pending.

    Set as the exception of every future the failed stage stranded: a
    batch-former crash beyond its restart budget, a request in flight
    when the former died, or a queued request aborted by
    ``ServingFrontend.close(drain=False)``. ``stage`` names the stage
    ("former", "close", ...) so operators can tell a crash from an
    abort.
    """

    def __init__(self, message: str, *, stage: str | None = None):
        super().__init__(message)
        self.stage = stage


class TruncationWarning(RuntimeWarning):
    """Scores were computed over a truncated posting set (budget overflow)."""


__all__ = [
    "RetrievalError", "InvalidQueryError", "PlanOverflowError",
    "ResidencyError", "ScoreIntegrityError", "RetrievalConfigError",
    "SnapshotIntegrityError", "SnapshotVersionError",
    "DeadlineExceededError", "QueueOverflowError",
    "AdmissionRejectedError", "ExecutionStalledError", "StageFailedError",
    "TruncationWarning",
]
