"""Serving surface of the PyTorch port: the device retriever with its exact
degradation ladder, the sharded engine, the micro-batching front-end, and
their types.

Every retrieval entry point (``DeviceRetriever.retrieve`` /
``retrieve_batch``, ``RetrievalEngine.retrieve`` / ``retrieve_batch``)
returns a :class:`~repro_torch.serve.results.RetrievalResult`; every
level's ``health()`` returns the schema-2 envelope of
:func:`~repro_torch.serve.health.health_envelope`, whose common keys mean
the same at every level:

* ``schema``  — :data:`~repro_torch.serve.health.HEALTH_SCHEMA` (``2``);
* ``served``  — batches for a retriever or shard, scatter-gather rounds
  for the engine, client requests for the front-end;
* ``degraded`` — how many of those were served degraded: ladder hops
  (retriever/shard), missed shards under quorum + deadline hedging
  (engine), a hopped batch or a missed SLO (front-end). Degraded
  responses are still exact;
* ``faults``  — typed-fault counts keyed by ``RetrievalError`` subclass
  name, summed upward;
* ``queries`` — sanitizer repair counters
  (``core.retrieval.validate_query_batch`` keys).

The overload knobs are the reference's: ``watchdog_s`` (None),
``retry_budget`` (0), ``retry_backoff_s`` (0.005),
``breaker_threshold`` (3; None disables), ``breaker_window_s`` (30.0) and
``breaker_cooldown_s`` (5.0) on ``DeviceRetriever``, and the front-end's
admission gate (:class:`AdmissionController`) and ``max_stage_restarts``
(3) on :class:`ServingFrontend`. ``DeviceRetriever.save`` /
``device_index=`` and ``RetrievalEngine.save`` / ``load`` persist and
cold-start the resident layouts (``repro_torch.sparse.snapshot``).
:class:`DecodeEngine` serves the LM family: slot-based continuous
batching over ``models.transformer``.
"""

from .decode_engine import DecodeEngine
from .errors import (AdmissionRejectedError, DeadlineExceededError,
                     ExecutionStalledError, InvalidQueryError,
                     PlanOverflowError, QueueOverflowError, ResidencyError,
                     RetrievalConfigError, RetrievalError,
                     ScoreIntegrityError, SnapshotIntegrityError,
                     SnapshotVersionError, StageFailedError,
                     TruncationWarning)
from .frontend import ServingFrontend
from .health import HEALTH_SCHEMA, health_envelope
from .overload import (AdmissionController, CircuitBreaker, RetryPolicy,
                       WatchdogExecutor)
from .results import PackedBatch, RetrievalResult
from .retrieval_engine import (BlockedRetriever, DeviceRetriever,
                               GatheredRetriever, PrunedRetriever,
                               RetrievalEngine, ShardRuntime)

__all__ = ["AdmissionController", "AdmissionRejectedError",
           "BlockedRetriever", "CircuitBreaker", "DeadlineExceededError",
           "DecodeEngine",
           "DeviceRetriever", "ExecutionStalledError", "GatheredRetriever",
           "HEALTH_SCHEMA", "InvalidQueryError", "PackedBatch",
           "PlanOverflowError", "PrunedRetriever", "QueueOverflowError",
           "ResidencyError", "RetrievalConfigError", "RetrievalEngine",
           "RetrievalError", "RetrievalResult", "RetryPolicy",
           "ScoreIntegrityError", "ServingFrontend", "ShardRuntime",
           "SnapshotIntegrityError", "SnapshotVersionError",
           "StageFailedError", "TruncationWarning", "WatchdogExecutor",
           "health_envelope"]
