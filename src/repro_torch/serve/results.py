"""The result type every retrieval entry point returns.

:class:`RetrievalResult` carries

* ``ids`` / ``scores`` — the ``[B, k]`` (batched) or ``[k]``
  (single-query) winner board;
* ``plan`` — the :class:`~repro_torch.core.retrieval.RetrievalPlan` this
  batch executed under;
* ``degradations`` — the exact-fallback-ladder trail for THIS response
  (``[{"from", "to", "error", "detail"}, ...]``, empty on the healthy
  path);
* ``timings`` — seconds per serving stage, keyed by stage name
  (``"total_s"`` always present; a retriever adds ``"pack_s"`` and
  ``"execute_s"``);
* ``degraded`` / ``shards_answered`` / ``latency_s`` — the engine-level
  hedging fields (single-retriever results leave ``shards_answered``
  None and set ``degraded`` iff the ladder hopped).

**Tuple-unpack compatibility**: the result iterates (and indexes) as the
two-tuple ``(ids, scores)``, as the reference's does —

    ids, scores = retriever.retrieve_batch(queries, k)
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class RetrievalResult:
    """Winner board + the evidence it was produced on (see module doc).

    Unpacks as the legacy ``(ids, scores)`` tuple for backward
    compatibility; every other field is keyword-accessible metadata.
    """

    ids: np.ndarray
    scores: np.ndarray
    plan: object | None = None
    degradations: list = field(default_factory=list)
    timings: dict = field(default_factory=dict)
    degraded: bool = False
    shards_answered: int | None = None
    latency_s: float | None = None

    def __iter__(self):
        """Legacy two-tuple protocol: ``ids, scores = result``."""
        yield self.ids
        yield self.scores

    def __len__(self) -> int:
        return 2

    def __getitem__(self, i):
        """Legacy indexing: ``result[0]`` is ids, ``result[1]`` scores."""
        return (self.ids, self.scores)[i]


@dataclass
class PackedBatch:
    """One batch's host-side pack, ready for device execution.

    The output of :meth:`DeviceRetriever.pack_batch` — the sanitized
    query list plus every pow2-bucketed device table ``_pack_batch``
    builds (see that docstring for the bucketing invariants).
    ``retrieve_batch(..., packed=...)`` resumes exactly where
    ``pack_batch`` stopped, so pack-then-execute is bit-identical to the
    one-call path by construction.
    """

    qs: list                     # sanitized queries (validate_query_batch)
    b: int                       # true batch size (pre pow2 padding)
    uniq_batch: np.ndarray       # batch-unique token ids (sorted)
    uniq_tab: np.ndarray         # [u_max] padded unique-token table
    weights: np.ndarray          # [u_max, B_pad] per-query token weights
    shift: np.ndarray            # [B_pad] nonoccurrence shifts
    pack_s: float = 0.0          # host seconds spent packing


__all__ = ["RetrievalResult", "PackedBatch"]
