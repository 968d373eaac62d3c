"""The versioned ``health()`` schema every serving layer shares.

The port's copy of ``repro.serve.health`` (framework-neutral).

Before schema 2 the serving stack had three divergent health dialects:
the device retriever reported ``batches_served``/``batches_degraded``,
the engine ``responses``/``degraded_responses``, and shard runtimes a
third mix — an operator aggregating across levels had to know which
spelling each level used. Schema 2 pins ONE envelope (see
:func:`health_envelope`); the full key contract is documented once, in
the ``repro_torch.serve`` package docstring.

Every level keeps its legacy keys alongside the common ones (pre-schema
dashboards keep reading what they read), but the common keys are the
contract new tooling should target.
"""

from __future__ import annotations

#: Version stamped into every ``health()`` report as ``"schema"``.
#: Bump when a COMMON key changes meaning or disappears; adding
#: level-specific extras is not a schema change.
HEALTH_SCHEMA = 2


def health_envelope(*, served: int, degraded: int, faults: dict,
                    queries: dict, **extra) -> dict:
    """Build a schema-2 health report.

    Common keys, identical meaning at every level (retriever, shard,
    engine, frontend):

    * ``schema``  — :data:`HEALTH_SCHEMA` (int);
    * ``served``  — responses this level completed (batches for a
      retriever, scatter-gather rounds for the engine, requests for the
      frontend);
    * ``degraded`` — how many of those were served degraded (ladder
      hops, missed shards, or missed deadlines — each level's docstring
      says which);
    * ``faults``  — typed-fault counts keyed by error class name;
    * ``queries`` — sanitizer repair counters
      (``core.retrieval.validate_query_batch`` keys).

    ``extra`` keys are level-specific and appended verbatim (legacy
    spellings, per-shard breakdowns, frontend batching stats).
    """
    return {
        "schema": HEALTH_SCHEMA,
        "served": int(served),
        "degraded": int(degraded),
        "faults": dict(faults),
        "queries": dict(queries),
        **extra,
    }


def merge_fault_counts(reports) -> dict:
    """Sum ``faults`` dicts across child reports (engine aggregation)."""
    out: dict[str, int] = {}
    for rep in reports:
        for name, n in (rep.get("faults") or {}).items():
            out[name] = out.get(name, 0) + int(n)
    return out


__all__ = ["HEALTH_SCHEMA", "health_envelope", "merge_fault_counts"]
