"""Deterministic, seedable fault injection for the serving stack.

The port of ``repro.serve.faults``: the same :data:`SITES` with the same
kinds, the same :class:`FaultSpec` semantics and the same seeded
corruptions. The degradation ladder (``DeviceRetriever.retrieve_batch``)
is only trustworthy if every rung can actually be exercised; this module
provides the failure half of that contract. Injection points are
registered INSIDE the port's production code paths but cost nothing when
no fault is armed: each site peeks at ``sys.modules`` for
``repro_torch.serve.faults`` and skips the hook entirely unless
:data:`ACTIVE` is non-empty, so importing the serving stack never pulls
the harness in and the hot path pays one dict lookup only while a fault is
armed.

Fault sites and their call sites in the port
--------------------------------------------

* ``residency.put_posting_arrays`` (``residency``), in
  ``sparse.block_csr.put_posting_arrays`` — the posting upload raises
  :class:`~.errors.ResidencyError` (simulated device-memory pressure or a
  failed copy).
* ``plan.fragments_device`` (``overflow``), in
  ``sparse.fragment_device.plan_fragments_device`` — the device fragment
  planner reports nf-bucket exhaustion as
  :class:`~.errors.PlanOverflowError`.
* ``kernel.resident_pruned`` (``nan_board`` / ``inf_board``), in
  ``kernels.ops.bm25_retrieve_resident_pruned`` after K3's board — one
  entry of the ``[B, k]`` score board becomes NaN / +Inf (caught by the
  retriever's finite-check, surfaced as
  :class:`~.errors.ScoreIntegrityError`).
* ``query.batch`` (``query.range`` / ``query.negative`` / ``query.dtype``
  / ``query.ragged``), in ``DeviceRetriever.pack_batch`` — the incoming
  batch is corrupted before validation (out-of-range ids, negative ids,
  dtype drift, None/ragged entries).
* ``kernel.stall`` (``stall``), in ``DeviceRetriever._run_hop`` — device
  execution of a rung hangs for a deterministic 150–250 ms. Under a
  retriever watchdog the stall surfaces as ``ExecutionStalledError`` and
  the ladder hops; without one it is only latency.
* ``snapshot.write`` (``torn_write``), ``snapshot.manifest``
  (``manifest_corrupt`` / ``stale_version``) and ``snapshot.array``
  (``truncate`` / ``bit_flip``) mutate the real files on disk, as in the
  reference: ``sparse.snapshot`` fires the first before its commit point
  and the other two while it verifies a load (inside :func:`guard`).
* ``frontend.former`` (``thread_death``), at the top of a
  ``ServingFrontend`` former iteration inside :func:`guard` — the former
  thread dies with a ``RuntimeError`` that only the stage supervisor
  absorbs; and ``queue.flood`` (``flood``), in ``ServingFrontend.submit``
  outside any guard (so only an unguarded spec fires) — the depth the
  admission gate reads is inflated and the request is shed typed.

Every mutation is a pure function of ``(seed, fire_count)`` — re-running
the same test with the same spec replays the same corruption, byte for
byte. Specs are **guarded** by default: they fire only inside a
retriever's ladder scope (:func:`guard`), so arming a fault globally
cannot crash code that has no recovery path — index construction,
warmup's forced-regime calls, and strict (``on_fault="raise"`` or
per-call ``regime=``) retrievals all stay outside the guard. Pass
``guarded=False`` to hit a site wherever it is called (required when
testing strict-mode surfacing).

Example
-------

>>> import numpy as np
>>> from repro_torch.core import BM25Params, build_index
>>> from repro_torch.serve import DeviceRetriever
>>> from repro_torch.serve.faults import inject_faults
>>> rng = np.random.default_rng(0)
>>> corpus = [rng.integers(0, 32, size=8).astype(np.int32)
...           for _ in range(40)]
>>> idx = build_index(corpus, 32, params=BM25Params(method="lucene"))
>>> dr = DeviceRetriever(idx, regime="gathered", gather="host",
...                      block_size=16, tile=16, acc_block=16, q_max=8,
...                      device="cpu")
>>> q = [np.array([1, 2, 3], dtype=np.int32)]
>>> ids0, vals0 = dr.retrieve_batch(q, 5)          # healthy run
>>> with inject_faults({"site": "residency.put_posting_arrays",
...                     "kind": "residency", "times": 1, "seed": 7}):
...     ids1, vals1 = dr.retrieve_batch(q, 5)      # upload fails once
>>> bool(np.allclose(vals0, vals1, atol=1e-5))     # ladder recovered,
True
>>> dr.last_plan.degradations[0]["to"]             # via the oracle hop
'oracle'

How to add an injection point
-----------------------------

1. Pick a site name (``"<layer>.<function>"``) and add it to
   :data:`SITES` with its fault kinds (and to the reference's, whose
   dict this one must equal).
2. At the production call site, peek-and-fire (import-free on the
   healthy path)::

       import sys
       _f = sys.modules.get("repro_torch.serve.faults")
       if _f is not None and _f.ACTIVE:
           payload = _f.fire("my.site", payload, extra_ctx=...)

   ``fire`` either raises the typed error for the armed kind or returns
   the (possibly corrupted) payload.
3. Give the fault a recovery rung in the ladder (or document that strict
   mode is the only option) and cover it in ``tests/test_torch_ladder.py``.
"""

from __future__ import annotations

import contextlib
import sys
import threading
from dataclasses import dataclass, field

import numpy as np
import torch

from .errors import PlanOverflowError, ResidencyError

SITES: dict[str, tuple[str, ...]] = {
    "residency.put_posting_arrays": ("residency",),
    "plan.fragments_device": ("overflow",),
    "kernel.resident_pruned": ("nan_board", "inf_board"),
    "query.batch": ("query.range", "query.negative", "query.dtype",
                    "query.ragged"),
    "snapshot.write": ("torn_write",),
    "snapshot.manifest": ("manifest_corrupt", "stale_version"),
    "snapshot.array": ("truncate", "bit_flip"),
    "kernel.stall": ("stall",),
    "frontend.former": ("thread_death",),
    "queue.flood": ("flood",),
}


@dataclass
class FaultSpec:
    """One armed fault: where, what, how often, and its deterministic seed."""

    site: str
    kind: str
    times: int = 1              # max firings while armed (bounded chaos)
    seed: int = 0               # corruption PRNG seed (mutating kinds)
    guarded: bool = True        # fire only inside a ladder guard() scope
    fired: int = field(default=0, compare=False)

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(f"unknown fault site {self.site!r}; "
                             f"available: {sorted(SITES)}")
        if self.kind not in SITES[self.site]:
            raise ValueError(f"site {self.site!r} has no kind "
                             f"{self.kind!r}; available: {SITES[self.site]}")


ACTIVE: list[FaultSpec] = []          # armed specs (inject_faults scope)
FIRED: dict[str, int] = {}            # site -> total fires (observability)

_tls = threading.local()


@contextlib.contextmanager
def guard():
    """Mark a ladder scope: guarded specs fire only inside this context."""
    depth = getattr(_tls, "depth", 0)
    _tls.depth = depth + 1
    try:
        yield
    finally:
        _tls.depth = depth


def in_guard() -> bool:
    return getattr(_tls, "depth", 0) > 0


def _normalize(spec) -> list[FaultSpec]:
    if isinstance(spec, FaultSpec):
        return [spec]
    if isinstance(spec, dict):
        return [FaultSpec(**spec)]
    return [s if isinstance(s, FaultSpec) else FaultSpec(**s) for s in spec]


@contextlib.contextmanager
def inject_faults(spec):
    """Arm one or more faults for the duration of the ``with`` block.

    ``spec`` is a :class:`FaultSpec`, a dict of its fields, or a list of
    either. Yields the list of armed specs (inspect ``spec.fired`` after
    the block to see how many times each actually hit). See the module
    docstring for a runnable end-to-end example.
    """
    specs = _normalize(spec)
    ACTIVE.extend(specs)
    try:
        yield specs
    finally:
        for s in specs:
            ACTIVE.remove(s)


def _match(site: str) -> FaultSpec | None:
    for s in ACTIVE:
        if s.site == site and s.fired < s.times and (not s.guarded
                                                     or in_guard()):
            return s
    return None


def _corrupt_board(vals, kind: str, rng: np.random.Generator):
    """Poison one entry of the [B, k] score board (NaN or +Inf).

    ``vals`` is a torch tensor; the poisoned copy stays on its device.
    Always hits row 0: the batch dimension is pow2-padded and padding
    rows are sliced off before the finite-check, so a poisoned padding
    row would be an injected fault nobody can observe. Row 0 is real in
    every non-empty batch.
    """
    if vals.numel() == 0:
        return vals
    out = vals.to(torch.float32, copy=True)
    col = int(rng.integers(0, out.shape[-1]))
    out[(0,) * (out.dim() - 1) + (col,)] = (float("nan")
                                           if kind == "nan_board"
                                           else float("inf"))
    return out


def _corrupt_queries(queries, kind: str, rng: np.random.Generator,
                     n_vocab: int):
    """Return a corrupted copy of the client batch (payload untouched)."""
    out = [np.array(q, copy=True) if q is not None else None
           for q in queries]
    live = [i for i, q in enumerate(out)
            if q is not None and np.asarray(q).size]
    if not live:
        return out
    i = int(live[rng.integers(0, len(live))])
    q = np.asarray(out[i])
    j = int(rng.integers(0, q.size))
    if kind == "query.range":
        q = q.astype(np.int64, copy=True)
        q.flat[j] = n_vocab + int(rng.integers(1, 100))
        out[i] = q
    elif kind == "query.negative":
        q = q.astype(np.int64, copy=True)
        q.flat[j] = -1 - int(rng.integers(0, 100))
        out[i] = q
    elif kind == "query.dtype":
        out[i] = q.astype(np.float64)          # integral drift: recastable
    elif kind == "query.ragged":
        out[i] = None                          # dropped-by-client entry
        if len(live) > 1:
            i2 = int(live[(live.index(i) + 1) % len(live)])
            out[i2] = np.asarray(out[i2]).reshape(1, -1)   # 2-D drift
    return out


def _corrupt_snapshot_file(path, kind: str, rng: np.random.Generator):
    """Mutate a snapshot file on disk; pure function of the rng state.

    ``path`` may be a list of candidate files (the payload the snapshot
    loader/writer passes) — one is chosen by the rng, so which file a
    chaos run corrupts varies with the seed while staying replayable.
    ``torn_write`` / ``truncate`` chop the file to a strict prefix (at
    least one byte short); ``bit_flip`` flips one bit at an rng-chosen
    offset; ``manifest_corrupt`` is a bit flip too (a torn or flipped
    manifest both surface as parse/checksum failures);
    ``stale_version`` rewrites the manifest with an unknown future
    version and a RECOMPUTED manifest checksum, so the version check —
    not the checksum — is what trips.
    """
    import os
    if isinstance(path, (list, tuple)):
        path = path[int(rng.integers(0, len(path)))]
    path = str(path)
    size = os.path.getsize(path)
    if kind == "stale_version":
        import json

        from ..sparse import snapshot as _snap
        with open(path, encoding="utf-8") as fh:
            manifest = json.load(fh)
        manifest["version"] = int(manifest.get("version", 0)) + 999
        manifest.pop("manifest_checksum", None)
        manifest["manifest_checksum"] = _snap.manifest_checksum(manifest)
        with open(path, "w", encoding="utf-8") as fh:
            json.dump(manifest, fh)
        return
    if size == 0:
        return
    if kind in ("torn_write", "truncate"):
        keep = int(rng.integers(0, size))      # strict prefix: 0..size-1
        os.truncate(path, keep)
        return
    # bit_flip / manifest_corrupt: flip one bit in place
    off = int(rng.integers(0, size))
    bit = int(rng.integers(0, 8))
    with open(path, "r+b") as fh:
        fh.seek(off)
        byte = fh.read(1)
        fh.seek(off)
        fh.write(bytes([byte[0] ^ (1 << bit)]))


def fire(site: str, payload=None, *, n_vocab: int | None = None):
    """Hook called by instrumented sites. Raises or transforms ``payload``.

    Returns ``payload`` (possibly a corrupted copy) when no raising fault
    is armed for ``site``. Deterministic: the corruption PRNG is seeded
    from ``(spec.seed, spec.fired)``.
    """
    spec = _match(site)
    if spec is None:
        return payload
    spec.fired += 1
    FIRED[site] = FIRED.get(site, 0) + 1
    rng = np.random.default_rng((spec.seed, spec.fired))
    if spec.kind == "residency":
        raise ResidencyError(
            f"injected: posting-array upload failed at {site} "
            f"(spec seed={spec.seed}, fire #{spec.fired})")
    if spec.kind == "overflow":
        raise PlanOverflowError(
            f"injected: nf-bucket regrowth exhausted at {site} "
            f"(spec seed={spec.seed}, fire #{spec.fired})",
            attempted=[8, 16, 32], cap=32)
    if spec.kind in ("nan_board", "inf_board"):
        return _corrupt_board(payload, spec.kind, rng)
    if spec.kind.startswith("query."):
        return _corrupt_queries(payload, spec.kind, rng,
                                n_vocab=int(n_vocab or 0) or (1 << 30))
    if site.startswith("snapshot."):
        _corrupt_snapshot_file(payload, spec.kind, rng)
        if spec.kind == "torn_write":
            raise OSError(
                f"injected: process killed mid-write at {site} "
                f"({payload}; spec seed={spec.seed}, fire #{spec.fired})")
        return payload
    if spec.kind == "stall":
        # a wedged device launch: block the calling (worker) thread for a
        # deterministic 150-250ms — far past any test watchdog, bounded
        # enough that an unguarded retriever merely slows down (exact
        # recovery either way, which is what makes it chaos-pool safe)
        import time as _time
        _time.sleep(0.15 + 0.1 * float(rng.random()))
        return payload
    if spec.kind == "thread_death":
        # deliberately NOT a RetrievalError: simulates an arbitrary bug
        # escaping the former loop, which only the stage supervisor
        # (not the typed ladder) can absorb
        raise RuntimeError(
            f"injected: former thread death at {site} "
            f"(spec seed={spec.seed}, fire #{spec.fired})")
    if spec.kind == "flood":
        # inflate the queue depth the admission gate is about to read —
        # a simulated arrival burst, sized by the spec's seeded rng
        return int(payload or 0) + 10_000 + int(rng.integers(0, 1000))
    raise AssertionError(f"unhandled fault kind {spec.kind!r}")


def peek():
    """The module handle instrumented sites use, or None when not loaded.

    Convenience mirror of the inline ``sys.modules.get`` idiom (useful in
    tests asserting the zero-cost property).
    """
    return sys.modules.get(__name__)


__all__ = ["SITES", "FaultSpec", "ACTIVE", "FIRED", "inject_faults",
           "fire", "guard", "in_guard", "peek"]
