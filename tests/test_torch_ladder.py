"""The port's exact degradation ladder, fault injection and typed errors.

The ladder tests of ``tests/test_faults.py``, ported to ``repro_torch`` on
``device="cpu"`` (every kernel runs its plain twin):

* **errors** — the port's taxonomy has the reference's classes with the
  reference's bases;
* **faults** — ``SITES`` equals the reference's dict; specs are guarded and
  deterministic;
* **ladder** — for every injected fault class × five BM25 variants, the
  degraded answer carries each returned document's exact oracle score
  (atol 1e-4, the repo-wide exactness idiom) and the trail names the hop
  taken; every rung (pruned, resident, host, blocked, oracle) serves exact
  boards; where the reference's ladder can run here (it never reaches a
  Pallas kernel: R1), its trail, health keys and board equal the port's;
* **strict mode**, the watchdog, breakers and retries, as in the
  reference;
* a ``RuntimeError`` from a kernel launch (a kernel that does not build or
  launch) surfaces instead of being served by a lower rung.

The front-end and queue-flood tests are in ``test_torch_frontend.py``; the
snapshot and perm tests wait for their slice.
"""

import time

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from conftest import make_corpus  # noqa: E402
from repro.serve import DeviceRetriever as RefRetriever  # noqa: E402
from repro.serve import errors as ref_errors  # noqa: E402
from repro.serve import faults as ref_faults  # noqa: E402

from repro_torch.core import (BM25Params, ScipyBM25, build_index,  # noqa: E402
                              build_sharded_indexes, topk_numpy,
                              validate_query_batch)
from repro_torch.serve import (DeviceRetriever,  # noqa: E402
                               InvalidQueryError, ResidencyError,
                               RetrievalEngine, RetrievalError)
from repro_torch.serve import errors as port_errors  # noqa: E402
from repro_torch.serve.errors import RetrievalConfigError  # noqa: E402
from repro_torch.serve.faults import (SITES, FaultSpec,  # noqa: E402
                                      inject_faults)

ALL_VARIANTS = ["robertson", "atire", "lucene", "bm25l", "bm25+"]

SMALL = dict(block_size=16, tile=16, acc_block=16, frag=8, q_max=8,
             device="cpu")
REF_SMALL = {k: v for k, v in SMALL.items() if k != "device"}

pytestmark = pytest.mark.no_chaos      # this module arms faults itself


def _mk(rng, method, n_vocab=64, n_docs=90):
    corpus = make_corpus(rng, n_docs=n_docs, n_vocab=n_vocab, max_len=20)
    return build_index(corpus, n_vocab, params=BM25Params(method=method))


def _queries(rng, n_vocab, n=3):
    return [rng.integers(0, n_vocab, size=rng.integers(1, 6)
                         ).astype(np.int32) for _ in range(n)]


def _assert_exact(dr, ids, vals, k, oracle=None):
    """Every returned id carries its exact oracle score, and the top-k
    score vector equals the oracle's (atol 1e-4)."""
    sc = oracle or ScipyBM25(dr.index)
    for i, q in enumerate(dr.last_queries):
        ref = sc.score(q)
        _, ref_v = topk_numpy(ref[None], k)
        np.testing.assert_allclose(vals[i], ref_v[0], atol=1e-4)
        np.testing.assert_allclose(ref[ids[i]], vals[i], atol=1e-4)
        assert len(set(np.asarray(ids[i]).tolist())) == len(ids[i])


def _hops(trail):
    return [(t["from"], t["to"], t["error"]) for t in trail]


# -- taxonomy ----------------------------------------------------------------

def test_taxonomy_equals_reference():
    """Every class keeps all of its bases (by name, so ``RetrievalError``
    and the builtin each replaced) and its fields."""
    assert port_errors.__all__ == ref_errors.__all__
    for name in ref_errors.__all__:
        ours, theirs = getattr(port_errors, name), getattr(ref_errors, name)
        assert [b.__name__ for b in ours.__mro__] == \
            [b.__name__ for b in theirs.__mro__]
    e = port_errors.PlanOverflowError("x", attempted=[8, 16], cap=16)
    assert (e.attempted, e.cap) == ([8, 16], 16)
    e = port_errors.ExecutionStalledError("x", waited_s=0.1, hop="host")
    assert isinstance(e, TimeoutError) and e.hop == "host"
    assert port_errors.AdmissionRejectedError(
        "x", retry_after_s=1.0, pending=3).retry_after_s == 1.0
    assert port_errors.SnapshotIntegrityError("x", corrupt=["a"]).corrupt \
        == ["a"]
    assert port_errors.StageFailedError("x", stage="former").stage == \
        "former"


def test_config_errors_are_typed(rng):
    idx = _mk(rng, "lucene")
    with pytest.raises(RetrievalConfigError):
        DeviceRetriever(idx, regime="wand", **SMALL)
    with pytest.raises(RetrievalConfigError):
        DeviceRetriever(idx, on_fault="panic", **SMALL)
    with pytest.raises(RetrievalConfigError):
        DeviceRetriever(idx, regime="pruned", gather="host", **SMALL)
    with pytest.raises(RetrievalConfigError, match="unknown reorder"):
        DeviceRetriever(idx, reorder="signatures", **SMALL)
    from repro_torch.sparse.block_csr import DeviceIndex
    bare = DeviceIndex.build(idx, device="cpu", block_size=16, tile=16,
                             frag=8, host_arrays="drop")
    with pytest.raises(RetrievalConfigError, match="host BM25Index"):
        DeviceRetriever(None, device_index=bare, **SMALL)


def test_fault_spec_rejects_unknown_site_and_sites_equal_reference():
    with pytest.raises(ValueError, match="unknown fault site"):
        FaultSpec(site="nope", kind="residency")
    with pytest.raises(ValueError, match="no kind"):
        FaultSpec(site="residency.put_posting_arrays", kind="nan_board")
    assert SITES == ref_faults.SITES
    with pytest.raises(ValueError, match="no kind"):
        FaultSpec(site="snapshot.array", kind="torn_write")


# -- ladder recovery, every fault class × five variants ----------------------

@pytest.mark.parametrize("method", ALL_VARIANTS)
def test_residency_fault_recovers_exact(method, rng):
    """Upload failure in the host-gather hop degrades (here: to the oracle
    rung — the gathered-only build has no blocked layout) exactly."""
    idx = _mk(rng, method)
    dr = DeviceRetriever(idx, regime="gathered", gather="host", **SMALL)
    qs = _queries(rng, 64)
    with inject_faults({"site": "residency.put_posting_arrays",
                        "kind": "residency", "times": 1, "seed": 1}) as sp:
        ids, vals = dr.retrieve_batch(qs, 7)
    assert sp[0].fired == 1
    trail = dr.last_plan.degradations
    assert [t["from"] for t in trail] == ["host"]
    assert trail[0]["to"] == "oracle" and trail[0]["error"] == "ResidencyError"
    _assert_exact(dr, ids, vals, 7)
    assert dr.health()["degradations"] == {"host->oracle": 1}


@pytest.mark.parametrize("method", ALL_VARIANTS)
def test_residency_fault_recovers_via_blocked(method, rng):
    """An auto build holds the blocked layout, so the ladder lands there
    (never reaching the oracle) when the host gather's upload fails."""
    idx = _mk(rng, method)
    dr = DeviceRetriever(idx, regime="auto", gather="host", **SMALL)
    qs = _queries(rng, 64)
    with inject_faults({"site": "residency.put_posting_arrays",
                        "kind": "residency", "times": 1, "seed": 1}):
        ids, vals = dr.retrieve_batch(qs, 7)
    trail = dr.last_plan.degradations
    if trail:                       # planner picked the gathered entry
        assert trail[0]["from"] == "host" and trail[0]["to"] == "blocked"
    _assert_exact(dr, ids, vals, 7)


@pytest.mark.parametrize("method", ALL_VARIANTS)
def test_overflow_fault_recovers_exact(method, rng):
    """nf-bucket exhaustion in the device fragment planner hops
    resident → host with the exact answer."""
    idx = _mk(rng, method)
    dr = DeviceRetriever(idx, regime="gathered", gather="resident",
                         plan="device", **SMALL)
    qs = _queries(rng, 64)
    ids0, vals0 = dr.retrieve_batch(qs, 7)
    with inject_faults({"site": "plan.fragments_device",
                        "kind": "overflow", "times": 1, "seed": 2}) as sp:
        ids, vals = dr.retrieve_batch(qs, 7)
    assert sp[0].fired == 1
    trail = dr.last_plan.degradations
    assert trail[0]["from"] == "resident" and trail[0]["to"] == "host"
    assert trail[0]["error"] == "PlanOverflowError"
    np.testing.assert_allclose(vals, vals0, atol=1e-5)
    _assert_exact(dr, ids, vals, 7)


@pytest.mark.parametrize("method", ALL_VARIANTS)
@pytest.mark.parametrize("kind", ["nan_board", "inf_board"])
def test_score_integrity_fault_recovers_bit_identical(method, kind, rng):
    """A poisoned [B, k] board from the pruned kernel is caught by the
    finite-check and re-served by the unpruned resident hop —
    bit-identical, because pruning only removes provably-losing work."""
    idx = _mk(rng, method)
    dr = DeviceRetriever(idx, regime="pruned", gather="resident",
                         plan="host", **SMALL)
    qs = _queries(rng, 64)
    ids0, vals0 = dr.retrieve_batch(qs, 7)
    with inject_faults({"site": "kernel.resident_pruned", "kind": kind,
                        "times": 1, "seed": 3}) as sp:
        ids, vals = dr.retrieve_batch(qs, 7)
    assert sp[0].fired == 1
    trail = dr.last_plan.degradations
    assert trail[0]["from"] == "pruned" and trail[0]["to"] == "resident"
    assert trail[0]["error"] == "ScoreIntegrityError"
    np.testing.assert_array_equal(vals, vals0)
    np.testing.assert_array_equal(ids, ids0)
    _assert_exact(dr, ids, vals, 7)


@pytest.mark.parametrize("method", ALL_VARIANTS)
@pytest.mark.parametrize("kind", ["query.range", "query.negative",
                                  "query.dtype", "query.ragged"])
def test_malformed_query_fault_sanitized_exact(method, kind, rng):
    """Corrupted client batches are repaired by the shared sanitizer; the
    answer is exact for the sanitized batch."""
    idx = _mk(rng, method)
    dr = DeviceRetriever(idx, regime="gathered", gather="host", **SMALL)
    qs = _queries(rng, 64, n=4)
    with inject_faults({"site": "query.batch", "kind": kind,
                        "times": 1, "seed": 4}) as sp:
        ids, vals = dr.retrieve_batch(qs, 7)
    assert sp[0].fired == 1
    assert not dr.last_plan.degradations        # sanitizer, not the ladder
    if kind in ("query.range", "query.negative"):
        assert dr.query_counters.get("dropped_tokens", 0) >= 1
    if kind == "query.dtype":
        assert dr.query_counters.get("recast_queries", 0) >= 1
    if kind == "query.ragged":
        assert dr.query_counters.get("null_queries", 0) >= 1
    _assert_exact(dr, ids, vals, 7)


def test_fault_injection_is_deterministic(rng):
    idx = _mk(rng, "lucene")
    dr = DeviceRetriever(idx, regime="gathered", gather="host", **SMALL)
    qs = _queries(rng, 64, n=4)
    runs = []
    for _ in range(2):
        dr.query_counters.clear()
        with inject_faults({"site": "query.batch", "kind": "query.range",
                            "times": 1, "seed": 11}):
            dr.retrieve_batch(qs, 5)
        runs.append([q.tolist() for q in dr.last_queries])
    assert runs[0] == runs[1]          # same seed -> same corruption


@pytest.mark.parametrize("method", ALL_VARIANTS)
def test_every_rung_serves_exact(method, rng):
    """An auto build holds every layout. Entered at pruned (the operator
    pins the entry) and with the breakers of the rungs above tripped one by
    one, each rung of the ladder serves the batch exactly; the trail skips
    exactly the tripped rungs (BreakerOpen) and names the serving rung."""
    idx = _mk(rng, method)
    qs = _queries(rng, 64, n=4) + [np.zeros(0, np.int32)]
    dr = DeviceRetriever(idx, regime="auto", plan="host", **SMALL)
    dr.regime = "pruned"
    oracle = ScipyBM25(idx)
    ladder = DeviceRetriever._LADDER
    for n, rung in enumerate(ladder):
        if n:
            dr.trip_breaker(ladder[n - 1], cooldown_s=60.0)
        r = dr.retrieve_batch(qs, 7)
        _assert_exact(dr, r.ids, r.scores, 7, oracle)
        assert [t["from"] for t in r.degradations] == list(ladder[:n])
        assert all(t["error"] == "BreakerOpen" for t in r.degradations)
        assert r.degraded == (n > 0)
        if n:
            assert r.degradations[-1]["to"] == rung
    assert dr.health()["degraded"] == len(ladder) - 1


def test_trails_equal_the_reference_where_it_runs(rng):
    """Where the reference's ladder reaches no Pallas kernel (the faults
    fire before it, or the breakers skip every device rung), its trail,
    health keys and board equal the port's."""
    from repro.core import BM25Params as RefParams
    from repro.core import build_index as ref_build_index
    corpus = make_corpus(rng, n_docs=90, n_vocab=64, max_len=20)
    idx = build_index(corpus, 64, params=BM25Params(method="lucene"))
    ref_idx = ref_build_index(corpus, 64, params=RefParams(method="lucene"))
    qs = _queries(rng, 64, n=4)
    cases = [
        (dict(regime="gathered", gather="host"), [],
         {"site": "residency.put_posting_arrays", "kind": "residency",
          "times": 1, "seed": 1}),
        (dict(regime="gathered", gather="host"), ["host"], None),
        (dict(regime="auto", gather="resident", plan="host"),
         ["pruned", "resident", "host", "blocked"], None),
        (dict(regime="auto", gather="host"), ["host", "blocked"], None),
    ]
    for kw, trip, fault in cases:
        got = []
        for cls, inj, index, small in (
                (DeviceRetriever, inject_faults, idx, SMALL),
                (RefRetriever, ref_faults.inject_faults, ref_idx,
                 REF_SMALL)):
            dr = cls(index, **kw, **small)
            for hop in trip:
                dr.trip_breaker(hop, cooldown_s=60.0)
            if fault is None:
                r = dr.retrieve_batch(qs, 7)
            else:
                with inj(dict(fault)):
                    r = dr.retrieve_batch(qs, 7)
            got.append((_hops(r.degradations), dr.health()["degradations"],
                        dr.health()["faults"], np.asarray(r.ids),
                        np.asarray(r.scores)))
        (pt, ph, pf, pi, ps), (rt, rh, rf, ri, rs) = got
        assert pt == rt and ph == rh and pf == rf, (kw, trip)
        np.testing.assert_array_equal(ps, rs)
        np.testing.assert_array_equal(pi, ri)


def test_kernel_runtime_error_surfaces_instead_of_degrading(monkeypatch,
                                                            rng):
    """A kernel that fails to build or launch raises ``RuntimeError``
    (``kernels._build.check``): not a typed fault, so no lower rung (the
    oracle included) may serve the batch in its place."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import bm25_gather_score as k4
    idx = _mk(rng, "lucene")
    dr = DeviceRetriever(idx, regime="gathered", gather="host", **SMALL)
    qs = _queries(rng, 64)

    def failed_launch(*a, **kw):
        _build.check(719, "bm25_gather_score_topk")   # a launch failure

    monkeypatch.setattr(k4, "bm25_gather_score_topk_plain", failed_launch)
    with pytest.raises(RuntimeError, match="CUDA error 719") as ei:
        dr.retrieve_batch(qs, 7)
    assert not isinstance(ei.value, RetrievalError)
    assert dr.batches_degraded == 0 and dr.fault_counters == {}
    assert dr.last_plan.degradations == []


# -- strict mode -------------------------------------------------------------

def test_strict_mode_surfaces_typed_errors(rng):
    idx = _mk(rng, "lucene")
    dr = DeviceRetriever(idx, regime="gathered", gather="host",
                         on_fault="raise", **SMALL)
    qs = _queries(rng, 64)
    with inject_faults({"site": "residency.put_posting_arrays",
                        "kind": "residency", "times": 1,
                        "guarded": False}):
        with pytest.raises(ResidencyError, match="injected"):
            dr.retrieve_batch(qs, 5)
    with pytest.raises(InvalidQueryError, match="token ids"):
        dr.retrieve_batch([np.array([999999], np.int64)], 5)
    with inject_faults({"site": "residency.put_posting_arrays",
                        "kind": "residency", "times": 1,
                        "guarded": False}):
        with pytest.raises(RetrievalError):
            dr.retrieve_batch(qs, 5)
    # a GUARDED spec is a no-op against a strict retriever
    with inject_faults({"site": "residency.put_posting_arrays",
                        "kind": "residency", "times": 1}) as sp:
        dr.retrieve_batch(qs, 5)
    assert sp[0].fired == 0


def test_forced_regime_is_strict(rng):
    """A per-call regime override is operator intent — no silent ladder."""
    idx = _mk(rng, "lucene")
    dr = DeviceRetriever(idx, regime="gathered", gather="resident",
                         plan="host", **SMALL)
    with pytest.raises(ValueError, match="blocked layout"):
        dr.retrieve_batch([np.array([1], np.int32)], 2, regime="blocked")
    with pytest.raises(RetrievalError):
        dr.retrieve_batch([np.array([1], np.int32)], 2, regime="blocked")


# -- the sanitizer, directly -------------------------------------------------

def test_validate_query_batch_strict_raises():
    """Strict mode raises on the first lossy defect (the repairs and their
    counters equal the reference's: ``test_torch_host_layer.py``)."""
    with pytest.raises(InvalidQueryError):
        validate_query_batch([np.array([99])], 64, on_invalid="raise")
    with pytest.raises(InvalidQueryError):
        validate_query_batch([None], 64, on_invalid="raise")
    with pytest.raises(InvalidQueryError):
        validate_query_batch([np.array([1.5])], 64, on_invalid="raise")
    out = validate_query_batch([np.array([3.0])], 64, on_invalid="raise")
    assert out[0].tolist() == [3]


# -- engine-level health -----------------------------------------------------

def test_engine_health_reports_ladder_and_sanitizer(rng):
    corpus = make_corpus(rng, n_docs=80, n_vocab=64)
    shards = build_sharded_indexes(corpus, 64, 2, params=BM25Params())
    eng = RetrievalEngine(shards, k=5, deadline_s=5.0, scorer="gathered",
                          scorer_opts=dict(gather="host", **SMALL))
    h0 = eng.health()
    assert h0["responses"] == 0 and len(h0["shards"]) == 2
    with inject_faults({"site": "residency.put_posting_arrays",
                        "kind": "residency", "times": 1, "seed": 6}):
        r = eng.retrieve_batch([np.array([1, 2, 60], np.int32),
                                np.array([5], np.int32)])
    assert not r.degraded               # shard answered (via its ladder)
    h = eng.health()
    assert h["responses"] == 1 and h["degraded_responses"] == 0
    assert sum(s["batches_degraded"] for s in h["shards"]) == 1
    hops = {}
    for s in h["shards"]:
        for key, n in s["degradations"].items():
            hops[key] = hops.get(key, 0) + n
    assert sum(hops.values()) == 1      # exactly one shard took one hop
    assert h["faults"] == {"ResidencyError": 1}
    eng.retrieve(np.array([1, 99999], np.int64))
    assert eng.health()["queries"]["dropped_tokens"] == 1


# -- no-fault behavior: the harness costs nothing when disarmed --------------

def test_healthy_path_records_no_degradations(rng):
    idx = _mk(rng, "lucene")
    dr = DeviceRetriever(idx, regime="auto", gather="resident",
                         plan="host", **SMALL)
    qs = _queries(rng, 64)
    ids, vals = dr.retrieve_batch(qs, 7)
    assert dr.last_plan.degradations == []
    assert dr.batches_degraded == 0 and dr.fault_counters == {}
    _assert_exact(dr, ids, vals, 7)


def test_guarded_fault_does_not_fire_outside_ladder(rng):
    """A guarded (default) spec cannot break index construction."""
    from repro_torch.sparse.block_csr import put_posting_arrays
    with inject_faults({"site": "residency.put_posting_arrays",
                        "kind": "residency", "times": 5}) as sp:
        put_posting_arrays(np.zeros(4, np.int32), device="cpu")
    assert sp[0].fired == 0
    with inject_faults({"site": "residency.put_posting_arrays",
                        "kind": "residency", "times": 1,
                        "guarded": False}) as sp:
        with pytest.raises(ResidencyError):
            put_posting_arrays(np.zeros(4, np.int32), device="cpu")
    assert sp[0].fired == 1


def test_corrupt_board_keeps_the_tensor_on_its_device():
    from repro_torch.serve import faults
    vals = torch.zeros((3, 4))
    rng = np.random.default_rng(0)
    out = faults._corrupt_board(vals, "nan_board", rng)
    assert out.device == vals.device and torch.isnan(out[0]).sum() == 1
    assert not torch.isnan(vals).any()               # a copy, not in place
    out = faults._corrupt_board(vals, "inf_board", rng)
    assert torch.isinf(out[0]).sum() == 1
    empty = torch.zeros((0, 4))
    assert faults._corrupt_board(empty, "nan_board", rng) is empty


# -- the overload fault lane: stalls, breakers, retries ----------------------

def _settle(dr, qs, k, tries=6):
    """Drive the retriever until a call completes without spurious watchdog
    stalls."""
    for _ in range(tries):
        dr.retrieve_batch(qs, k)
        if not dr.last_plan.degradations:
            return
        time.sleep(0.2)
    raise AssertionError("retriever never settled under its watchdog")


@pytest.mark.parametrize("method", ALL_VARIANTS)
def test_watchdog_stall_recovers_exact(method, rng):
    """A stalled pruned-rung launch trips the watchdog, surfaces as a typed
    ExecutionStalledError, and the ladder re-serves the batch on the
    unpruned resident rung — bit-identical to the no-fault answer."""
    idx = _mk(rng, method)
    dr = DeviceRetriever(idx, regime="pruned", gather="resident",
                         plan="host", watchdog_s=0.12,
                         breaker_threshold=None, **SMALL)
    qs = _queries(rng, 64)
    _settle(dr, qs, 7)
    ids0, vals0 = dr.retrieve_batch(qs, 7)
    stalls0 = dr.health()["watchdog"]["stalls"]
    with inject_faults({"site": "kernel.stall", "kind": "stall",
                        "times": 1, "seed": 5}) as sp:
        ids, vals = dr.retrieve_batch(qs, 7)
    assert sp[0].fired == 1
    trail = dr.last_plan.degradations
    assert trail[0]["from"] == "pruned" and trail[0]["to"] == "resident"
    assert trail[0]["error"] == "ExecutionStalledError"
    assert dr.health()["watchdog"]["stalls"] == stalls0 + 1
    np.testing.assert_array_equal(vals, vals0)
    np.testing.assert_array_equal(ids, ids0)
    _assert_exact(dr, ids, vals, 7)


def test_stall_without_watchdog_is_latency_only(rng):
    idx = _mk(rng, "lucene")
    dr = DeviceRetriever(idx, regime="gathered", gather="host", **SMALL)
    qs = _queries(rng, 64)
    ids0, vals0 = dr.retrieve_batch(qs, 7)
    with inject_faults({"site": "kernel.stall", "kind": "stall",
                        "times": 1, "seed": 5}) as sp:
        t0 = time.monotonic()
        ids, vals = dr.retrieve_batch(qs, 7)
        dt = time.monotonic() - t0
    assert sp[0].fired == 1
    assert dt >= 0.15                     # the sleep really happened
    assert dr.last_plan.degradations == []
    assert dr.health()["watchdog"] == {}
    np.testing.assert_array_equal(vals, vals0)
    np.testing.assert_array_equal(ids, ids0)


def test_stall_is_guard_scoped(rng):
    idx = _mk(rng, "lucene")
    dr = DeviceRetriever(idx, regime="gathered", gather="host",
                         on_fault="raise", **SMALL)
    qs = _queries(rng, 64)
    with inject_faults({"site": "kernel.stall", "kind": "stall",
                        "times": 1, "seed": 5}) as sp:
        dr.retrieve_batch(qs, 7)
    assert sp[0].fired == 0


@pytest.mark.parametrize("method", ALL_VARIANTS)
def test_breaker_opens_after_threshold_and_recloses(method, rng):
    idx = _mk(rng, method)
    dr = DeviceRetriever(idx, regime="gathered", gather="host",
                         breaker_threshold=2, breaker_cooldown_s=0.3,
                         **SMALL)
    qs = _queries(rng, 64)
    for _ in range(2):
        with inject_faults({"site": "residency.put_posting_arrays",
                            "kind": "residency", "times": 1, "seed": 1}):
            ids, vals = dr.retrieve_batch(qs, 7)
        _assert_exact(dr, ids, vals, 7)
    h = dr.health()
    assert h["breakers"]["host"]["state"] == "open"
    assert h["breakers"]["host"]["opened"] == 1
    ids, vals = dr.retrieve_batch(qs, 7)
    trail = dr.last_plan.degradations
    assert trail[0]["from"] == "host" and trail[0]["error"] == "BreakerOpen"
    assert trail[0]["to"] == "oracle"
    assert dr.health()["breakers"]["host"]["skips"] >= 1
    _assert_exact(dr, ids, vals, 7)
    time.sleep(0.35)
    ids, vals = dr.retrieve_batch(qs, 7)
    assert dr.last_plan.degradations == []
    assert dr.health()["breakers"]["host"]["state"] == "closed"
    _assert_exact(dr, ids, vals, 7)


def test_breaker_probe_failure_reopens(rng):
    idx = _mk(rng, "lucene")
    dr = DeviceRetriever(idx, regime="gathered", gather="host",
                         breaker_threshold=1, breaker_cooldown_s=0.2,
                         **SMALL)
    qs = _queries(rng, 64)
    with inject_faults({"site": "residency.put_posting_arrays",
                        "kind": "residency", "times": 1, "seed": 1}):
        dr.retrieve_batch(qs, 7)
    assert dr.health()["breakers"]["host"]["state"] == "open"
    time.sleep(0.25)                       # half-open: probe slot free
    with inject_faults({"site": "residency.put_posting_arrays",
                        "kind": "residency", "times": 1, "seed": 1}):
        ids, vals = dr.retrieve_batch(qs, 7)
    h = dr.health()["breakers"]["host"]
    assert h["state"] == "open" and h["opened"] == 2
    _assert_exact(dr, ids, vals, 7)


def test_trip_breaker_forced_open_serves_exact(rng):
    idx = _mk(rng, "lucene")
    dr = DeviceRetriever(idx, regime="gathered", gather="host", **SMALL)
    qs = _queries(rng, 64)
    dr.trip_breaker("host", cooldown_s=60.0)
    ids, vals = dr.retrieve_batch(qs, 7)
    trail = dr.last_plan.degradations
    assert trail[0] == {"from": "host", "to": "oracle",
                        "error": "BreakerOpen", "detail": trail[0]["detail"]}
    h = dr.health()
    assert h["breakers"]["host"]["state"] == "open"
    assert h["degradations"] == {"host->oracle": 1}
    _assert_exact(dr, ids, vals, 7)
    with pytest.raises(RetrievalConfigError, match="unknown ladder rung"):
        dr.trip_breaker("nope")
    dr_off = DeviceRetriever(idx, regime="gathered", gather="host",
                             breaker_threshold=None, **SMALL)
    assert dr_off.health()["breakers"] == {}
    with pytest.raises(RetrievalConfigError, match="disabled"):
        dr_off.trip_breaker("host")


@pytest.mark.parametrize("method", ALL_VARIANTS)
def test_retry_budget_absorbs_transient_residency_fault(method, rng):
    idx = _mk(rng, method)
    dr = DeviceRetriever(idx, regime="gathered", gather="host",
                         retry_budget=2, retry_backoff_s=0.001, **SMALL)
    qs = _queries(rng, 64)
    with inject_faults({"site": "residency.put_posting_arrays",
                        "kind": "residency", "times": 1, "seed": 1}) as sp:
        ids, vals = dr.retrieve_batch(qs, 7)
    assert sp[0].fired == 1
    assert dr.last_plan.degradations == []          # no hop burned
    h = dr.health()
    assert h["retries"] == 1
    assert h["faults"]["ResidencyError"] == 1       # still counted typed
    _assert_exact(dr, ids, vals, 7)
