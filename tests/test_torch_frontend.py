"""The port's micro-batching front-end (``repro_torch.serve.ServingFrontend``).

The front-end tests of ``tests/test_frontend.py``, ``tests/test_faults.py``
and ``tests/test_overload.py``, ported to ``repro_torch`` on
``device="cpu"`` (every kernel runs its plain twin):

* **bit-identity** — every batch the front-end forms serves bit-identically
  to a direct ``retrieve_batch`` on the same queries, for the five BM25
  variants under both planners (``plan="device"`` is the card's default),
  and every row is exact against the reference's ``ScipyBM25``; given the
  same arrivals, the port forms the same batches as the reference's
  ``ServingFrontend`` (its keys: pow2 width bucket with floor ``q_max``,
  and k);
* **serving surface** — batch forming, an engine target, ``asubmit``, a
  typed queue overflow, deadline misses (raise and degrade), ``close``
  draining or aborting typed, and a kernel's ``RuntimeError`` failing its
  batch's futures instead of being served around;
* **faults** — ``frontend.former`` thread death recovers through the stage
  supervisor, ``queue.flood`` sheds typed;
* **overload** — the admission gate (token bucket and CoDel), the stage
  supervisor's restart budget, a dead former revived at submit, knob
  validation, and the health counters summing exactly under concurrent
  submits from 4 threads beside direct calls.

The reference's retriever reaches Pallas kernels that do not run under the
installed jax (ROADMAP R1), so the reference's front-end runs here only
over a device-free stub retriever.
"""

import asyncio
import sys
import threading
import time

import numpy as np
import pytest

pytest.importorskip("jax")

from repro.core import BM25Params as RefParams  # noqa: E402
from repro.core import ScipyBM25 as RefScipy  # noqa: E402
from repro.core import build_index as ref_build_index  # noqa: E402
from repro.data.corpus import zipf_corpus, zipf_queries  # noqa: E402
from repro.serve import ServingFrontend as RefFrontend  # noqa: E402

from repro_torch.core import BM25Params, build_index, topk_numpy  # noqa: E402
from repro_torch.kernels import bm25_gather_score as k1  # noqa: E402
from repro_torch.serve import (HEALTH_SCHEMA,  # noqa: E402
                               AdmissionRejectedError, DeadlineExceededError,
                               DeviceRetriever, QueueOverflowError,
                               RetrievalEngine, RetrievalError,
                               RetrievalResult, ServingFrontend,
                               StageFailedError)
from repro_torch.serve.faults import inject_faults  # noqa: E402

pytestmark = pytest.mark.no_chaos    # asserts exact counter values

N_VOCAB = 120
FIVE_VARIANTS = ("lucene", "robertson", "atire", "bm25l", "bm25+")
SMALL = dict(block_size=32, tile=64, q_max=8, frag=64, device="cpu")


@pytest.fixture(scope="module")
def corpus():
    return zipf_corpus(150, N_VOCAB, avg_len=25)


@pytest.fixture(scope="module")
def index(corpus):
    return build_index(corpus, N_VOCAB, params=BM25Params())


@pytest.fixture(scope="module")
def retriever(index):
    return DeviceRetriever(index, **SMALL)


class _StubRetriever:
    """Device-free ``retrieve_batch`` target with a tunable service time."""

    def __init__(self, delay_s=0.0):
        self.q_max = 8
        self.query_counters = {}
        self.delay_s = delay_s
        self.rows = 0
        self._lock = threading.Lock()

    def retrieve_batch(self, batch, k=5, **kw):
        if self.delay_s:
            time.sleep(self.delay_s)
        with self._lock:
            self.rows += len(batch)
        b = len(batch)
        return RetrievalResult(ids=np.tile(np.arange(k), (b, 1)),
                               scores=np.zeros((b, k), np.float32))


def _assert_exact(oracle, q, row, k):
    """The row's scores are the oracle's top-k (atol 1e-4) and each id
    carries its oracle score (ties may come in either order)."""
    s = oracle.score(q)
    _, ref_v = topk_numpy(s[None], k)
    np.testing.assert_allclose(row.scores, ref_v[0], rtol=0, atol=1e-4)
    np.testing.assert_allclose(s[row.ids], row.scores, rtol=0, atol=1e-4)
    assert len(set(np.asarray(row.ids).tolist())) == k


# -- bit-identity and the reference's batches ---------------------------------

@pytest.mark.parametrize("plan", ["host", "device"])
@pytest.mark.parametrize("variant", FIVE_VARIANTS)
def test_frontend_bit_identical_to_direct(corpus, variant, plan):
    """Every batch the front-end FORMS serves bit-identically to a direct
    ``retrieve_batch`` call on that same batch, and every row is exact
    against the reference's oracle: micro-batching changes cost, never
    results."""
    idx = build_index(corpus, N_VOCAB, params=BM25Params(method=variant))
    dr = DeviceRetriever(idx, plan=plan, **SMALL)
    qs = zipf_queries(8, N_VOCAB)
    with ServingFrontend(dr, k=5, max_batch=4, batch_deadline_s=0.005,
                         record_batches=True) as fe:
        futs = [fe.submit(q) for q in qs]
        rows = [f.result(timeout=60) for f in futs]
    assert fe.recorded                             # batches actually formed
    served = 0
    for batch_qs, kk, res in fe.recorded:
        replay = dr.retrieve_batch(batch_qs, kk)   # direct, same batch
        np.testing.assert_array_equal(res.ids, replay.ids)
        np.testing.assert_array_equal(res.scores.view(np.int32),
                                      replay.scores.view(np.int32))
        assert res.plan.plan == plan
        served += len(batch_qs)
    assert served == len(qs)
    oracle = RefScipy(ref_build_index(corpus, N_VOCAB,
                                      params=RefParams(method=variant)))
    for q, row in zip(qs, rows):
        _assert_exact(oracle, q, row, 5)


def _formed_batches(cls, arrivals):
    """Queue ``arrivals`` (query, k) on a stopped front-end over a stub,
    start it and close it: the batches the former forms (size flushes,
    then drain flushes; the deadline never fires), as (widths, k)."""
    fe = cls(_StubRetriever(), k=5, max_batch=3, batch_deadline_s=30.0,
             autostart=False, record_batches=True)
    fe._started = True                  # queue without threads (test idiom)
    futs = [fe.submit(q, k=k) for q, k in arrivals]
    fe._started = False
    fe.start()
    fe.close()
    for f in futs:
        f.result(timeout=30)
    return [([len(q) for q in qs], kk) for qs, kk, _ in fe.recorded]


def test_frontend_forms_the_reference_batches():
    """Arrivals of mixed widths (both sides of the q_max = 8 floor and of
    16) and ks group into the same batches, in the same order, as the
    reference's front-end forms them."""
    rng = np.random.default_rng(7)
    arrivals = [(rng.integers(0, N_VOCAB, size=int(n)).astype(np.int32), k)
                for n, k in zip(rng.choice([1, 5, 8, 9, 16, 17], size=40),
                                rng.choice([3, 5], size=40))]
    got = _formed_batches(ServingFrontend, arrivals)
    assert got == _formed_batches(RefFrontend, arrivals)
    assert max(len(w) for w, _ in got) == 3      # size flushes formed
    assert len({k for _, k in got}) == 2


def test_frontend_forms_batches(retriever):
    """Concurrent same-shape arrivals share launches (micro-batching)."""
    qs = zipf_queries(12, N_VOCAB)
    with ServingFrontend(retriever, k=5, max_batch=4,
                         batch_deadline_s=0.05) as fe:
        futs = [fe.submit(q) for q in qs]
        for f in futs:
            f.result(timeout=60)
        h = fe.health()
    assert h["served"] == 12
    assert h["batches"] < 12                      # amortization happened
    assert h["flushes"]["size"] >= 1
    assert h["mean_batch"] > 1.0
    assert h["schema"] == HEALTH_SCHEMA
    assert h["retriever"]["schema"] == HEALTH_SCHEMA


def test_frontend_engine_target(index):
    """The single-stage path serves RetrievalEngine targets too."""
    eng = RetrievalEngine([index], scorer="gathered",
                          scorer_opts=dict(SMALL), warmup=False)
    q = zipf_queries(1, N_VOCAB)[0]
    with ServingFrontend(eng, k=5, max_batch=2,
                         batch_deadline_s=0.001) as fe:
        row = fe.submit(q).result(timeout=30)
    direct = eng.retrieve_batch([q], k=5)
    np.testing.assert_array_equal(row.ids, direct.ids[0])
    np.testing.assert_array_equal(row.scores, direct.scores[0])
    assert row.shards_answered == 1


def test_frontend_asubmit(retriever):
    qs = zipf_queries(3, N_VOCAB)

    async def drive(fe):
        return await asyncio.gather(*(fe.asubmit(q) for q in qs))

    with ServingFrontend(retriever, k=5, max_batch=8,
                         batch_deadline_s=0.05) as fe:
        rows = asyncio.run(drive(fe))
    direct = retriever.retrieve_batch(qs, 5)       # same formed batch of 3
    for i, row in enumerate(rows):
        np.testing.assert_array_equal(row.ids, direct.ids[i])


def test_kernel_runtime_error_fails_the_batch(monkeypatch, index):
    """A kernel that fails to launch raises ``RuntimeError`` on the execute
    stage's thread: the batch's futures fail with it (no rung serves
    around it) and the front-end keeps serving."""
    from repro_torch.kernels import _build
    dr = DeviceRetriever(index, regime="gathered", **SMALL)
    real = k1.bm25_resident_score_topk_plain

    def failed_launch(*a, **kw):
        _build.check(719, "bm25_resident_score_topk")   # a launch failure

    q = zipf_queries(1, N_VOCAB)[0]
    with ServingFrontend(dr, k=5, max_batch=4,
                         batch_deadline_s=0.001) as fe:
        monkeypatch.setattr(k1, "bm25_resident_score_topk_plain",
                            failed_launch)
        with pytest.raises(RuntimeError, match="CUDA error 719") as ei:
            fe.submit(q).result(timeout=30)
        assert not isinstance(ei.value, RetrievalError)
        monkeypatch.setattr(k1, "bm25_resident_score_topk_plain", real)
        row = fe.submit(q).result(timeout=30)
    np.testing.assert_array_equal(row.ids, dr.retrieve_batch([q], 5).ids[0])
    h = fe.health()
    assert h["faults"] == {"RuntimeError": 1}
    assert h["served"] == 1 and h["pending"] == 0
    assert dr.batches_degraded == 0


# -- SLO + admission control --------------------------------------------------

def test_queue_overflow_typed_raise(retriever):
    fe = ServingFrontend(retriever, k=5, max_queue=2, autostart=False)
    fe._started = True                  # admit without draining (no threads)
    q = zipf_queries(1, N_VOCAB)[0]
    fe.submit(q)
    fe.submit(q)
    with pytest.raises(QueueOverflowError) as ei:
        fe.submit(q)
    assert ei.value.pending == 2
    assert isinstance(ei.value, RuntimeError)     # builtin-compat base
    assert fe.health()["rejected"] == 1


@pytest.mark.parametrize("on_miss", ["raise", "degrade"])
def test_deadline_miss(retriever, on_miss):
    """A request that waited past its SLO fails typed (``raise``) or is
    served exactly and counted degraded (``degrade``, the default)."""
    fe = ServingFrontend(retriever, k=5, max_batch=8,
                         batch_deadline_s=0.05, request_timeout_s=1e-9,
                         on_miss=on_miss, autostart=False)
    fe._started = True
    q = zipf_queries(1, N_VOCAB)[0]
    fut = fe.submit(q)
    fe._started = False
    fe.start()                          # former drains the queued request
    if on_miss == "raise":
        with pytest.raises(DeadlineExceededError) as ei:
            fut.result(timeout=30)
        assert ei.value.waited_s is not None and ei.value.waited_s > 0
        assert isinstance(ei.value, TimeoutError)  # builtin-compat base
    else:
        row = fut.result(timeout=30)
        assert row.degraded                        # SLO miss flagged
        direct = retriever.retrieve_batch([q], 5)  # ... but still exact
        np.testing.assert_array_equal(row.ids, direct.ids[0])
    fe.close()
    h = fe.health()
    assert h["deadline_missed"] == 1
    if on_miss == "raise":
        assert h["faults"].get("DeadlineExceededError") == 1
        assert h["served"] == 0
    else:
        assert h["degraded"] == 1 and h["served"] == 1


@pytest.mark.parametrize("drain", [True, False])
def test_close(retriever, drain):
    """``close()`` serves what is queued (a drain flush);
    ``close(drain=False)`` fails it typed (``StageFailedError``,
    ``stage="close"``) before any device work. Either way admission
    stops."""
    stub = _StubRetriever()
    target = retriever if drain else stub
    fe = ServingFrontend(target, k=5, max_batch=64,
                         batch_deadline_s=30.0)    # deadline never fires
    futs = [fe.submit(q) for q in zipf_queries(5, N_VOCAB)]
    fe.close(drain=drain)
    h = fe.health()
    if drain:
        for f in futs:
            assert f.result(timeout=5).ids.shape == (5,)
        assert h["flushes"]["drain"] >= 1 and h["served"] == 5
    else:
        for f in futs:
            with pytest.raises(StageFailedError) as ei:
                f.result(timeout=5.0)
            assert ei.value.stage == "close"
        assert h["aborted"] == 5
        assert h["faults"]["StageFailedError"] == 5
        assert stub.rows == 0                     # nothing reached the device
    assert h["pending"] == 0
    with pytest.raises(RuntimeError):
        fe.submit(zipf_queries(1, N_VOCAB)[0])     # closed: no admission


def test_admission_gate_sheds_typed_before_device_work():
    stub = _StubRetriever()
    fe = ServingFrontend(stub, k=5, max_batch=4, batch_deadline_s=0.001,
                         admission_rate_qps=0.001, admission_burst=2)
    q = np.array([1, 2], np.int32)
    futs = [fe.submit(q), fe.submit(q)]           # the whole burst
    with pytest.raises(AdmissionRejectedError) as ei:
        fe.submit(q)
    assert ei.value.retry_after_s is not None and ei.value.retry_after_s > 0
    assert ei.value.pending is not None
    assert isinstance(ei.value, RuntimeError)     # builtin-compat base
    for f in futs:
        f.result(timeout=10.0)
    fe.close()
    h = fe.health()
    assert h["shed"] == 1 and h["rejected"] == 1
    assert h["faults"]["AdmissionRejectedError"] == 1
    assert h["served"] == 2 and h["submitted"] == 2
    assert h["admission"]["shed_bucket"] == 1
    assert stub.rows == 2                         # the shed cost NO work


def test_codel_gate_converges_under_sustained_overload():
    """A slow backend + sustained arrivals: the CoDel half starts
    shedding once the standing delay exceeds target, and every ADMITTED
    request still resolves."""
    stub = _StubRetriever(delay_s=0.03)
    fe = ServingFrontend(stub, k=5, max_batch=1, batch_deadline_s=0.0002,
                         codel_target_s=0.005, codel_interval_s=0.02)
    q = np.array([1, 2], np.int32)
    futs, shed = [], 0
    for _ in range(40):
        try:
            futs.append(fe.submit(q))
        except AdmissionRejectedError:
            shed += 1
        time.sleep(0.002)
    for f in futs:
        f.result(timeout=30.0)
    fe.close()
    h = fe.health()
    assert shed > 0 and h["admission"]["shed_codel"] == shed
    assert h["served"] == len(futs) == stub.rows  # admitted => served
    assert h["served"] + shed == 40


# -- faults -------------------------------------------------------------------

def test_frontend_former_death_recovers(index):
    """Injected former-thread death is absorbed by the stage supervisor:
    the stage restarts, queued requests ride the next iteration, and the
    answers stay bit-identical to direct retrieval."""
    dr = DeviceRetriever(index, regime="gathered", gather="host", **SMALL)
    qs = zipf_queries(4, N_VOCAB)
    direct = dr.retrieve_batch(qs, 5)
    with inject_faults({"site": "frontend.former", "kind": "thread_death",
                        "times": 1, "seed": 1}) as sp:
        fe = ServingFrontend(dr, k=5, max_batch=4,
                             batch_deadline_s=0.005)
        futs = [fe.submit(q) for q in qs]
        rows = [f.result(timeout=10.0) for f in futs]
        fe.close()
    assert sp[0].fired == 1
    assert fe.health()["restarts"] == 1
    for i, row in enumerate(rows):
        np.testing.assert_array_equal(row.ids, direct.ids[i])
        np.testing.assert_array_equal(row.scores, direct.scores[i])


def test_queue_flood_guarded_vs_unguarded(index):
    """submit() has no guard scope, so a guarded flood spec can never
    fire; an unguarded one inflates the depth the gate sees and the
    submission is REJECTED typed at the door — the real queue is
    untouched."""
    dr = DeviceRetriever(index, regime="gathered", gather="host", **SMALL)
    fe = ServingFrontend(dr, k=5, max_batch=4, batch_deadline_s=0.005,
                         max_queue=64)
    q = np.array([1, 2], np.int32)
    with inject_faults({"site": "queue.flood", "kind": "flood",
                        "times": 1, "seed": 1}) as sp:
        fe.submit(q).result(timeout=10.0)
    assert sp[0].fired == 0                # guarded: submit untouched
    with inject_faults({"site": "queue.flood", "kind": "flood",
                        "times": 1, "seed": 1, "guarded": False}) as sp:
        with pytest.raises(QueueOverflowError, match="queue full"):
            fe.submit(q)
    assert sp[0].fired == 1
    h = fe.health()
    assert h["pending"] == 0               # the flood never queued anything
    fe.submit(q).result(timeout=10.0)      # ... and serving continues
    fe.close()


# -- stage supervision --------------------------------------------------------

def test_supervisor_restarts_former_within_budget():
    """A crashing former step fails nothing queued (nothing was in
    flight), restarts in place, and keeps serving."""
    stub = _StubRetriever()
    fe = ServingFrontend(stub, k=5, max_batch=4, batch_deadline_s=0.001,
                         autostart=False, max_stage_restarts=3)
    real_step, crashes = fe._former_step, []

    def flaky_step():
        if not crashes:
            crashes.append(1)
            raise RuntimeError("injected former crash")
        return real_step()

    fe._former_step = flaky_step
    fe.start()
    q = np.array([1, 2], np.int32)
    row = fe.submit(q).result(timeout=10.0)
    assert row.ids.shape == (5,)
    fe.close()
    assert fe.health()["restarts"] == 1


def test_supervisor_budget_exhaustion_fails_pending_typed():
    """Beyond max_stage_restarts the frontend STOPS: queued requests fail
    typed instead of crash-looping, and new submits are refused."""
    stub = _StubRetriever()
    fe = ServingFrontend(stub, k=5, max_batch=64, batch_deadline_s=30.0,
                         autostart=False, max_stage_restarts=2)
    fe._started = True                  # queue without threads (test idiom)
    q = np.array([1, 2], np.int32)
    futs = [fe.submit(q) for _ in range(3)]
    fe._started = False

    def always_boom():
        raise RuntimeError("unrecoverable former crash")

    fe._former_step = always_boom
    fe.start()
    for f in futs:
        with pytest.raises(StageFailedError) as ei:
            f.result(timeout=5.0)
        assert ei.value.stage == "former"
    with pytest.raises(RuntimeError, match="not running"):
        fe.submit(q)
    h = fe.health()
    assert h["restarts"] == 2 and h["pending"] == 0
    fe.close()


def test_dead_former_detected_and_revived_at_submit():
    """A former found dead at submit time is restarted (budget
    permitting) after failing what it stranded — submits never queue
    onto a dead stage."""
    stub = _StubRetriever()
    fe = ServingFrontend(stub, k=5, max_batch=4, batch_deadline_s=0.001)
    with fe._cond:                                # kill the former cleanly
        fe._stopping = True
        fe._cond.notify_all()
    fe._former.join(timeout=5.0)
    assert not fe._former.is_alive()
    fe._stopping = False                          # simulate silent death
    q = np.array([1, 2], np.int32)
    row = fe.submit(q).result(timeout=10.0)       # revived + served
    assert row.ids.shape == (5,)
    assert fe.health()["restarts"] == 1
    fe.close()


@pytest.mark.parametrize("knob,match", [
    (dict(max_stage_restarts=-1), "max_stage_restarts"),
    (dict(max_batch=0), "max_batch"),
    (dict(on_miss="drop"), "on_miss")])
def test_frontend_knob_validation(knob, match):
    with pytest.raises(ValueError, match=match):
        ServingFrontend(_StubRetriever(), autostart=False, **knob)


# -- the hammer: thread-safe health counters ----------------------------------

def test_concurrent_submit_counters_sum_exactly(index):
    """Submits racing from 4 threads, beside direct retriever calls from 2
    more (the pack stage packs batch i+1 while the execute stage runs
    batch i), leave health counters that sum exactly at both levels."""
    dr = DeviceRetriever(index, plan="device", **SMALL)
    dr.retrieve_batch(zipf_queries(4, N_VOCAB), 5)
    base_batches = dr.health()["served"]
    qs = zipf_queries(8, N_VOCAB)
    n_threads, per_thread, n_direct = 4, 12, 6
    errs = []
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        fe = ServingFrontend(dr, k=5, max_batch=8, batch_deadline_s=0.002)

        def submitter():
            try:
                futs = [fe.submit(qs[i % len(qs)])
                        for i in range(per_thread)]
                for f in futs:
                    f.result(timeout=60.0)
            except BaseException as e:           # noqa: BLE001
                errs.append(e)

        def direct_caller():
            try:
                for _ in range(n_direct // 2):
                    dr.retrieve_batch(qs[:4], 5)
            except BaseException as e:           # noqa: BLE001
                errs.append(e)

        threads = ([threading.Thread(target=submitter)
                    for _ in range(n_threads)]
                   + [threading.Thread(target=direct_caller)
                      for _ in range(2)])
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120.0)
        assert not any(t.is_alive() for t in threads)
        fe.close()
    finally:
        sys.setswitchinterval(interval)
    assert not errs
    h = fe.health()
    total = n_threads * per_thread
    assert h["submitted"] == total
    assert h["served"] == total                   # nothing lost, nothing shed
    assert h["pending"] == 0 and h["rejected"] == 0
    assert h["faults"] == {}
    assert sum(h["flushes"].values()) == h["batches"]
    hr = dr.health()
    # retriever-level: frontend batches + direct calls, counted exactly
    assert hr["served"] == base_batches + h["batches"] + n_direct
    assert h["retriever"]["served"] == hr["served"]
