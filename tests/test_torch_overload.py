"""Overload protection in the port: breakers, watchdog, retry, admission.

The unit tests of ``tests/test_overload.py`` for the primitives the port
copies whole (``repro_torch.serve.overload``), the retriever's knob
validation, and a hammer test of the thread-safe counters (the retriever's
health counters and the kernels' launch counters) under concurrent calls.
The front-end's admission, close and supervisor tests are in
``test_torch_frontend.py``.
"""

import threading
import time

import numpy as np
import pytest

from conftest import make_corpus
from repro_torch.core import BM25Params, build_index
from repro_torch.serve import (AdmissionController, CircuitBreaker,
                               DeviceRetriever, ExecutionStalledError,
                               RetrievalConfigError, RetryPolicy,
                               WatchdogExecutor)

pytestmark = pytest.mark.no_chaos    # asserts exact counter values

N_VOCAB = 120
SMALL = dict(block_size=32, tile=64, q_max=8, frag=64, device="cpu")


# -- AdmissionController (unit, fake clock) ------------------------------

def test_bucket_sheds_above_rate_and_refills():
    ac = AdmissionController(rate_qps=10.0, burst=2)
    assert ac.admit(0.0, 0) is None
    assert ac.admit(0.0, 0) is None              # burst of 2 admitted
    ra = ac.admit(0.0, 0)
    assert ra is not None and ra == pytest.approx(0.1)   # 1 token / 10 qps
    assert ac.admit(0.05, 0) is not None         # half a token accrued
    assert ac.admit(0.1001, 0) is None           # a full token accrued
    assert ac.admitted == 3
    assert ac.shed_bucket == 2 and ac.shed_codel == 0


def test_bucket_is_deterministic():
    """Same clock sequence -> same decision sequence (no RNG anywhere)."""
    seq = [0.0, 0.01, 0.02, 0.3, 0.31, 0.32, 0.9]
    runs = []
    for _ in range(2):
        ac = AdmissionController(rate_qps=5.0, burst=1)
        runs.append([ac.admit(t, 0) for t in seq])
    assert runs[0] == runs[1]


def test_codel_sheds_after_interval_and_recovers():
    ac = AdmissionController(codel_target_s=0.01, codel_interval_s=0.1)
    ac.observe(0.05, 0.0)                        # above target at t=0
    assert ac.admit(0.05, 0) is None             # patience: < one interval
    ra = ac.admit(0.11, 0)                       # interval elapsed: shed
    assert ra == pytest.approx(0.1)              # interval / sqrt(1)
    assert ac.admit(0.12, 0) is None             # next shed not yet due
    ra = ac.admit(0.22, 0)                       # past _drop_next
    assert ra == pytest.approx(0.1 / np.sqrt(2))
    ac.observe(0.001, 0.3)                       # delay back under target
    assert ac.admit(0.31, 0) is None             # episode over: admit again
    assert ac.shed_codel == 2
    snap = ac.snapshot()
    assert snap["admitted"] == 3 and snap["codel_dropping"] is False


def test_admission_validation_and_defaults():
    with pytest.raises(ValueError, match="rate_qps"):
        AdmissionController(rate_qps=-1.0)
    with pytest.raises(ValueError, match="codel_target_s"):
        AdmissionController(codel_target_s=0.0)
    assert AdmissionController(rate_qps=1000.0).burst == 200
    assert AdmissionController(rate_qps=10.0).burst == 8  # floor


# -- CircuitBreaker (unit, fake clock) -----------------------------------

def test_breaker_state_machine():
    br = CircuitBreaker(threshold=3, window_s=10.0, cooldown_s=5.0)
    assert br.state(0.0) == "closed" and br.allow(0.0)
    br.record_fault(0.0)
    br.record_fault(1.0)
    assert br.state(1.0) == "closed"             # under threshold
    br.record_fault(2.0)
    assert br.state(2.0) == "open" and br.opened == 1
    assert not br.allow(3.0) and br.skips == 1
    assert br.state(7.0) == "half-open"
    assert br.allow(7.0)                          # claims THE probe slot
    assert not br.allow(7.1)                      # second caller: no slot
    br.record_success(7.2)
    assert br.state(7.2) == "closed"
    assert br.snapshot(7.2)["faults_in_window"] == 0


def test_breaker_window_prunes_old_faults():
    br = CircuitBreaker(threshold=2, window_s=1.0, cooldown_s=5.0)
    br.record_fault(0.0)
    br.record_fault(5.0)                          # first fault aged out
    assert br.state(5.0) == "closed"
    br.record_fault(5.5)
    assert br.state(5.5) == "open"


def test_breaker_probe_failure_reopens():
    br = CircuitBreaker(threshold=1, cooldown_s=2.0)
    br.record_fault(0.0)
    assert br.allow(3.0)                          # half-open probe
    br.record_fault(3.1)                          # probe failed
    assert br.state(3.2) == "open" and br.opened == 2
    assert br.state(5.2) == "half-open"           # another cooldown later


def test_breaker_force_open_and_validation():
    br = CircuitBreaker()
    br.force_open(0.0, cooldown_s=100.0)
    assert br.state(50.0) == "open" and br.opened == 1
    with pytest.raises(ValueError, match="threshold"):
        CircuitBreaker(threshold=0)


# -- WatchdogExecutor ----------------------------------------------------

def test_watchdog_converts_stall_and_replaces_worker():
    wd = WatchdogExecutor(0.05, name="t-wd")
    with pytest.raises(ExecutionStalledError) as ei:
        wd.run(time.sleep, 0.5)
    assert ei.value.waited_s == pytest.approx(0.05)
    assert isinstance(ei.value, TimeoutError)     # builtin-compat base
    assert wd.stalls == 1
    assert wd.run(lambda: 42) == 42               # fresh worker is live
    wd.close()


def test_watchdog_enters_ctx_on_worker_thread():
    """Thread-local guard scopes must be re-entered ON the worker."""
    import contextlib

    entered_on = []

    @contextlib.contextmanager
    def ctx():
        entered_on.append(threading.current_thread().name)
        yield

    wd = WatchdogExecutor(5.0, name="ctx-wd")
    ran_on = wd.run(lambda: threading.current_thread().name, ctx=ctx)
    assert entered_on == [ran_on]                 # same (worker) thread
    assert ran_on != threading.current_thread().name
    wd.close()
    with pytest.raises(ValueError, match="positive"):
        WatchdogExecutor(0.0)


def test_watchdog_propagates_worker_exceptions():
    wd = WatchdogExecutor(5.0)

    def boom():
        raise KeyError("from the worker")

    with pytest.raises(KeyError, match="from the worker"):
        wd.run(boom)
    assert wd.stalls == 0
    wd.close()


# -- RetryPolicy ---------------------------------------------------------

def test_retry_policy_is_seeded_and_bounded():
    rp = RetryPolicy(budget=3, base_s=0.01, factor=2.0, seed=7)
    d1, d2 = rp.delays(), rp.delays()
    assert d1 == d2 and len(d1) == 3              # pure function of seed
    assert 0.01 <= d1[0] <= 0.015                 # base * (1 + 0.5*u)
    assert d1[1] >= 2 * 0.01 and d1[2] >= 4 * 0.01
    assert RetryPolicy().delays() == []           # budget 0: no retries
    assert RetryPolicy(budget=3, seed=8).delays() != d1
    with pytest.raises(ValueError, match="budget"):
        RetryPolicy(budget=-1)


def test_retriever_overload_knob_validation(rng_index):
    idx = rng_index
    with pytest.raises(RetrievalConfigError, match="watchdog_s"):
        DeviceRetriever(idx, watchdog_s=0.0, **SMALL)
    with pytest.raises(RetrievalConfigError, match="retry_budget"):
        DeviceRetriever(idx, retry_budget=-1, **SMALL)
    with pytest.raises(RetrievalConfigError, match="breaker_threshold"):
        DeviceRetriever(idx, breaker_threshold=0, **SMALL)


@pytest.fixture(scope="module")
def rng_index():
    rng = np.random.default_rng(0)
    corpus = make_corpus(rng, n_docs=150, n_vocab=N_VOCAB, max_len=40)
    return build_index(corpus, N_VOCAB, params=BM25Params())


def test_overload_module_equals_reference():
    """The port's copy is the reference's, class for class (same public
    names, same constructor signatures)."""
    import inspect

    from repro.serve import overload as ref
    from repro_torch.serve import overload as port
    assert port.__all__ == ref.__all__
    for name in ref.__all__:
        assert inspect.signature(getattr(port, name)) == \
            inspect.signature(getattr(ref, name))


def test_concurrent_retrieve_counters_sum_exactly(rng_index):
    """Direct retriever calls racing across threads leave health counters
    (and the kernels' launch counters) that sum exactly — no lost
    updates."""
    from repro_torch.kernels import _build
    dr = DeviceRetriever(rng_index, **SMALL)
    qs = [np.array([1, 2, 3], np.int32), np.array([5, 200], np.int64)]
    base = dr.health()["served"]
    n_threads, per_thread, errs = 8, 6, []

    def caller():
        try:
            for _ in range(per_thread):
                dr.retrieve_batch(qs, 5)
        except BaseException as e:               # noqa: BLE001
            errs.append(e)

    threads = [threading.Thread(target=caller) for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120.0)
    assert not errs
    h = dr.health()
    total = n_threads * per_thread
    assert h["served"] == base + total
    assert h["queries"]["dropped_tokens"] == total   # token 200 >= V
    counter = _build.LaunchCounter("hammer")

    def bump():
        for _ in range(1000):
            counter.add()

    threads = [threading.Thread(target=bump) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert counter.n == 8000
    counter.reset()
    assert counter.n == 0
