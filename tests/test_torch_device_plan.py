"""Device fragment planning in the port, against the reference and the host.

* ``repro_torch.sparse.fragment_device.build_fragment_table`` /
  ``plan_fragments_device`` (torch ops, run here on the CPU) emit the same
  ``[6, nf_pad]`` table and default ids as the reference's jnp builder
  ``repro.sparse.fragment_device.build_fragment_table`` and as the port's
  host ``fragment_plan`` + ``default_doc_ids``, byte for byte: head, tail
  and dense profiles, empty queries, df-0 tokens, a forced overflow retry
  and the estimate/state path.
* The planner (``DEVICE_PLAN_DISCOUNT``, ``plan=``, ``survivor_frac=``)
  decides as the reference's does.
* ``DeviceRetriever(plan="device")`` serves the same boards as
  ``plan="host"``, ships zero posting AND zero descriptor bytes per batch,
  and with ``host_arrays="drop"`` serves exact from the resident tensors.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from conftest import given, make_corpus, settings, st  # noqa: E402
from repro.core.retrieval import plan_retrieval as ref_plan  # noqa: E402
from repro.sparse import fragment_device as ref_fd  # noqa: E402

from repro_torch.core import (BM25Params, ScipyBM25, build_index,  # noqa: E402
                              default_doc_ids, plan_retrieval, topk_numpy)
from repro_torch.core.retrieval import (DEFAULT_CROSSOVER,  # noqa: E402
                                        DEVICE_PLAN_DISCOUNT)
from repro_torch.serve import (DeviceRetriever, ResidencyError,  # noqa: E402
                               RetrievalConfigError)
from repro_torch.sparse.block_csr import (TRANSFERS, DeviceIndex,  # noqa: E402
                                          bucket_pow2, fragment_plan,
                                          reset_transfer_stats)
from repro_torch.sparse.fragment_device import (  # noqa: E402
    build_fragment_table, plan_fragments_device)

ALL_VARIANTS = ["robertson", "atire", "lucene", "bm25l", "bm25+"]
SMALL = dict(block_size=16, tile=16, frag=8, q_max=8, device="cpu")
BIG = np.iinfo(np.int32).max


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert a.tobytes() == b.tobytes()


def _pad_uniq(uniq: np.ndarray, floor: int = 8) -> np.ndarray:
    """uniq tokens -> the padded sentinel table ``pack_query_batch`` uses."""
    u_max = bucket_pow2(max(uniq.size, 1), floor=floor)
    tab = np.full(u_max, BIG, dtype=np.int32)
    tab[: uniq.size] = uniq
    return tab


def _profile_uniq(rng, profile: str, n_vocab: int) -> np.ndarray:
    if profile == "head":
        pool = np.arange(0, max(4, n_vocab // 8))
    elif profile == "dense":
        return np.arange(n_vocab, dtype=np.int64)
    else:
        pool = np.arange(n_vocab // 2, n_vocab)
    return np.unique(rng.choice(pool, size=6)).astype(np.int64)


def _three_tables(di, idx, uniq, *, block_size, frag, k, nf_pad):
    """(port torch, reference jnp, host) tables for one batch."""
    n_docs = int(idx.doc_lens.size)
    sum_df = int(np.diff(idx.indptr)[uniq].sum())
    p_bucket = bucket_pow2(max(sum_df, 1), floor=8)
    tab = _pad_uniq(uniq)
    port = build_fragment_table(
        torch.as_tensor(tab), di.csc_indptr, di.csc_doc_ids,
        block_size=block_size, frag=frag, nf_pad=nf_pad, p_bucket=p_bucket,
        k=k, n_docs=n_docs)
    ref = ref_fd.build_fragment_table(
        jnp.asarray(tab), jnp.asarray(di.csc_indptr.numpy()),
        jnp.asarray(di.csc_doc_ids.numpy()), block_size=block_size,
        frag=frag, nf_pad=nf_pad, p_bucket=p_bucket, k=k, n_docs=n_docs)
    fp = fragment_plan(idx, uniq, block_size=block_size, frag=frag,
                       nf_bucket=nf_pad)
    host = (fp.desc, default_doc_ids(fp.vis_blocks, k, n_docs, block_size))
    return port, ref, host, fp


@pytest.mark.parametrize("profile", ["head", "tail", "dense"])
@pytest.mark.parametrize("block_size,frag", [(16, 8), (32, 4)])
def test_device_table_equals_reference_and_host(profile, block_size, frag,
                                                rng):
    corpus = make_corpus(rng, n_docs=120, n_vocab=48, max_len=25)
    idx = build_index(corpus, 48, params=BM25Params())
    di = DeviceIndex.build(idx, device="cpu", block_size=block_size,
                           tile=16, frag=frag, with_blocked=False)
    uniq = _profile_uniq(rng, profile, 48)
    nf_pad = fragment_plan(idx, uniq, block_size=block_size,
                           frag=frag).nf_pad
    (desc, dids, nf, over), ref, host, fp = _three_tables(
        di, idx, uniq, block_size=block_size, frag=frag, k=5,
        nf_pad=nf_pad)
    assert (nf, over) == (int(ref[2]), bool(ref[3])) == (fp.n_frags, False)
    for got in (np.asarray(ref[0]), host[0]):
        _same(desc.numpy(), got)
    for got in (np.asarray(ref[1]), host[1]):
        _same(dids.numpy(), got)


def test_device_table_empty_query_and_df0_tokens(rng):
    corpus = make_corpus(rng, n_docs=40, n_vocab=64, max_len=10)
    idx = build_index(corpus, 64, params=BM25Params())
    di = DeviceIndex.build(idx, device="cpu", block_size=16, tile=16,
                           frag=8, with_blocked=False)
    df = np.diff(idx.indptr)
    cases = [np.zeros(0, np.int64)]
    assert (df == 0).any()                     # the corpus has df-0 tokens
    cases.append(np.flatnonzero(df == 0)[:3].astype(np.int64))
    for uniq in cases:
        (desc, dids, nf, over), ref, host, fp = _three_tables(
            di, idx, uniq, block_size=16, frag=8, k=4, nf_pad=8)
        assert fp.n_frags == nf == 0 and not over
        for got in (np.asarray(ref[0]), host[0]):
            _same(desc.numpy(), got)
        for got in (np.asarray(ref[1]), host[1]):
            _same(dids.numpy(), got)


def test_device_table_overflow_flag_and_retry(rng):
    """A too-small bucket reports overflow with the true count (as the
    reference's flag does), and the wrapper retries to a bucket that
    reproduces the host table: overflow is a retry, never truncation."""
    corpus = make_corpus(rng, n_docs=120, n_vocab=32, max_len=25)
    idx = build_index(corpus, 32, params=BM25Params())
    di = DeviceIndex.build(idx, device="cpu", block_size=16, tile=16,
                           frag=8, with_blocked=False)
    uniq = np.arange(32, dtype=np.int64)
    fp = fragment_plan(idx, uniq, block_size=16, frag=8)
    assert fp.n_frags > 8
    (desc, _, nf, over), ref, _, _ = _three_tables(
        di, idx, uniq, block_size=16, frag=8, k=5, nf_pad=8)
    assert over and bool(ref[3]) and desc is None
    assert nf == int(ref[2]) == fp.n_frags
    sum_df = int(np.diff(idx.indptr).sum())
    desc, dids, nf_used = plan_fragments_device(
        di, _pad_uniq(uniq), sum_df=sum_df, k=5, block_size=16,
        nf_bucket=8)
    assert nf_used >= bucket_pow2(fp.n_frags, floor=8)
    ref_fp = fragment_plan(idx, uniq, block_size=16, frag=8,
                           nf_bucket=nf_used)
    _same(desc.numpy(), ref_fp.desc)
    _same(dids.numpy(), default_doc_ids(ref_fp.vis_blocks, 5, idx.n_docs,
                                        16))


def test_device_plan_estimate_and_state(rng):
    """Without ``nf_bucket`` the estimate still covers the fragments, and
    ``state`` keeps the bucket for the next batch."""
    corpus = make_corpus(rng, n_docs=100, n_vocab=32, max_len=25)
    idx = build_index(corpus, 32, params=BM25Params())
    di = DeviceIndex.build(idx, device="cpu", block_size=16, tile=16,
                           frag=8, with_blocked=False)
    uniq = np.arange(32, dtype=np.int64)
    sum_df = int(np.diff(idx.indptr).sum())
    state = {}
    desc, _, nf_used = plan_fragments_device(
        di, _pad_uniq(uniq), sum_df=sum_df, k=5, block_size=16, state=state)
    fp = fragment_plan(idx, uniq, block_size=16, frag=8, nf_bucket=nf_used)
    _same(desc.numpy(), fp.desc)
    assert state["nf"] == nf_used
    ref = ref_fd.plan_fragments_device(
        _RefView(di), _pad_uniq(uniq), sum_df=sum_df, k=5, block_size=16,
        state={})
    assert ref[2] == nf_used
    _same(desc.numpy(), np.asarray(ref[0]))


class _RefView:
    """The port's DeviceIndex as the reference's planner reads one."""

    def __init__(self, di):
        self.csc_indptr = jnp.asarray(di.csc_indptr.numpy())
        self.csc_doc_ids = jnp.asarray(di.csc_doc_ids.numpy())
        self.block_size, self.frag, self.n_docs = (di.block_size, di.frag,
                                                   di.n_docs)


def test_device_plan_requires_resident_csc(rng):
    corpus = make_corpus(rng, n_docs=30, n_vocab=16)
    idx = build_index(corpus, 16, params=BM25Params())
    di = DeviceIndex.build(idx, device="cpu", with_csc=False)
    with pytest.raises(ResidencyError, match="resident CSC"):
        plan_fragments_device(di, _pad_uniq(np.array([1])), sum_df=3, k=2)


@settings(max_examples=15, deadline=None)
@given(seed=st.integers(0, 2 ** 31), block_size=st.sampled_from([8, 16, 32]),
       frag=st.sampled_from([4, 8, 16]))
def test_property_device_table_equals_host(seed, block_size, frag):
    rng = np.random.default_rng(seed)
    v = int(rng.integers(10, 60))
    corpus = [rng.integers(0, v, size=rng.integers(1, 20)).astype(np.int32)
              for _ in range(int(rng.integers(10, 150)))]
    idx = build_index(corpus, v, params=BM25Params())
    di = DeviceIndex.build(idx, device="cpu", block_size=block_size,
                           tile=16, frag=frag, with_blocked=False)
    uniq = np.unique(
        rng.integers(0, v, size=rng.integers(1, 12))).astype(np.int64)
    fp = fragment_plan(idx, uniq, block_size=block_size, frag=frag)
    k = int(rng.integers(1, 8))
    desc, dids, _ = plan_fragments_device(
        di, _pad_uniq(uniq), sum_df=fp.sum_df, k=k, block_size=block_size,
        nf_bucket=fp.nf_pad)
    _same(desc.numpy(), fp.desc)
    _same(dids.numpy(), default_doc_ids(fp.vis_blocks, k, idx.n_docs,
                                        block_size))


# -- planner ------------------------------------------------------------------

def test_planner_decisions_match_reference():
    for sum_df, nnz in ((0, 100), (10, 100), (50, 100), (60, 100),
                        (70, 100), (400, 100)):
        for regime in ("auto", "blocked", "gathered", "pruned"):
            for plan in ("host", "device"):
                for crossover in (None, 0.5, 4.0):
                    for frac in (None, 0.1, 0.5, 0.9):
                        kw = dict(regime=regime, crossover=crossover,
                                  plan=plan, survivor_frac=frac)
                        a, b = ref_plan(sum_df, nnz, **kw), \
                            plan_retrieval(sum_df, nnz, **kw)
                        assert (b.regime, b.forced, b.crossover,
                                b.work_ratio, b.plan, b.survivor_frac) == \
                            (a.regime, a.forced, a.crossover,
                             a.work_ratio, a.plan, a.survivor_frac)


def test_planner_device_plan_discount():
    """A work ratio between the discounted and the full crossover gathers
    under device planning and full-scans under host planning; explicit
    crossovers are used verbatim."""
    ratio = (DEFAULT_CROSSOVER * DEVICE_PLAN_DISCOUNT
             + DEFAULT_CROSSOVER) / 2.0
    nnz, sum_df = int(ratio * 1000), 1000
    host = plan_retrieval(sum_df, nnz, plan="host")
    dev = plan_retrieval(sum_df, nnz, plan="device")
    assert host.regime == "blocked" and host.plan == "host"
    assert dev.regime == "gathered" and dev.plan == "device"
    assert dev.crossover == pytest.approx(
        DEFAULT_CROSSOVER * DEVICE_PLAN_DISCOUNT)
    pinned = plan_retrieval(sum_df, nnz, plan="device", crossover=5.0)
    assert pinned.crossover == 5.0 and pinned.regime == "blocked"
    with pytest.raises(ValueError, match="plan mode"):
        plan_retrieval(1, 1, plan="tpu")


# -- the retriever under plan="device" ----------------------------------------

@pytest.mark.parametrize("method", ALL_VARIANTS)
def test_device_plan_boards_equal_host_plan(method, rng):
    corpus = make_corpus(rng, n_docs=90, n_vocab=64, max_len=20)
    idx = build_index(corpus, 64, params=BM25Params(method=method))
    dev = DeviceRetriever(idx, regime="gathered", plan="device", **SMALL)
    host = DeviceRetriever(idx, regime="gathered", plan="host", **SMALL)
    queries = [rng.integers(0, 64, size=rng.integers(1, 6)).astype(np.int32)
               for _ in range(4)] + [np.zeros(0, np.int32)]
    for k in (1, 7, 90):
        a = dev.retrieve_batch(queries, k)
        b = host.retrieve_batch(queries, k)
        _same(a.ids, b.ids)
        _same(a.scores, b.scores)
        assert a.plan.plan == "device" and b.plan.plan == "host"
        assert a.plan.frags_planned == b.plan.frags_planned
    sc = ScipyBM25(idx)
    for i, q in enumerate(queries):
        oracle = sc.score(q)
        _, ref_v = topk_numpy(oracle[None], 90)
        np.testing.assert_allclose(a.scores[i], ref_v[0], atol=1e-4)
        np.testing.assert_allclose(oracle[a.ids[i]], a.scores[i], atol=1e-4)


def test_device_plan_ships_zero_posting_and_descriptor_bytes(rng):
    """With plan="device" a steady-state batch ships NOTHING through the
    counted channels; plan="host" on the same index still ships
    descriptors (the contrast that proves the counter works)."""
    corpus = make_corpus(rng, n_docs=120, n_vocab=60)
    idx = build_index(corpus, 60, params=BM25Params(method="lucene"))
    dr = DeviceRetriever(idx, regime="auto", plan="device", **SMALL)
    dr.warmup(k=5)
    qs = [rng.integers(0, 60, size=4).astype(np.int32) for _ in range(5)]
    dr.retrieve_batch(qs, 5)                     # settle the nf bucket
    reset_transfer_stats()
    for regime in (None, "blocked", "gathered", "pruned"):
        for _ in range(2):
            dr.retrieve_batch(qs, 5, regime=regime)
    assert TRANSFERS.posting_uploads == 0, vars(TRANSFERS)
    assert TRANSFERS.posting_bytes == 0
    assert TRANSFERS.descriptor_uploads == 0, vars(TRANSFERS)
    assert TRANSFERS.descriptor_bytes == 0
    assert dr.last_plan.plan == "device"
    hp = DeviceRetriever(idx, regime="gathered", plan="host", **SMALL)
    hp.retrieve_batch(qs, 5)
    reset_transfer_stats()
    hp.retrieve_batch(qs, 5)
    assert TRANSFERS.posting_bytes == 0
    assert TRANSFERS.descriptor_bytes > 0
    assert hp.last_plan.plan == "host"


@pytest.mark.parametrize("regime", ["gathered", "pruned", "auto"])
def test_host_arrays_drop_serves_exact(regime, rng):
    corpus = make_corpus(rng, n_docs=100, n_vocab=50)
    idx = build_index(corpus, 50, params=BM25Params(method="robertson"))
    dr = DeviceRetriever(idx, regime=regime, plan="device",
                         host_arrays="drop", **SMALL)
    assert dr.dindex.host is None
    assert dr.index.doc_ids.size == 0 and dr.index.scores.size == 0
    assert idx.doc_ids.size > 0                  # caller's copy untouched
    sc = ScipyBM25(idx)
    queries = [rng.integers(0, 50, size=rng.integers(1, 5)).astype(np.int32)
               for _ in range(3)]
    ids, vals = dr.retrieve_batch(queries, 6)
    for i, q in enumerate(queries):
        oracle = sc.score(q)
        _, ref_v = topk_numpy(oracle[None], 6)
        np.testing.assert_allclose(vals[i], ref_v[0], atol=1e-4)
        np.testing.assert_allclose(oracle[ids[i]], vals[i], atol=1e-4)


def test_drop_mode_and_plan_guards(rng):
    corpus = make_corpus(rng, n_docs=20, n_vocab=10)
    idx = build_index(corpus, 10, params=BM25Params())
    with pytest.raises(RetrievalConfigError, match="device"):
        DeviceRetriever(idx, regime="gathered", plan="host",
                        host_arrays="drop", **SMALL)
    with pytest.raises(RetrievalConfigError, match="resident"):
        DeviceRetriever(idx, regime="gathered", gather="host",
                        plan="device", **SMALL)
    with pytest.raises(ValueError, match="host_arrays"):
        DeviceIndex.build(idx, device="cpu", host_arrays="free")
    assert DeviceRetriever(idx, **SMALL).plan_mode == "host"   # CPU default
