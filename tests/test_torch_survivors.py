"""``auto``'s survivor estimate on the device (``estimate_survivors_device``).

The port computes ``block_csr.estimate_prune_survivors`` on the resident
block-max table under ``plan="device"``. Held here, on CPU tensors:

* against the host estimate (the port's numpy copy) and the reference's
  ``repro.sparse.block_csr.estimate_prune_survivors``: the same
  ``survivor_frac``, so the same ``plan_retrieval`` regime, and ``ub``
  bitwise (f32 bits), for the five variants, quantized (u8) and f32
  tables, pow2 padding columns, an empty real query, no visited block
  (``nv == 0``), no real query, ``k`` above the visited count, and lower
  bounds taken in chunks of one query column;
* through the retriever: ``retrieve_batch(regime="auto")`` under
  ``plan="device"`` never calls the numpy estimate, serves boards exact
  against ``ScipyBM25`` and bit-identical to ``plan="host"``, and when it
  picks pruned, the pruned execution reuses the estimate's bounds.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from conftest import make_corpus  # noqa: E402
from repro.core import index as ref_index  # noqa: E402
from repro.core.variants import BM25Params as RefParams  # noqa: E402
from repro.sparse import block_csr as ref_csr  # noqa: E402

from repro_torch.core import (BM25Params, ScipyBM25, build_index,  # noqa: E402
                              plan_retrieval, topk_numpy)
from repro_torch.core.scoring import pad_queries  # noqa: E402
from repro_torch.serve import DeviceRetriever  # noqa: E402
from repro_torch.sparse import block_csr as port_csr  # noqa: E402
from repro_torch.sparse import fragment_device as port_fd  # noqa: E402

ALL_VARIANTS = ["robertson", "atire", "lucene", "bm25l", "bm25+"]
N_VOCAB = 60
SMALL = dict(block_size=16, tile=16, frag=8, q_max=8, device="cpu")


def make_skewed_corpus(rng, n_docs=300):
    """Token 0 has healthy IDF and a few spiky-tf documents (the score
    distribution pruning is for); tokens 55-59 occur nowhere (df 0)."""
    corpus = []
    for d in range(n_docs):
        base = rng.integers(1, 55, size=10).astype(np.int32)
        if d % 3 == 0:
            tf0 = 20 if d % 90 == 0 else 1
            base = np.concatenate([np.zeros(tf0, np.int32), base])
        corpus.append(base)
    return corpus


def _pack(qs, b_pad, u_max=64):
    """``DeviceRetriever._pack_batch``'s tables for ``qs`` padded with
    empty queries to ``b_pad`` columns."""
    qs = list(qs) + [np.zeros(0, np.int32)] * (b_pad - len(qs))
    toks, wts, uniq = pad_queries(qs, 8, return_uniq=True)
    return port_csr.pack_query_batch(toks, wts, u_max, uniq=uniq)


# (name, real queries, pow2 columns)
CASES = {
    "one_query": ([[0]], 8),
    "spiky_token": ([[0], [0, 1], [0]], 4),
    "padding_columns": ([[0, 3], [7, 1, 2], [4]], 8),
    "empty_real_query": ([[0, 5], [], [9, 9, 11]], 4),
    "full_batch": ([[t, t + 1, (3 * t) % 55] for t in range(8)], 8),
    "no_visited_block": ([[55, 56], [57]], 4),
    "no_real_query": ([], 8),
}


def _case(name):
    qs, b_pad = CASES[name]
    return [np.asarray(q, np.int32) for q in qs], b_pad


def _estimates(bm, ref_bm, qs, b_pad, k):
    tab, w = _pack(qs, b_pad)
    f_host, ub_host = port_csr.estimate_prune_survivors(bm, tab, w, k=k,
                                                        b_true=len(qs))
    f_ref, ub_ref = ref_csr.estimate_prune_survivors(ref_bm, tab, w, k=k,
                                                     b_true=len(qs))
    f_dev, ub_dev = port_fd.estimate_survivors_device(
        bm.device, bm.scale_dev, torch.as_tensor(tab), torch.as_tensor(w),
        quantized=bm.quantized, k=k, b_true=len(qs))
    return (f_host, ub_host), (f_ref, ub_ref), (f_dev, ub_dev.numpy())


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("dtype", ["f32", "u8"])
@pytest.mark.parametrize("method", ALL_VARIANTS)
def test_device_estimate_equals_host(method, dtype, case, rng):
    """Same ``survivor_frac`` as the host and the reference (so the same
    regime), ``ub`` bitwise, at k = 1, 5 and past the visited count."""
    corpus = make_skewed_corpus(rng)
    port = build_index(corpus, N_VOCAB, params=BM25Params(method=method))
    ref = ref_index.build_index(corpus, N_VOCAB,
                                params=RefParams(method=method))
    bm = port_csr.build_block_max(port, block_size=16, dtype=dtype,
                                  device="cpu")
    ref_bm = ref_csr.build_block_max(ref, block_size=16, dtype=dtype)
    qs, b_pad = _case(case)
    sum_df = int(np.diff(port.indptr)[np.unique(np.concatenate(
        [np.zeros(0, np.int32), *qs]))].sum())
    fracs = {}
    for k in (1, 5, 1000):
        (fh, uh), (fr, ur), (fd, ud) = _estimates(bm, ref_bm, qs, b_pad, k)
        fracs[k] = fd
        assert fd == fh == fr
        assert ud.dtype == uh.dtype == np.float32 and ud.shape == uh.shape
        assert ud.tobytes() == uh.tobytes() == ur.tobytes()
        regimes = {plan_retrieval(sum_df, port.nnz, regime="auto",
                                  plan="device", survivor_frac=f).regime
                   for f in (fd, fh)}
        assert len(regimes) == 1
    if case in ("no_visited_block", "no_real_query"):
        assert set(fracs.values()) == {1.0}  # the early returns
    if case == "spiky_token":
        assert fracs[1] < 1.0                # blocks are estimated out


def test_device_estimate_in_chunks_of_one_column(monkeypatch, rng):
    """A chunk cap below one query column's lower bounds takes them one
    column at a time, with the same result."""
    port = build_index(make_skewed_corpus(rng), N_VOCAB,
                       params=BM25Params())
    bm = port_csr.build_block_max(port, block_size=16, dtype="u8",
                                  device="cpu")
    qs, b_pad = _case("spiky_token")
    tab, w = _pack(qs, b_pad)
    args = (bm.device, bm.scale_dev, torch.as_tensor(tab),
            torch.as_tensor(w))
    whole = port_fd.estimate_survivors_device(*args, quantized=True, k=3,
                                              b_true=len(qs))
    monkeypatch.setattr(port_fd, "LB_CHUNK_ELEMS", 1)
    cut = port_fd.estimate_survivors_device(*args, quantized=True, k=3,
                                            b_true=len(qs))
    assert cut[0] == whole[0] < 1.0
    assert cut[1].numpy().tobytes() == whole[1].numpy().tobytes()


def _no_host_estimate(*a, **kw):
    raise AssertionError("the numpy survivor estimate ran under "
                         'plan="device"')


@pytest.mark.parametrize("method", ALL_VARIANTS)
def test_auto_under_device_plan_skips_the_host_estimate(method, monkeypatch,
                                                        rng):
    """``auto`` under ``plan="device"`` never calls the numpy estimate,
    records the host's ``survivor_frac`` and regime, and serves boards
    bit-identical to ``plan="host"`` and exact against ``ScipyBM25``."""
    idx = build_index(make_corpus(rng, n_docs=120, n_vocab=N_VOCAB),
                      N_VOCAB, params=BM25Params(method=method))
    host = DeviceRetriever(idx, regime="auto", plan="host", **SMALL)
    dev = DeviceRetriever(idx, regime="auto", plan="device", **SMALL)
    batches = [[rng.integers(0, N_VOCAB, size=rng.integers(1, 6)
                             ).astype(np.int32) for _ in range(b)]
               for b in (1, 3, 8)]
    want = [host.retrieve_batch(qs, 7) for qs in batches]
    monkeypatch.setattr(port_csr, "estimate_prune_survivors",
                        _no_host_estimate)
    oracle = ScipyBM25(idx)
    for qs, h in zip(batches, want):
        r = dev.retrieve_batch(qs, 7)
        assert r.plan.plan == "device"
        assert r.plan.survivor_frac == h.plan.survivor_frac
        assert r.plan.regime == h.plan.regime
        np.testing.assert_array_equal(r.ids, h.ids)
        np.testing.assert_array_equal(r.scores.view(np.int32),
                                      h.scores.view(np.int32))
        for i, q in enumerate(qs):
            s = oracle.score(q)
            _, ref_v = topk_numpy(s[None], 7)
            np.testing.assert_allclose(r.scores[i], ref_v[0], atol=1e-4)
            np.testing.assert_allclose(s[r.ids[i]], r.scores[i], atol=1e-4)


def test_auto_pruned_reuses_the_estimate_bounds(monkeypatch, rng):
    """When the device estimate routes a batch to pruned, the pruned
    execution takes its bounds instead of computing them again."""
    idx = build_index(make_skewed_corpus(rng), N_VOCAB, params=BM25Params())
    q = [np.array([0], np.int32)]
    want = DeviceRetriever(idx, regime="gathered", **SMALL).retrieve_batch(
        q, 1)
    auto = DeviceRetriever(idx, regime="auto", plan="device", **SMALL)
    monkeypatch.setattr(port_csr, "estimate_prune_survivors",
                        _no_host_estimate)
    real, calls = port_fd._bounds, []

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(port_fd, "_bounds", counted)
    r = auto.retrieve_batch(q, 1)
    assert r.plan.regime == "pruned" and r.plan.frags_pruned > 0
    assert len(calls) == 1                   # the estimate's, reused
    np.testing.assert_array_equal(r.ids, want.ids)
    np.testing.assert_array_equal(r.scores.view(np.int32),
                                  want.scores.view(np.int32))
