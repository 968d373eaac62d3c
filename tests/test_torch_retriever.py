"""The port's slice end to end on ``device="cpu"``: DeviceRetriever exact.

The retriever's query path — pack, plan, the gathered (K1), pruned (K1
seed + K3) or full-scan (K2) regime, default splice and shift — runs here
on the CPU through the kernels' plain twins, and every board must be exact
against the port's ``ScipyBM25`` oracle (atol 1e-4, as the reference's
device tests hold theirs), for all variants, every regime and ``auto``,
k in {1, 7, ≥ n_docs}, empty queries and robertson's negative IDF.
"""

import numpy as np
import pytest
import torch

from conftest import make_corpus
from repro_torch.core import BM25Params, ScipyBM25, build_index, topk_numpy
from repro_torch.serve import (DeviceRetriever, ResidencyError,
                               RetrievalConfigError, ScoreIntegrityError)
from repro_torch.sparse.block_csr import TRANSFERS, reset_transfer_stats

ALL_VARIANTS = ["robertson", "atire", "lucene", "bm25l", "bm25+", "tfldp"]
SMALL = dict(block_size=16, tile=16, frag=8, q_max=8, device="cpu")


def _check_exact(idx, queries, ids, vals, k, atol=1e-4):
    sc = ScipyBM25(idx)
    for i, q in enumerate(queries):
        oracle = sc.score(q)
        _, ref_v = topk_numpy(oracle[None], k)
        np.testing.assert_allclose(vals[i], ref_v[0], atol=atol)
        # returned ids carry their exact oracle scores, each once
        np.testing.assert_allclose(oracle[ids[i] - idx.doc_offset], vals[i],
                                   atol=atol)
        assert len(set(ids[i].tolist())) == ids.shape[1]


@pytest.mark.parametrize("method", ALL_VARIANTS)
@pytest.mark.parametrize("regime", ["auto", "gathered", "blocked", "pruned"])
def test_slice_exact_against_scipy_oracle(method, regime, rng):
    corpus = make_corpus(rng, n_docs=90, n_vocab=64, max_len=20)
    idx = build_index(corpus, 64, params=BM25Params(method=method))
    dr = DeviceRetriever(idx, regime=regime, **SMALL)
    queries = [rng.integers(0, 64, size=rng.integers(1, 6)).astype(np.int32)
               for _ in range(4)] + [np.zeros(0, np.int32)]
    for k in (1, 7, 90, 200):
        ids, vals = dr.retrieve_batch(queries, k)
        assert ids.shape == vals.shape == (len(queries), min(k, 90))
        _check_exact(idx, queries, ids, vals, k)
    if regime != "auto":
        assert dr.last_plan.regime == regime and dr.last_plan.forced


def test_robertson_defaults_beat_negative_scores():
    """robertson head tokens score NEGATIVE; docs they never touch score
    exactly 0 and must win (through the default splice when gathered)."""
    rng = np.random.default_rng(7)
    corpus = [rng.integers(0, 6, size=rng.integers(3, 10)).astype(np.int32)
              for _ in range(40)]
    idx = build_index(corpus, 6, params=BM25Params(method="robertson"))
    for regime in ("gathered", "blocked"):
        dr = DeviceRetriever(idx, regime=regime, **SMALL)
        q = np.array([0, 1], dtype=np.int32)
        ids, vals = dr.retrieve_batch([q], 10)
        _check_exact(idx, [q], ids, vals, 10, atol=1e-5)
        assert (vals[0] == 0.0).any()                 # defaults actually won
        assert (ScipyBM25(idx).score(q) < 0).any()


def test_auto_plans_each_batch_and_regime_override(rng):
    corpus = make_corpus(rng, n_docs=64, n_vocab=8, max_len=20)
    idx = build_index(corpus, 8, params=BM25Params(method="lucene"))
    dr = DeviceRetriever(idx, regime="auto", **SMALL)
    dense = [np.arange(8, dtype=np.int32)] * 3        # Σ df ≈ nnz
    r = dr.retrieve_batch(dense, 5)
    assert r.plan.regime == "blocked" and not r.plan.forced
    _check_exact(idx, dense, r.ids, r.scores, 5)
    r = dr.retrieve_batch(dense, 5, regime="gathered")
    assert r.plan.regime == "gathered" and r.plan.forced
    assert dr.last_plan is r.plan and r.plan.frags_planned > 0
    _check_exact(idx, dense, r.ids, r.scores, 5)


def test_second_batch_ships_zero_posting_bytes(rng):
    corpus = make_corpus(rng, n_docs=80, n_vocab=40)
    idx = build_index(corpus, 40, params=BM25Params(method="bm25+"))
    reset_transfer_stats()
    dr = DeviceRetriever(idx, regime="auto", **SMALL)
    assert TRANSFERS.posting_bytes > 0                # the one-time upload
    queries = [rng.integers(0, 40, size=4).astype(np.int32)
               for _ in range(3)]
    dr.retrieve_batch(queries, 5)
    reset_transfer_stats()
    for regime in ("gathered", "blocked"):
        dr.retrieve_batch(queries, 5, regime=regime)
    assert TRANSFERS.posting_bytes == 0
    assert TRANSFERS.posting_uploads == 0
    assert TRANSFERS.descriptor_bytes > 0             # O(nf) fragment table


def test_packed_batch_equals_one_call_path(rng):
    corpus = make_corpus(rng, n_docs=50, n_vocab=30)
    idx = build_index(corpus, 30, params=BM25Params(method="atire"))
    dr = DeviceRetriever(idx, **SMALL)
    queries = [rng.integers(0, 30, size=3).astype(np.int32)
               for _ in range(5)]
    a = dr.retrieve_batch(queries, 6)
    b = dr.retrieve_batch(None, 6, packed=dr.pack_batch(queries))
    np.testing.assert_array_equal(a.ids, b.ids)
    np.testing.assert_array_equal(a.scores, b.scores)
    one = dr.retrieve(queries[0], 6)
    np.testing.assert_array_equal(one.ids, a.ids[0])


def test_doc_offset_is_added(rng):
    corpus = make_corpus(rng, n_docs=40, n_vocab=30)
    idx = build_index(corpus, 30, params=BM25Params(method="lucene"),
                      doc_offset=1000)
    dr = DeviceRetriever(idx, **SMALL)
    q = [np.array([1, 2, 3], np.int32)]
    ids, vals = dr.retrieve_batch(q, 5)
    assert (ids >= 1000).all()
    _check_exact(idx, q, ids, vals, 5)


def test_no_gpu_without_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    idx = build_index([np.array([0, 1], np.int32)], 2)
    with pytest.raises(ResidencyError, match="device='cpu'"):
        DeviceRetriever(idx)
    with pytest.raises(ResidencyError):
        DeviceRetriever(idx, device="cuda")


@pytest.mark.parametrize("kwargs", [dict(regime="pruned", gather="host"),
                                    dict(reorder="zorder"),
                                    dict(plan="device", gather="host"),
                                    dict(host_arrays="drop", plan="host"),
                                    dict(regime="nope"),
                                    dict(gather="nope"),
                                    dict(plan="nope"),
                                    dict(host_arrays="nope")])
def test_unported_and_unknown_modes_raise(kwargs):
    idx = build_index([np.array([0, 1], np.int32)], 2)
    with pytest.raises(RetrievalConfigError):
        DeviceRetriever(idx, device="cpu", **kwargs)


def test_forced_regime_needs_its_layout(rng):
    corpus = make_corpus(rng, n_docs=30, n_vocab=20)
    idx = build_index(corpus, 20)
    q = [np.array([1, 2], np.int32)]
    with pytest.raises(ResidencyError):
        DeviceRetriever(idx, regime="gathered", **SMALL).retrieve_batch(
            q, 3, regime="blocked")
    with pytest.raises(ResidencyError):
        DeviceRetriever(idx, regime="blocked", **SMALL).retrieve_batch(
            q, 3, regime="gathered")
    with pytest.raises(ResidencyError):
        DeviceRetriever(idx, regime="blocked", **SMALL).retrieve_batch(
            q, 3, regime="pruned")


def test_non_finite_board_raises_score_integrity(monkeypatch, rng):
    """The finite-check on the board raises the typed error; a strict
    retriever surfaces it, a degrading one serves the batch from the next
    rung (the host gather) and records the hop."""
    from repro_torch.kernels import ops
    corpus = make_corpus(rng, n_docs=30, n_vocab=20)
    idx = build_index(corpus, 20)
    real = ops.bm25_retrieve_resident

    def poisoned(*a, **kw):
        ids, vals = real(*a, **kw)
        return ids, vals * float("nan")

    monkeypatch.setattr(ops, "bm25_retrieve_resident", poisoned)
    q = [np.array([1], np.int32)]
    strict = DeviceRetriever(idx, regime="gathered", on_fault="raise",
                             **SMALL)
    with pytest.raises(ScoreIntegrityError):
        strict.retrieve_batch(q, 3)
    dr = DeviceRetriever(idx, regime="gathered", **SMALL)
    r = dr.retrieve_batch(q, 3)
    assert [(t["from"], t["to"], t["error"]) for t in r.degradations] == \
        [("resident", "host", "ScoreIntegrityError")]
    _check_exact(idx, q, r.ids, r.scores, 3)


def test_empty_index_and_k_zero(rng):
    corpus = make_corpus(rng, n_docs=20, n_vocab=10)
    idx = build_index(corpus, 10)
    dr = DeviceRetriever(idx, **SMALL)
    ids, vals = dr.retrieve_batch([np.array([1], np.int32)], 0)
    assert ids.shape == vals.shape == (1, 0)
    dr.warmup(k=5)
