"""The eager torch scorer (``repro_torch.core.scoring``) against the JAX
package's ``repro.core.scoring``, which runs here (jnp, no Pallas).

* ``score_query`` / ``score_batch`` on the same padded batch and the same
  arrays (the reference's ``DeviceIndex`` carried across with
  ``convert.scoring_index_from_reference``), for every method: rtol 1e-6 /
  atol 1e-5 — both sum each document's postings in slot order, but the
  §2.1 shift is a 32-term reduction that XLA and torch may group
  differently;
* the overflow flag ``Σdf > p_max``, and the truncated sums under a
  too-small ``p_max`` (the same slot order drops the same postings);
* the per-token-position passes bit for bit against one serial pass over
  the reference's slots (duplicate tokens, holes, truncation);
* the budget helpers, byte-identical;
* the reference's own cases, mirrored: the gather path exact against
  ``dense_oracle_scores`` and duplicate query tokens weighted
  (``tests/test_scoring.py``, atol 1e-4), and two-stage top-k equal to a
  full sort as a hypothesis property (``tests/test_topk.py``, exact).
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import repro.core as R  # noqa: E402
from repro.core import scoring as ref_scoring  # noqa: E402

from conftest import given, make_corpus, settings, st  # noqa: E402
from repro_torch.convert import scoring_index_from_reference  # noqa: E402
from repro_torch.core import (BM25Params, DeviceIndex, ScipyBM25,  # noqa: E402
                              batch_posting_budget, blockwise_topk,
                              build_index, dense_oracle_scores, pad_queries,
                              query_posting_budget, score_batch, score_query,
                              suggest_p_max)
from repro_torch.sparse.block_csr import (TRANSFERS,  # noqa: E402
                                          reset_transfer_stats)

METHODS = ["robertson", "atire", "lucene", "bm25l", "bm25+", "tfldp"]
RTOL, ATOL = 1e-6, 1e-5
N_VOCAB = 50


def _both(method, seed=0, n_docs=80, b=6):
    rng = np.random.default_rng(seed)
    corpus = make_corpus(rng, n_docs=n_docs, n_vocab=N_VOCAB)
    p = R.BM25Params(method=method)
    ridx = R.build_index(corpus, N_VOCAB, params=p)
    rdi = R.DeviceIndex.from_host(ridx)
    idx = build_index(corpus, N_VOCAB, params=BM25Params(method=method))
    di = scoring_index_from_reference(rdi, device="cpu")
    qs = [rng.integers(0, N_VOCAB, size=rng.integers(0, 7)).astype(np.int32)
          for _ in range(b)]
    qs.append(np.array([3, 3, 7, 3], np.int32))      # repeated tokens
    toks, wts = pad_queries(qs, 8)
    return corpus, ridx, rdi, idx, di, qs, toks, wts


@pytest.mark.parametrize("method", METHODS)
def test_score_batch_matches_reference(method):
    corpus, ridx, rdi, idx, di, qs, toks, wts = _both(method, seed=1)
    p_max = suggest_p_max(idx, 8)
    assert p_max == R.suggest_p_max(ridx, 8)
    got, over = score_batch(di, toks, wts, p_max=p_max, return_overflow=True)
    ref, rover = R.score_batch(rdi, toks, wts, p_max=p_max,
                               return_overflow=True)
    assert got.shape == (len(qs), idx.n_docs) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_array_equal(over.numpy(), np.asarray(rover))
    assert not over.any()
    np.testing.assert_array_equal(
        score_batch(di, toks, wts, p_max=p_max).numpy(), got.numpy())
    for i in (0, len(qs) - 1):
        s, o = score_query(di, toks[i], wts[i], p_max=p_max)
        rs, ro = ref_scoring.score_query(rdi, jnp.asarray(toks[i]),
                                         jnp.asarray(wts[i]), p_max=p_max)
        np.testing.assert_allclose(s.numpy(), np.asarray(rs), rtol=RTOL,
                                   atol=ATOL)
        assert bool(o) == bool(ro)


@pytest.mark.parametrize("method", ["robertson", "lucene", "bm25+"])
@pytest.mark.parametrize("p_max", [1, 7, 40])
def test_small_budget_truncates_like_reference(method, p_max):
    """Too small a ``p_max``: the flag marks the queries whose demand
    exceeds it, and both drop the same trailing postings."""
    corpus, ridx, rdi, idx, di, qs, toks, wts = _both(method, seed=p_max)
    got, over = score_batch(di, toks, wts, p_max=p_max, return_overflow=True)
    ref, rover = R.score_batch(rdi, toks, wts, p_max=p_max,
                               return_overflow=True)
    np.testing.assert_array_equal(over.numpy(), np.asarray(rover))
    demand = [query_posting_budget(idx, t[None]) for t in toks]
    np.testing.assert_array_equal(over.numpy(), np.array(demand) > p_max)
    assert over.any()
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


def test_score_batch_groups_do_not_change_sums(monkeypatch):
    """Queries are scattered in groups bounded by a slot budget; a budget
    of one slot (a query a group) gives the same bits."""
    from repro_torch.core import scoring
    *_, di, qs, toks, wts = _both("bm25l", seed=4, b=12)
    whole = score_batch(di, toks, wts, p_max=1024)
    monkeypatch.setattr(scoring, "_SLOTS_PER_STEP", 1)
    grouped = score_batch(di, toks, wts, p_max=1024)
    assert torch.equal(whole.view(torch.int32), grouped.view(torch.int32))


def _serial_slot_sums(idx, toks, wts, p_max):
    """One serial f32 pass over the reference's slots: query by query,
    token ``i``'s run before token ``i + 1``'s, CSC order within a run, at
    most ``p_max`` slots a query, each ``fl(score · w)`` added in turn."""
    out = np.zeros((toks.shape[0], idx.n_docs), np.float32)
    for b in range(toks.shape[0]):
        used = 0
        for t, w in zip(toks[b], wts[b]):
            if t < 0:
                continue
            lo, hi = int(idx.indptr[t]), int(idx.indptr[t + 1])
            hi = min(hi, lo + max(0, p_max - used))
            used += int(idx.indptr[t + 1]) - lo
            for d, sc in zip(idx.doc_ids[lo:hi], idx.scores[lo:hi]):
                out[b, d] = np.float32(out[b, d] + np.float32(sc)
                                       * np.float32(w))
    return out


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("p_max", [7, 1024])
def test_score_batch_position_passes_equal_serial_slots(method, p_max):
    """The per-position passes add each document's postings in the slot
    order of one serial pass, bit for bit: a query row that names a token
    twice, ``-1`` padding between tokens, and a budget that truncates
    (``p_max`` 7) included; and within the reference's tolerance of
    ``repro.core.scoring.score_batch``."""
    corpus, ridx, rdi, idx, di, qs, toks, wts = _both(method, seed=9, b=8)
    toks, wts = toks.copy(), wts.copy()
    toks[0, :4] = [5, -1, 5, 11]          # a duplicate and a hole
    wts[0, :4] = [1.0, 0.0, 2.0, 1.0]
    got, over = score_batch(di, toks, wts, p_max=p_max,
                            return_overflow=True)
    want = _serial_slot_sums(idx, toks, wts, p_max)
    for b, (qt, qw) in enumerate(zip(toks, wts)):
        shift = np.float32(0.0)          # §2.1, in position order
        for t, w in zip(qt, qw):
            if t >= 0:
                shift = np.float32(shift + np.float32(
                    idx.nonoccurrence[t] * np.float32(w)))
        want[b] = want[b] + shift
    want = torch.as_tensor(want)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert bool(over.any()) == (p_max == 7)
    ref, rover = R.score_batch(rdi, toks, wts, p_max=p_max,
                               return_overflow=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_array_equal(over.numpy(), np.asarray(rover))


@pytest.mark.parametrize("method", ["lucene", "tfldp"])
def test_budget_helpers_identical(method):
    _, ridx, _, idx, _, _, toks, _ = _both(method, seed=5)
    for q in (8, 32):
        for quantile in (1.0, 0.9, 0.5):
            assert suggest_p_max(idx, q, quantile=quantile) == \
                R.suggest_p_max(ridx, q, quantile=quantile)
    assert query_posting_budget(idx, toks) == \
        ref_scoring.query_posting_budget(ridx, toks)
    assert batch_posting_budget(idx, toks) == \
        R.batch_posting_budget(ridx, toks)
    empty = np.full((2, 4), -1, np.int32)
    assert batch_posting_budget(idx, empty) == 0 == \
        R.batch_posting_budget(ridx, empty)


def test_scoring_index_from_reference_and_from_host_agree():
    _, ridx, rdi, idx, di, *_ = _both("atire", seed=6)
    reset_transfer_stats()
    mine = DeviceIndex.from_host(idx, device="cpu")
    assert TRANSFERS.posting_uploads == 4
    assert TRANSFERS.posting_bytes == (idx.indptr.size * 8
                                       + idx.doc_ids.nbytes
                                       + idx.scores.nbytes
                                       + idx.nonoccurrence.nbytes)
    for name in ("indptr", "doc_ids", "scores", "nonoccurrence"):
        a, b = getattr(mine, name), getattr(di, name)
        assert a.dtype == b.dtype and torch.equal(a, b)
        np.testing.assert_array_equal(
            b.numpy(), np.asarray(getattr(rdi, name)).astype(b.numpy().dtype))
    assert (di.n_docs, di.doc_offset) == (rdi.n_docs, rdi.doc_offset)
    assert mine.device.type == "cpu"


@pytest.mark.parametrize("method", ["lucene", "bm25+"])
def test_gather_path_exact(method, rng):
    """Mirror of the reference's ``test_jax_gather_path_exact``."""
    corpus = make_corpus(rng)
    p = BM25Params(method=method)
    idx = build_index(corpus, 50, params=p)
    di = DeviceIndex.from_host(idx, device="cpu")
    queries = [rng.integers(0, 50, size=rng.integers(1, 7)).astype(np.int32)
               for _ in range(6)]
    toks, wts = pad_queries(queries, 8)
    out = score_batch(di, toks, wts, p_max=suggest_p_max(idx, 8)).numpy()
    for i, q in enumerate(queries):
        np.testing.assert_allclose(
            out[i], dense_oracle_scores(corpus, 50, q, p), atol=1e-4)


def test_duplicate_query_tokens_weighted(rng):
    """Mirror of the reference's: a token occurring twice contributes
    twice (weights)."""
    corpus = make_corpus(rng)
    idx = build_index(corpus, 50, params=BM25Params())
    di = DeviceIndex.from_host(idx, device="cpu")
    q1 = np.array([3, 3, 7], dtype=np.int32)
    q2 = np.array([3, 7], dtype=np.int32)
    toks, wts = pad_queries([q1, q2], 4)
    out = score_batch(di, toks, wts, p_max=1024).numpy()
    np.testing.assert_allclose(out[0], ScipyBM25(idx).score(q1), atol=1e-4)
    assert not np.allclose(out[0], out[1])


def test_device_index_defaults_to_the_card():
    idx = build_index([np.array([0, 1], np.int32)], 2)
    if torch.cuda.is_available():
        assert DeviceIndex.from_host(idx).device.type == "cuda"
    else:
        from repro_torch.serve.errors import ResidencyError
        with pytest.raises(ResidencyError):
            DeviceIndex.from_host(idx)


@settings(max_examples=30, deadline=None)
@given(seed=st.integers(0, 2 ** 31), k=st.integers(1, 64),
       logn=st.integers(7, 12))
def test_property_blockwise_equals_sort(seed, k, logn):
    """Mirror of the reference's property: two-stage top-k is lossless
    for any (n, block, k)."""
    rng = np.random.default_rng(seed)
    n = 2 ** logn
    block = 2 ** max(3, logn - 3)
    k = min(k, block)
    x = rng.normal(size=n).astype(np.float32)
    idx, vals = blockwise_topk(torch.as_tensor(x), k, block)
    np.testing.assert_array_equal(vals.numpy(), np.sort(x)[::-1][:k])
    np.testing.assert_array_equal(x[idx.numpy()], vals.numpy())
