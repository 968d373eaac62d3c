"""The text-in ``BM25Retriever`` of the port against the JAX package's.

The same texts go through ``repro.core.BM25Retriever`` and
``repro_torch.core.BM25Retriever(device="cpu")`` for all six methods.
Scores must agree within atol 1e-5 (the eager sums are taken in the same
slot order; the §2.1 shift is a short reduction grouped by each library).
Ids are compared tie-aware: each of the port's ids carries the reference's
dense score of that document, no id repeats, and equal scores come in
document-id order (the port's tie rule). Also: ``TruncationWarning`` in
both under a too-small ``p_max``, ``k`` above the corpus size, an empty
query, and a corpus whose size is not a multiple of 4,096, whose
``ops.topk`` goes through the K5 wrapper (on the CPU the wrapper runs its
twin, which is not a launch, so the wrapper's calls are counted here; on
the card ``test_torch_cuda.py`` reads the launch counter).
"""

import warnings

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import repro.core as R  # noqa: E402
from repro.serve.errors import TruncationWarning as RefTruncation  # noqa: E402

from repro_torch.core import BM25Retriever, ScipyBM25, rank_order  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.serve.errors import TruncationWarning  # noqa: E402

METHODS = ["robertson", "lucene", "atire", "bm25l", "bm25+", "tfldp"]
ATOL = 1e-5


def _word(i: int) -> str:
    """A made-up word for id ``i`` (letters only, so the tokenizer keeps
    it whole)."""
    s = ""
    i += 26
    while i:
        i, r = divmod(i, 26)
        s = chr(97 + r) + s
    return "x" + s


def _texts(rng, n_docs, n_words=300, avg_len=12):
    p = np.arange(1, n_words + 1, dtype=np.float64) ** -1.1
    p /= p.sum()
    lens = np.maximum(1, rng.poisson(avg_len, size=n_docs))
    ids = rng.choice(n_words, size=int(lens.sum()), p=p)
    words = [_word(int(i)) for i in ids]
    out, at = [], 0
    for n in lens:
        out.append(" ".join(words[at:at + n]))
        at += n
    return out


def _queries(rng, n, n_words=300):
    qs = [" ".join(_word(int(i)) for i in rng.integers(0, n_words,
                                                        rng.integers(1, 5)))
          for _ in range(n)]
    qs[1] = ""                                         # an empty query
    qs[2] = "the of and"                               # stopwords only
    return qs


def _hold(ids, vals, rids, rvals, dense):
    """Port board (ids, vals) against the reference's, tie-aware, with
    ``dense`` the reference's [B, n_docs] scores."""
    ids, vals = ids.numpy().astype(np.int64), vals.numpy()
    np.testing.assert_allclose(vals, np.asarray(rvals), rtol=0, atol=ATOL)
    np.testing.assert_allclose(np.take_along_axis(dense, ids, 1), vals,
                               rtol=0, atol=ATOL)
    assert (np.diff(np.sort(ids, 1), axis=1) != 0).all()
    ties = (np.diff(vals, axis=1) == 0)
    assert (np.diff(ids, axis=1)[ties] > 0).all()      # id order in ties


@pytest.mark.parametrize("method", METHODS)
def test_retriever_matches_reference(method):
    rng = np.random.default_rng(METHODS.index(method))
    corpus, queries = _texts(rng, 300), _queries(rng, 9)
    ref = R.BM25Retriever(method=method).index(corpus)
    mine = BM25Retriever(method=method, device="cpu").index(corpus)
    assert mine.bm25_index.nnz == ref.bm25_index.nnz
    for k in (1, 10):
        rids, rvals = ref.retrieve(queries, k=k)
        ids, vals = mine.retrieve(queries, k=k)
        assert ids.shape == (len(queries), k) and ids.dtype == torch.int32
        toks, wts = R.pad_queries(
            ref.tokenizer.tokenize_queries(queries), 32)
        dense = np.asarray(R.score_batch(
            ref._device_index, toks, wts,
            p_max=R.suggest_p_max(ref.bm25_index, 32)))
        _hold(ids, vals, rids, rvals, dense)


def test_truncation_warning_in_both():
    rng = np.random.default_rng(3)
    corpus, queries = _texts(rng, 200), _queries(rng, 6)
    ref = R.BM25Retriever().index(corpus)
    mine = BM25Retriever(device="cpu").index(corpus)
    with pytest.warns(RefTruncation) as rw:
        ref.retrieve(queries, k=5, p_max=4)
    with pytest.warns(TruncationWarning) as mw:
        mine.retrieve(queries, k=5, p_max=4)
    assert str(mw[0].message) == str(rw[0].message)
    assert issubclass(TruncationWarning, RuntimeWarning)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        mine.retrieve(queries, k=5)                    # the default budget


def test_k_above_corpus_size_and_empty_queries():
    rng = np.random.default_rng(4)
    corpus = _texts(rng, 7)
    ref = R.BM25Retriever(method="bm25+").index(corpus)
    mine = BM25Retriever(method="bm25+", device="cpu").index(corpus)
    queries = ["", _word(0) + " " + _word(3)]
    rids, rvals = ref.retrieve(queries, k=50)
    ids, vals = mine.retrieve(queries, k=50)
    assert ids.shape == (2, 7)
    np.testing.assert_allclose(vals.numpy(), np.asarray(rvals), atol=ATOL)
    # the empty query scores every document alike: ids in order
    np.testing.assert_array_equal(ids[0].numpy(), np.arange(7))
    assert mine.query_counters == {}


def test_ragged_corpus_goes_through_k5(monkeypatch):
    """5,000 documents: not a multiple of ``ops.topk``'s 4,096 block, so
    the reference falls back to ``lax.top_k`` while the port sends the
    ragged rows to K5 (``kernels.blockwise_topk``) — same board."""
    from repro_torch.kernels import blockwise_topk as k5
    calls = []
    real = ops.blockwise_topk

    def spy(x, **kw):
        calls.append((tuple(x.shape), kw))
        return real(x, **kw)

    monkeypatch.setattr(ops, "blockwise_topk", spy)
    rng = np.random.default_rng(5)
    corpus, queries = _texts(rng, 5000, avg_len=6), _queries(rng, 5)
    ref = R.BM25Retriever(method="robertson").index(corpus)
    mine = BM25Retriever(method="robertson", device="cpu").index(corpus)
    rids, rvals = ref.retrieve(queries, k=20)
    ids, vals = mine.retrieve(queries, k=20)
    assert calls == [((5, 5000), dict(k=20, block=4096))]
    assert k5.LAUNCHES.n == 0                          # the twin ran
    toks, wts = R.pad_queries(ref.tokenizer.tokenize_queries(queries), 32)
    dense = np.asarray(R.score_batch(ref._device_index, toks, wts,
                                     p_max=R.suggest_p_max(ref.bm25_index,
                                                           32)))
    _hold(ids, vals, rids, rvals, dense)
    # and exact against the port's own oracle on the same tokens
    oracle = ScipyBM25(mine.bm25_index)
    for i, q in enumerate(mine.tokenizer.tokenize_queries(queries)):
        s = torch.as_tensor(oracle.score(q).astype(np.float32))
        order = rank_order(s, torch.arange(s.numel()))[:20]
        np.testing.assert_allclose(vals[i].numpy(), s[order].numpy(),
                                   atol=1e-4)


def test_failed_k5_launch_surfaces(monkeypatch):
    """A K5 that does not build or launch raises ``RuntimeError`` out of
    ``retrieve``; nothing ranks the scores another way instead."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import blockwise_topk as k5

    def failed_launch(*a, **kw):
        _build.check(719, "blockwise_topk")

    monkeypatch.setattr(k5, "blockwise_topk_plain", failed_launch)
    rng = np.random.default_rng(6)
    r = BM25Retriever(device="cpu").index(_texts(rng, 4200, avg_len=4))
    with pytest.raises(RuntimeError, match="CUDA error 719"):
        r.retrieve(_queries(rng, 3), k=5)


def test_retriever_defaults_to_the_card():
    if torch.cuda.is_available():
        assert BM25Retriever().device.type == "cuda"
    else:
        from repro_torch.serve.errors import ResidencyError
        with pytest.raises(ResidencyError):
            BM25Retriever()


def test_retrieve_before_index_raises():
    with pytest.raises(RuntimeError, match="index"):
        BM25Retriever(device="cpu").retrieve(["a b"])
