"""The port's sharded engine on ``device="cpu"``: hedged, exact, elastic.

The engine tests of ``tests/test_serving.py``, ported to ``repro_torch``
(shards are ``DeviceRetriever``s whose kernels run their plain twins):

* a batch over four shards is exact against the oracle (atol 1e-4 on the
  scores, every id carrying its oracle score), one query equals its row
  of the batch, and the scipy scorer agrees;
* a straggler shard is hedged away under a quorum (the response is
  ``degraded`` and fast) and the answered shards' winners keep their exact
  scores;
* ``rescale`` preserves results, reuses unchanged runtimes with zero new
  posting uploads (``last_build_stats``), adopts a donor's resident
  layouts when a boundary moves through posting-less documents, and
  serves exactly with empty shards;
* the engine defaults to ``scorer="auto"`` (the card; a deliberate
  divergence from the reference's ``"scipy"``), and snapshots raise
  ``RetrievalConfigError`` until their slice.
"""

import numpy as np
import pytest

from conftest import make_corpus
from repro_torch.core import (BM25Params, build_index, build_sharded_indexes,
                              dense_oracle_scores, topk_numpy)
from repro_torch.serve import (RetrievalConfigError, RetrievalEngine,
                               ShardRuntime)
from repro_torch.sparse.block_csr import TRANSFERS, reset_transfer_stats

SMALL = dict(block_size=16, tile=16, acc_block=16, frag=8, q_max=8,
             device="cpu")
ATOL = 1e-4

pytestmark = pytest.mark.no_chaos      # asserts transfer counters


def _zipf(rng, n, n_vocab, size):
    p = np.arange(1, n_vocab + 1, dtype=np.float64) ** -1.07
    p /= p.sum()
    return [rng.choice(n_vocab, size=size(), p=p).astype(np.int32)
            for _ in range(n)]


@pytest.fixture(scope="module")
def corpus_and_shards():
    rng = np.random.default_rng(0)
    corpus = _zipf(rng, 300, 200, lambda: max(1, rng.poisson(30)))
    shards = build_sharded_indexes(corpus, 200, 4, params=BM25Params())
    return corpus, shards


def _queries(seed, n=5):
    rng = np.random.default_rng(seed)
    return _zipf(rng, n, 200, lambda: 5)


def _check(corpus, qs, ids, scores, k):
    for i, q in enumerate(qs):
        oracle = dense_oracle_scores(corpus, 200, q, BM25Params())
        _, ref_v = topk_numpy(oracle[None], k)
        np.testing.assert_allclose(scores[i], ref_v[0], atol=ATOL)
        np.testing.assert_allclose(oracle[ids[i]], scores[i], atol=ATOL)


@pytest.mark.parametrize("scorer", ["auto", "gathered", "pruned", "scipy"])
def test_engine_exact_vs_oracle(corpus_and_shards, scorer):
    corpus, shards = corpus_and_shards
    opts = {} if scorer == "scipy" else SMALL
    eng = RetrievalEngine(shards, k=10, deadline_s=30.0, quorum=1.0,
                          scorer=scorer, scorer_opts=opts)
    qs = _queries(1) + [np.zeros(0, np.int32)]
    r = eng.retrieve_batch(qs)
    assert not r.degraded and r.shards_answered == 4
    assert r.ids.shape == r.scores.shape == (len(qs), 10)
    _check(corpus, qs, r.ids, r.scores, 10)
    for i, q in enumerate(qs):                 # one query == its row
        one = eng.retrieve(q)
        np.testing.assert_allclose(one.scores, r.scores[i], atol=1e-6)
        assert one.ids.shape == (10,)
    assert eng.health()["served"] == 1 + len(qs)


def test_engine_defaults_to_the_card_and_snapshots_wait(corpus_and_shards,
                                                        monkeypatch,
                                                        tmp_path):
    """The engine defaults to the card; its snapshots (once a later slice,
    now ported) round-trip on the CPU, and a wrong count of adopted
    device indexes is a typed error."""
    import torch
    _, shards = corpus_and_shards
    assert ShardRuntime(shards[0], scorer_opts=SMALL).scorer == "auto"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from repro_torch.serve import ResidencyError
    with pytest.raises(ResidencyError, match="device='cpu'"):
        RetrievalEngine(shards, k=5)           # auto → cuda, none here
    eng = RetrievalEngine(shards, k=5, scorer_opts=SMALL)
    assert eng.save(tmp_path / "eng")["n_shards"] == len(shards)
    back = RetrievalEngine.load(tmp_path / "eng", scorer_opts=SMALL)
    qs = _queries(4, n=3)
    a, b = eng.retrieve_batch(qs), back.retrieve_batch(qs)
    np.testing.assert_array_equal(a.ids, b.ids)
    np.testing.assert_array_equal(a.scores, b.scores)
    with pytest.raises(RetrievalConfigError, match="device_indexes has"):
        RetrievalEngine(shards, scorer_opts=SMALL, device_indexes=[None] * 3)
    with pytest.raises(RetrievalConfigError, match="unknown scorer"):
        RetrievalEngine(shards, scorer="bm42", scorer_opts=SMALL)


def test_straggler_hedging_meets_deadline(corpus_and_shards):
    _, shards = corpus_and_shards
    eng = RetrievalEngine(
        shards, k=5, deadline_s=0.2, quorum=0.5, scorer_opts=SMALL,
        delay=lambda i: (lambda: 2.0) if i == 0 else None)
    q = _queries(2, n=1)[0]
    r = eng.retrieve(q)
    assert r.degraded and r.shards_answered >= 2
    assert r.latency_s < 1.0                   # did not wait 2 s straggler
    assert eng.health()["degraded"] == 1


def test_hedged_results_are_subset_exact(corpus_and_shards):
    """Answered shards' winners keep exact scores (superset property)."""
    corpus, shards = corpus_and_shards
    eng = RetrievalEngine(
        shards, k=5, deadline_s=0.2, quorum=0.5, scorer_opts=SMALL,
        delay=lambda i: (lambda: 2.0) if i == 0 else None)
    qs = _queries(3, n=3)
    r = eng.retrieve_batch(qs)
    assert r.degraded
    for i, q in enumerate(qs):
        oracle = dense_oracle_scores(corpus, 200, q, BM25Params())
        np.testing.assert_allclose(oracle[r.ids[i]], r.scores[i], atol=ATOL)
        assert (r.ids[i] >= shards[1].doc_offset).all()   # shard 0 missed


def test_elastic_rescale_preserves_results(corpus_and_shards):
    corpus, shards = corpus_and_shards
    eng = RetrievalEngine(shards, k=8, deadline_s=30.0, quorum=1.0,
                          scorer_opts=SMALL)
    qs = _queries(7, n=3)
    before = eng.retrieve_batch(qs)
    assert eng.last_build_stats == {"reused": 0, "built": 4,
                                    "blockmax_reused": 0}
    reset_transfer_stats()
    eng.rescale(4)                             # boundaries unchanged
    assert eng.last_build_stats == {"reused": 4, "built": 0,
                                    "blockmax_reused": 0}
    assert TRANSFERS.posting_uploads == 0      # nothing re-uploaded
    for n in (2, 6):                           # the pool shrank, then grew
        eng.rescale(n)
        assert eng.last_build_stats["built"] > 0 and len(eng.runtimes) == n
        after = eng.retrieve_batch(qs)
        np.testing.assert_allclose(after.scores, before.scores, atol=1e-5)
        _check(corpus, qs, after.ids, after.scores, 8)
    assert eng.health()["build"] == eng.last_build_stats


def test_rescale_reuses_layouts_through_empty_doc_boundary():
    """A boundary moving through posting-less documents keeps the postings
    byte-identical: the rebuilt runtime adopts its donor's resident layouts
    and block-max table with zero posting uploads."""
    rng = np.random.default_rng(4)
    corpus = [rng.integers(0, 12, size=5).astype(np.int32)
              for _ in range(12)]
    corpus[4] = np.zeros(0, np.int32)
    corpus[5] = np.zeros(0, np.int32)
    shards = build_sharded_indexes(corpus, 12, 2, params=BM25Params())
    eng = RetrievalEngine(shards, k=3, deadline_s=30.0, quorum=1.0,
                          scorer_opts=SMALL)
    reset_transfer_stats()
    eng.rescale(3)                 # shard 0 keeps docs 0-3: same postings
    assert eng.last_build_stats["blockmax_reused"] >= 1
    reused = eng.runtimes[0]._scorer.dindex.reused
    assert reused["bmax"] and reused["csc"] and reused["blocked"]
    assert eng.runtimes[0]._scorer.device.type == "cpu"
    qs = [rng.integers(0, 12, size=3).astype(np.int32) for _ in range(3)]
    r = eng.retrieve_batch(qs)
    for i, q in enumerate(qs):
        oracle = dense_oracle_scores(corpus, 12, q, BM25Params())
        _, ref_v = topk_numpy(oracle[None], 3)
        np.testing.assert_allclose(r.scores[i], ref_v[0], atol=ATOL)
        np.testing.assert_allclose(oracle[r.ids[i]], r.scores[i], atol=ATOL)


def test_rescale_to_more_shards_than_documents_serves_exact():
    """Rescaling past the document count leaves empty shards, which answer
    with empty boards; the merge stays exact."""
    rng = np.random.default_rng(5)
    corpus = make_corpus(rng, n_docs=6, n_vocab=10, max_len=6)
    idx = build_index(corpus, 10, params=BM25Params(method="bm25+"))
    eng = RetrievalEngine([idx], k=4, deadline_s=30.0, quorum=1.0,
                          scorer_opts=SMALL)
    eng.rescale(9)
    assert sum(rt._scorer.n_docs == 0 for rt in eng.runtimes) >= 1
    qs = [np.array([1, 2], np.int32), np.zeros(0, np.int32)]
    r = eng.retrieve_batch(qs)
    assert r.ids.shape == (2, 4) and not r.degraded
    p = BM25Params(method="bm25+")
    for i, q in enumerate(qs):
        oracle = dense_oracle_scores(corpus, 10, q, p)
        _, ref_v = topk_numpy(oracle[None], 4)
        np.testing.assert_allclose(r.scores[i], ref_v[0], atol=ATOL)
        np.testing.assert_allclose(oracle[r.ids[i]], r.scores[i], atol=ATOL)
