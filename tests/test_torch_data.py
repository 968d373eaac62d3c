"""The port's data generators equal the JAX package's, array for array.

``repro_torch.data`` holds numpy copies of ``repro.data.corpus``,
``repro.data.clicklogs`` and ``repro.data.lm`` (the port imports nothing
of the reference), so for one seed every document, query, qrel and batch
must be byte-identical, and ``repro_torch.data`` must export what
``repro.data`` exports.
"""

import itertools

import numpy as np
import pytest

pytest.importorskip("jax")          # the reference's data package needs it

import repro.data as ref_data  # noqa: E402
import repro_torch.data as data  # noqa: E402


def _same(a, b):
    assert type(a) is type(b)
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for key in a:
            _same(a[key], b[key])
    else:
        assert a == b


def test_exports_cover_the_reference():
    assert set(ref_data.__all__) <= set(data.__all__)
    for name in ("zipf_queries", "ndcg_at_k"):
        assert callable(getattr(data, name))


@pytest.mark.parametrize("kw", [
    dict(n_docs=60, n_topics=4, vocab_size=120, seed=0),
    dict(n_docs=25, n_topics=3, vocab_size=80, doc_len=(3, 9),
         query_len=(1, 3), seed=7)])
def test_synthetic_corpus_is_byte_identical(kw):
    a, b = data.SyntheticCorpus(**kw), ref_data.SyntheticCorpus(**kw)
    assert a.documents == b.documents
    _same(a.doc_topics, b.doc_topics)
    _same(a.queries_with_qrels(9), b.queries_with_qrels(9))


@pytest.mark.parametrize("n_docs,n_vocab,avg_len,seed,alpha", [
    (50, 300, 20, 0, 1.07), (7, 40, 3, 5, 1.3), (1, 10, 1, 2, 0.9)])
def test_zipf_corpus_and_queries_are_byte_identical(n_docs, n_vocab, avg_len,
                                                    seed, alpha):
    from repro.data.corpus import zipf_queries as ref_queries
    _same(data.zipf_corpus(n_docs, n_vocab, avg_len=avg_len, seed=seed,
                           alpha=alpha),
          ref_data.zipf_corpus(n_docs, n_vocab, avg_len=avg_len, seed=seed,
                               alpha=alpha))
    _same(data.zipf_queries(11, n_vocab, q_len=4, seed=seed, alpha=alpha),
          ref_queries(11, n_vocab, q_len=4, seed=seed, alpha=alpha))


def test_ndcg_at_k_equals_the_reference():
    from repro.data.corpus import ndcg_at_k as ref_ndcg
    rng = np.random.default_rng(3)
    for k in (1, 5, 10, 30):
        ranked = rng.permutation(40)[:20]
        rel = rng.choice(40, size=int(rng.integers(0, 12)), replace=False)
        assert data.ndcg_at_k(ranked, rel, k) == ref_ndcg(ranked, rel, k)


def _batches(gen, n=3):
    return list(itertools.islice(gen, n))


@pytest.mark.parametrize("kw", [
    dict(vocab_sizes=[10, 200, 3], n_dense=4, batch=16, seed=0),
    dict(vocab_sizes=[7], n_dense=0, batch=5, seed=9)])
def test_ctr_batches_are_byte_identical(kw):
    _same(_batches(data.ctr_batches(**kw)),
          _batches(ref_data.ctr_batches(**kw)))


@pytest.mark.parametrize("per_position", [True, False])
def test_seq_rec_batches_are_byte_identical(per_position):
    kw = dict(n_items=300, seq_len=6, batch=8, seed=4,
              per_position=per_position)
    _same(_batches(data.seq_rec_batches(**kw)),
          _batches(ref_data.seq_rec_batches(**kw)))


@pytest.mark.parametrize("kw", [
    dict(vocab_size=50, batch=4, seq_len=12, seed=0),
    dict(vocab_size=1000, batch=2, seq_len=3, seed=8, n_successors=2)])
def test_lm_batches_are_byte_identical(kw):
    _same(_batches(data.lm_batches(**kw)), _batches(ref_data.lm_batches(**kw)))


def test_block_edges_and_padding_stats_equal_the_reference():
    """``block_csr.block_edges`` (a graph's edges blocked by destination)
    and ``BlockedPostings.padding_stats``, the rest of ``block_csr``
    the port copies, equal the reference's byte for byte."""
    from repro.sparse.block_csr import block_edges as ref_block_edges
    from repro_torch.sparse.block_csr import block_edges
    g = data.random_graph(700, 6, d_feat=4, n_classes=3, seed=3)
    src, dst = g.edges[:, 0], g.edges[:, 1]
    w = np.random.default_rng(1).random(src.size).astype(np.float32)
    for weight in (None, w):
        kw = dict(n_nodes=g.n_nodes, block_size=64, tile=32)
        a = block_edges(src, dst, weight, **kw)
        b = ref_block_edges(src, dst, weight, **kw)
        for f in ("token_ids", "local_doc", "scores"):
            _same(getattr(a, f), getattr(b, f))
        assert a.padding_stats() == b.padding_stats()
        assert a.padding_stats()["nnz"] == src.size
