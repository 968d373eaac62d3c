"""The port's host layer equals the JAX package's, byte for byte.

Every numpy function ``repro_torch`` copied (index build, blocked and
resident layouts, fragment plans, query packing, planner, sanitizer,
default ids, host merges, tokenizer) is run on the same seeded inputs as
its ``repro`` original, for every variant in ``VARIANTS``, and the outputs
must be identical arrays. The device index's padded tensors must equal the
reference ``DeviceIndex`` arrays element-wise.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

from conftest import make_corpus  # noqa: E402
from repro.core import index as ref_index  # noqa: E402
from repro.core import retrieval as ref_retrieval  # noqa: E402
from repro.core import scoring as ref_scoring  # noqa: E402
from repro.core.tokenizer import Tokenizer as RefTokenizer  # noqa: E402
from repro.core.variants import VARIANTS as REF_VARIANTS  # noqa: E402
from repro.core.variants import BM25Params as RefParams  # noqa: E402
from repro.sparse import block_csr as ref_csr  # noqa: E402

from repro_torch.core import index as port_index  # noqa: E402
from repro_torch.core import retrieval as port_retrieval  # noqa: E402
from repro_torch.core import scoring as port_scoring  # noqa: E402
from repro_torch.core.tokenizer import Tokenizer  # noqa: E402
from repro_torch.core.variants import VARIANTS, BM25Params  # noqa: E402
from repro_torch.sparse import block_csr as port_csr  # noqa: E402

ALL_VARIANTS = sorted(VARIANTS)


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert a.tobytes() == b.tobytes()


def _indexes(method, seed=0, n_docs=120, n_vocab=70):
    rng = np.random.default_rng(seed)
    corpus = make_corpus(rng, n_docs=n_docs, n_vocab=n_vocab, max_len=25)
    ref = ref_index.build_index(corpus, n_vocab,
                                params=RefParams(method=method))
    port = port_index.build_index(corpus, n_vocab,
                                  params=BM25Params(method=method))
    return rng, ref, port


def _queries(rng, n_vocab, n=6):
    return [rng.integers(0, n_vocab, size=rng.integers(0, 7)
                         ).astype(np.int32) for _ in range(n)]


def test_variant_tables_match():
    assert sorted(REF_VARIANTS) == ALL_VARIANTS


@pytest.mark.parametrize("method", ALL_VARIANTS)
def test_build_index_arrays_identical(method):
    _, ref, port = _indexes(method)
    for name in ("indptr", "doc_ids", "scores", "nonoccurrence",
                 "doc_lens"):
        _same(getattr(port, name), getattr(ref, name))
    assert (port.n_docs, port.n_vocab, port.l_avg, port.variant) == \
        (ref.n_docs, ref.n_vocab, ref.l_avg, ref.variant)


@pytest.mark.parametrize("method", ALL_VARIANTS)
def test_blocked_layout_identical(method):
    _, ref, port = _indexes(method)
    a = ref_csr.block_postings_from_index(ref, block_size=16, tile=16)
    b = port_csr.block_postings_from_index(port, block_size=16, tile=16)
    for name in ("token_ids", "local_doc", "scores"):
        _same(getattr(b, name), getattr(a, name))


@pytest.mark.parametrize("method", ALL_VARIANTS)
def test_fragment_plan_identical(method):
    rng, ref, port = _indexes(method)
    for _ in range(3):
        qs = _queries(rng, 70)
        uniq = np.unique(np.concatenate(qs))
        for block_size, frag in ((16, 8), (32, 4)):
            a = ref_csr.fragment_plan(ref, uniq, block_size=block_size,
                                      frag=frag)
            b = port_csr.fragment_plan(port, uniq, block_size=block_size,
                                       frag=frag)
            _same(b.desc, a.desc)
            _same(b.vis_blocks, a.vis_blocks)
            assert (b.n_frags, b.sum_df) == (a.n_frags, a.sum_df)
            _same(port_retrieval.default_doc_ids(b.vis_blocks, 7,
                                                 port.n_docs, block_size),
                  ref_retrieval.default_doc_ids(a.vis_blocks, 7,
                                                ref.n_docs, block_size))


@pytest.mark.parametrize("method", ALL_VARIANTS)
def test_query_packing_identical(method):
    rng, ref, port = _indexes(method)
    qs = _queries(rng, 70, n=9) + [np.array([3, 3, 3, 5], np.int32)]
    for q_max in (4, 8):
        a = ref_scoring.pad_queries(qs, q_max, return_uniq=True)
        b = port_scoring.pad_queries(qs, q_max, return_uniq=True)
        for x, y in zip(b, a):
            _same(x, y)
    toks, wts, uniq = port_scoring.pad_queries(qs, 8, return_uniq=True)
    for x, y in zip(port_csr.pack_query_batch(toks, wts, 64, uniq=uniq),
                    ref_csr.pack_query_batch(toks, wts, 64, uniq=uniq)):
        _same(x, y)
    _same(port_csr.query_nonoccurrence_shift(port.nonoccurrence, toks, wts),
          ref_csr.query_nonoccurrence_shift(ref.nonoccurrence, toks, wts))


@pytest.mark.parametrize("method", ["robertson", "bm25l"])
def test_device_index_tensors_equal_reference_arrays(method):
    _, ref, port = _indexes(method)
    a = ref_csr.DeviceIndex.build(ref, block_size=16, tile=16, frag=8)
    b = port_csr.DeviceIndex.build(port, device="cpu", block_size=16,
                                   tile=16, frag=8)
    for name in ("csc_doc_ids", "csc_scores", "csc_indptr", "blk_tok",
                 "blk_loc", "blk_sc"):
        _same(getattr(b, name).numpy(), np.asarray(getattr(a, name)))
    assert (b.nnz, b.n_docs, b.tile_p) == (a.nnz, a.n_docs, a.tile_p)


def test_planner_decisions_identical():
    for sum_df, nnz in ((0, 100), (10, 100), (50, 100), (51, 100),
                        (400, 100)):
        for regime in ("auto", "blocked", "gathered"):
            for crossover in (None, 0.5, 4.0):
                a = ref_retrieval.plan_retrieval(sum_df, nnz, regime=regime,
                                                 crossover=crossover)
                b = port_retrieval.plan_retrieval(sum_df, nnz, regime=regime,
                                                  crossover=crossover)
                assert (b.regime, b.forced, b.crossover, b.work_ratio) == \
                    (a.regime, a.forced, a.crossover, a.work_ratio)


def test_sanitizer_and_host_merges_identical():
    batch = [np.array([1, 2, 99]), None, np.array([[3, 4]]),
             np.array([1.0, 2.5, np.nan]), np.array([-1, 5]),
             np.array(["a"]), np.array([True])]
    ca, cb = {}, {}
    a = ref_retrieval.validate_query_batch(batch, 50, counters=ca)
    b = port_retrieval.validate_query_batch(batch, 50, counters=cb)
    assert ca == cb
    for x, y in zip(b, a):
        _same(x, y)
    rng = np.random.default_rng(3)
    s = rng.normal(size=(4, 40)).astype(np.float32)
    for x, y in zip(port_retrieval.topk_numpy(s, 7),
                    ref_retrieval.topk_numpy(s, 7)):
        _same(x, y)
    parts = [(rng.integers(0, 100, (4, 5)), rng.normal(size=(4, 5))
              .astype(np.float32)) for _ in range(3)]
    for x, y in zip(port_retrieval.merge_topk_batch(parts, 6),
                    ref_retrieval.merge_topk_batch(parts, 6)):
        _same(x, y)
    flat = [(i[0], v[0]) for i, v in parts]
    for x, y in zip(port_retrieval.merge_topk(flat, 6),
                    ref_retrieval.merge_topk(flat, 6)):
        _same(x, y)


def test_tokenizer_identical():
    texts = ["The quick brown foxes were jumping over lazy dogs",
             "Lexical search: sparse scoring, eager indexing!",
             "jumping foxes and searching dogs"]
    a, b = RefTokenizer(), Tokenizer()
    for x, y in zip(b.tokenize_corpus(texts), a.tokenize_corpus(texts)):
        _same(x, y)
    for x, y in zip(b.tokenize_queries(["lazy fox search"]),
                    a.tokenize_queries(["lazy fox search"])):
        _same(x, y)
    assert b.vocab_size == a.vocab_size


@pytest.mark.parametrize("method", ["lucene", "bm25+"])
def test_index_from_reference_round_trips(method):
    """A ``repro`` index (or its DeviceIndex) carried across serves the
    same state: equal arrays, metadata and boards."""
    from repro_torch.convert import index_from_reference
    from repro_torch.serve import DeviceRetriever
    rng, ref, port = _indexes(method)
    for src in (ref, ref_csr.DeviceIndex.build(ref, block_size=16, tile=16,
                                               frag=8, with_bmax=False)):
        got = index_from_reference(src)
        for name in ("indptr", "doc_ids", "scores", "nonoccurrence",
                     "doc_lens"):
            _same(getattr(got, name), getattr(port, name))
        assert got.params == port.params
        assert (got.n_docs, got.n_vocab, got.l_avg, got.variant,
                got.doc_offset) == (port.n_docs, port.n_vocab, port.l_avg,
                                    port.variant, port.doc_offset)
    qs = _queries(rng, 70)
    kw = dict(block_size=16, tile=16, frag=8, q_max=8, device="cpu")
    a = DeviceRetriever(got, **kw).retrieve_batch(qs, 7)
    b = DeviceRetriever(port, **kw).retrieve_batch(qs, 7)
    _same(a.ids, b.ids)
    _same(a.scores, b.scores)
    dropped = ref_csr.DeviceIndex.build(ref, block_size=16, with_bmax=False)
    dropped.host = None
    with pytest.raises(ValueError):
        index_from_reference(dropped)


@pytest.mark.parametrize("method", ALL_VARIANTS)
def test_scipy_oracle_identical(method):
    """The port's ScipyBM25 adopts the CSC arrays directly (no COO
    re-sort); its scores equal the reference oracle's bit for bit."""
    from repro.core.reference import ScipyBM25 as RefScipy
    from repro_torch.core.reference import ScipyBM25
    rng, ref, port = _indexes(method)
    a, b = RefScipy(ref), ScipyBM25(port)
    for q in _queries(rng, 70) + [np.array([4, 4, 9], np.int32)]:
        _same(b.score(q), a.score(q))
        for x, y in zip(b.retrieve(q, 5), a.retrieve(q, 5)):
            _same(x, y)
