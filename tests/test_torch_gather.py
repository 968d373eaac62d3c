"""The host-gather rung: the gather layout and K4's twin against the JAX
package.

On the CPU the K4 wrapper runs its plain torch twin, so these tests pin the
arithmetic the CUDA kernel must reproduce bit for bit:

* ``sparse.block_csr.gather_posting_runs`` (uncached, through a
  ``PostingRunCache``, descriptor-only and the empty gather) is
  byte-identical to ``repro.sparse.block_csr.gather_posting_runs`` for
  every variant, and the run caches count the same hits and misses;
* K4's twin (``bm25_gather_score_topk``) equals
  ``repro.kernels.ref.bm25_gather_topk_ref`` at rtol 1e-6 / atol 1e-5
  (the jnp segment-sum adds in another order); ids may differ from the
  reference's only inside ties, so each returned id is held to its own
  exact score (the reference's dense score of that slot);
* the two-level fold equals the merge of the per-chunk boards bit for bit;
* ``ops.bm25_retrieve_gathered`` is exact against ``ScipyBM25`` (atol
  1e-4, ids carrying their oracle scores), for k in {1, 7, ≥ n_docs},
  empty queries and robertson's negative IDF, through the two-level fold,
  the chunked path and the ``kb < k`` fall-back;
* ``missing_doc_ids`` equals the reference's, and ``DeviceIndex.build
  (reuse_from=)`` adopts a donor's tensors only when it may.

The live Pallas kernel is not used: under the installed jax it does not
run (ROADMAP R1).
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from conftest import make_corpus  # noqa: E402
from repro.core.retrieval import missing_doc_ids as ref_missing  # noqa: E402
from repro.kernels.ref import (bm25_block_score_ref,  # noqa: E402
                               bm25_gather_topk_ref)
from repro.sparse import block_csr as ref_csr  # noqa: E402

from repro_torch.core import (BM25Params, ScipyBM25, build_index,  # noqa: E402
                              missing_doc_ids, rank_order, topk_numpy)
from repro_torch.core.scoring import pad_queries  # noqa: E402
from repro_torch.kernels import bm25_gather_score as k4  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.sparse import block_csr as csr  # noqa: E402

ALL_VARIANTS = ["robertson", "atire", "lucene", "bm25l", "bm25+", "tfldp"]
RTOL, ATOL = 1e-6, 1e-5          # twin vs the jnp oracle (sum order)
EXACT_ATOL = 1e-4                # boards vs ScipyBM25


def _index(method, seed=0, n_docs=150, n_vocab=60):
    rng = np.random.default_rng(seed)
    corpus = make_corpus(rng, n_docs=n_docs, n_vocab=n_vocab, max_len=25)
    return rng, build_index(corpus, n_vocab,
                            params=BM25Params(method=method))


def _batch(rng, n_vocab, b=8, u_max=64):
    qs = [rng.integers(0, n_vocab, size=rng.integers(0, 6)
                       ).astype(np.int32) for _ in range(b)]
    toks, wts, uniq = pad_queries(qs, 8, return_uniq=True)
    tab, w = csr.pack_query_batch(toks, wts, u_max, uniq=uniq)
    return qs, toks, wts, uniq, tab, w


def _gp_equal(a, b):
    for f in ("token_ids", "slot_ids", "scores", "candidates"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        assert x.tobytes() == y.tobytes(), f
    assert (a.acc_block, a.n_candidates, a.sum_df) == \
        (b.acc_block, b.n_candidates, b.sum_df)


@pytest.mark.parametrize("method", ALL_VARIANTS)
@pytest.mark.parametrize("acc_block,tile,p_bucket", [(16, 16, None),
                                                     (32, 8, 64),
                                                     (512, 512, None)])
def test_gather_posting_runs_byte_identical(method, acc_block, tile,
                                            p_bucket):
    rng, idx = _index(method)
    for _ in range(3):
        uniq = np.unique(rng.integers(0, 60, size=rng.integers(1, 12)))
        kw = dict(acc_block=acc_block, tile=tile, p_bucket=p_bucket)
        _gp_equal(csr.gather_posting_runs(idx, uniq, **kw),
                  ref_csr.gather_posting_runs(idx, uniq, **kw))
        cache, ref_cache = csr.PostingRunCache(4), ref_csr.PostingRunCache(4)
        for _ in range(2):               # second pass hits the cache
            _gp_equal(csr.gather_posting_runs(idx, uniq, cache=cache, **kw),
                      ref_csr.gather_posting_runs(idx, uniq,
                                                  cache=ref_cache, **kw))
        assert (cache.hits, cache.misses, len(cache)) == \
            (ref_cache.hits, ref_cache.misses, len(ref_cache))
        d = csr.gather_posting_runs(idx, uniq, descriptors_only=True)
        rd = ref_csr.gather_posting_runs(idx, uniq, descriptors_only=True)
        assert d.starts.tobytes() == rd.starts.tobytes()
        assert d.lens.tobytes() == rd.lens.tobytes()
        assert d.sum_df == rd.sum_df


def test_empty_gather_and_cache_lru():
    _, idx = _index("lucene")
    empty = np.zeros(0, np.int64)
    _gp_equal(csr.gather_posting_runs(idx, empty, acc_block=16, tile=16),
              ref_csr.gather_posting_runs(idx, empty, acc_block=16, tile=16))
    gp = csr.gather_posting_runs(idx, empty, acc_block=16, tile=16)
    assert gp.token_ids.shape == (1, 16) and (gp.candidates == -1).all()
    cache = csr.PostingRunCache(2)
    for t in (1, 2, 3):
        cache.put(t, np.zeros(1, np.int64), np.zeros(1, np.float32))
    assert len(cache) == 2 and cache.get(1) is None and cache.get(3)
    assert (cache.hits, cache.misses) == (1, 1)
    csr.PostingRunCache(0).put(1, np.zeros(1), np.zeros(1))


def _k4_operands(method, acc_block=16, tile=16, seed=0, b=8):
    rng, idx = _index(method, seed=seed)
    qs, toks, wts, uniq, tab, w = _batch(rng, 60, b=b)
    gp = csr.gather_posting_runs(idx, uniq, acc_block=acc_block, tile=tile)
    ops_ = tuple(torch.as_tensor(a) for a in (
        gp.token_ids, gp.slot_ids, gp.scores, tab, w, gp.candidates))
    return idx, qs, toks, wts, gp, ops_


@pytest.mark.parametrize("method", ALL_VARIANTS)
@pytest.mark.parametrize("k", [1, 5, 16])
def test_k4_twin_matches_reference_oracle(method, k):
    _, _, _, _, gp, ops_ = _k4_operands(method)
    vals, ids = k4.bm25_gather_score_topk(*ops_, acc_block=16, k=k)
    rv, _ri = bm25_gather_topk_ref(*(jnp.asarray(t.numpy()) for t in ops_),
                                   acc_block=16, k=k)
    np.testing.assert_allclose(vals.numpy(), np.asarray(rv), rtol=RTOL,
                               atol=ATOL)
    # ids tie-aware: each id carries the reference's dense score of its
    # slot, and no id repeats within a (chunk, column) list
    dense = np.asarray(bm25_block_score_ref(
        *(jnp.asarray(t.numpy()) for t in ops_[:5]), block_size=16))
    cand = gp.candidates
    v, g = vals.numpy(), ids.numpy()
    for c in range(cand.shape[0]):
        real = g[c] >= 0
        slot = np.searchsorted(cand[c][cand[c] >= 0], g[c][real])
        cols = np.nonzero(real)[1]
        np.testing.assert_allclose(dense[c][slot, cols], v[c][real],
                                   rtol=RTOL, atol=ATOL)
        assert (v[c][~real] == np.finfo(np.float32).min).all()
        for col in range(g.shape[2]):
            live = g[c, :, col][g[c, :, col] >= 0]
            assert len(set(live.tolist())) == live.size


@pytest.mark.parametrize("method", ["robertson", "lucene", "bm25l"])
@pytest.mark.parametrize("k", [1, 7, 16])
def test_k4_two_level_equals_chunk_merge_bitwise(method, k):
    _, _, _, _, _, ops_ = _k4_operands(method, acc_block=16, b=16)
    cv, ci = k4.bm25_gather_score_topk(*ops_, acc_block=16, k=k)
    fv, fi = k4.bm25_gather_score_topk(*ops_, acc_block=16, k=k,
                                       two_level=True)
    nc, _, b = cv.shape
    flat_v = cv.permute(2, 0, 1).reshape(b, nc * k)
    flat_i = ci.permute(2, 0, 1).reshape(b, nc * k)
    sel = rank_order(flat_v, flat_i)[:, :k]
    assert torch.equal(torch.gather(flat_v, 1, sel).T.view(torch.int32),
                       fv.view(torch.int32))
    assert torch.equal(torch.gather(flat_i, 1, sel).T, fi)
    assert fv.shape == fi.shape == (k, b)


def test_k4_wrapper_checks_operands_and_counts_no_twin_launch():
    _, _, _, _, _, ops_ = _k4_operands("lucene")
    n0 = k4.LAUNCHES_GATHER.n
    k4.bm25_gather_score_topk(*ops_, acc_block=16, k=4)
    assert k4.LAUNCHES_GATHER.n == n0          # the CPU twin is no launch
    with pytest.raises(ValueError, match="acc_block"):
        k4.bm25_gather_score_topk(*ops_, acc_block=16, k=17)
    bad = list(ops_)
    bad[5] = bad[5][:, :8]
    with pytest.raises(ValueError, match="candidates"):
        k4.bm25_gather_score_topk(*bad, acc_block=16, k=4)
    bad = list(ops_)
    bad[2] = bad[2].double()
    with pytest.raises(TypeError, match="scores"):
        k4.bm25_gather_score_topk(*bad, acc_block=16, k=4)
    assert k4.gather_fold_fits(4096) and not k4.gather_fold_fits(1 << 16)


def _check_exact(idx, queries, ids, vals, k):
    sc = ScipyBM25(idx)
    for i, q in enumerate(queries):
        oracle = sc.score(q)
        _, ref_v = topk_numpy(oracle[None], k)
        np.testing.assert_allclose(vals[i], ref_v[0], atol=EXACT_ATOL)
        np.testing.assert_allclose(oracle[ids[i]], vals[i], atol=EXACT_ATOL)
        assert len(set(ids[i].tolist())) == ids.shape[1]


@pytest.mark.parametrize("method", ALL_VARIANTS)
@pytest.mark.parametrize("two_level", [True, False])
def test_retrieve_gathered_exact_against_scipy(method, two_level):
    rng, idx = _index(method, n_docs=90)
    qs = [rng.integers(0, 60, size=rng.integers(1, 6)).astype(np.int32)
          for _ in range(4)] + [np.zeros(0, np.int32)]
    toks, wts, uniq = pad_queries(qs, 8, return_uniq=True)
    tab, w = csr.pack_query_batch(toks, wts, 64, uniq=uniq)
    shift = csr.query_nonoccurrence_shift(idx.nonoccurrence, toks, wts)
    for k in (1, 7, 90, 200):
        # acc_block grows with k as the retriever grows it; 16 < k = 90
        # also runs the kb < k fall-back to the chunked path
        for acc_block in sorted({16, max(16, 1 << (min(k, 90) - 1)
                                         .bit_length())}):
            gp = csr.gather_posting_runs(idx, uniq, acc_block=acc_block,
                                         tile=16)
            t = [torch.as_tensor(a) for a in (
                gp.token_ids, gp.slot_ids, gp.scores, tab, w,
                gp.candidates, shift)]
            ids, vals = ops.bm25_retrieve_gathered(
                *t, acc_block=acc_block, k=k, n_docs=90,
                two_level=two_level)
            assert ids.shape == vals.shape == (len(qs), min(k, 90))
            _check_exact(idx, qs, ids.numpy(), vals.numpy(), k)


def test_robertson_defaults_win_through_the_host_gather():
    rng = np.random.default_rng(7)
    corpus = [rng.integers(0, 6, size=rng.integers(3, 10)).astype(np.int32)
              for _ in range(40)]
    idx = build_index(corpus, 6, params=BM25Params(method="robertson"))
    q = np.array([0, 1], np.int32)
    toks, wts, uniq = pad_queries([q], 8, return_uniq=True)
    tab, w = csr.pack_query_batch(toks, wts, 8, uniq=uniq)
    shift = csr.query_nonoccurrence_shift(idx.nonoccurrence, toks, wts)
    gp = csr.gather_posting_runs(idx, uniq, acc_block=16, tile=16)
    ids, vals = ops.bm25_retrieve_gathered(
        *(torch.as_tensor(a) for a in (gp.token_ids, gp.slot_ids, gp.scores,
                                       tab, w, gp.candidates, shift)),
        acc_block=16, k=10, n_docs=40)
    _check_exact(idx, [q], ids.numpy(), vals.numpy(), 10)
    assert (vals[0] == 0.0).any()                 # defaults actually won
    assert (ScipyBM25(idx).score(q) < 0).any()


@pytest.mark.parametrize("n_cand", [0, 5, 37, 64])
def test_missing_doc_ids_equal_reference(n_cand):
    rng = np.random.default_rng(n_cand)
    cand = np.full(64, -1, np.int32)
    cand[:n_cand] = np.sort(rng.choice(80, size=n_cand, replace=False))
    for k in (1, 10, 30):
        got = missing_doc_ids(torch.as_tensor(cand), k, 80)
        ref = np.asarray(ref_missing(jnp.asarray(cand), k, 80))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), ref)


def test_device_index_reuse_from_adopts_only_identical_postings():
    rng = np.random.default_rng(3)
    corpus = make_corpus(rng, n_docs=60, n_vocab=30)
    idx = build_index(corpus, 30, params=BM25Params())
    kw = dict(device="cpu", block_size=16, tile=16, frag=8)
    donor = csr.DeviceIndex.build(idx, **kw)
    assert donor.reused == {"csc": False, "blocked": False, "bmax": False}
    csr.reset_transfer_stats()
    same = csr.DeviceIndex.build(idx, reuse_from=donor, **kw)
    assert same.reused == {"csc": True, "blocked": True, "bmax": True}
    assert same.csc_doc_ids is donor.csc_doc_ids
    assert same.blk_tok is donor.blk_tok and same.bmax is donor.bmax
    assert csr.TRANSFERS.posting_bytes == 0
    # other geometry, or other postings: nothing adopted
    assert not any(csr.DeviceIndex.build(
        idx, reuse_from=donor, **{**kw, "block_size": 32}).reused.values())
    other = build_index(corpus[:-1], 30, params=BM25Params())
    assert not any(csr.DeviceIndex.build(
        other, reuse_from=donor, **kw).reused.values())
    assert csr.DeviceIndex._postings_identical(idx, idx)
    assert not csr.DeviceIndex._postings_identical(idx, None)


@pytest.mark.parametrize("method", ALL_VARIANTS)
@pytest.mark.parametrize("run_cache", [0, 256])
def test_host_rung_retriever_exact(method, run_cache):
    """``DeviceRetriever(gather="host")`` enters at the host rung: exact
    for k in {1, 7, ≥ n_docs} (the chunk height grows with k), empty
    queries and tokens with no postings, with and without the run
    cache."""
    from repro_torch.serve import DeviceRetriever
    rng = np.random.default_rng(11)
    corpus = make_corpus(rng, n_docs=90, n_vocab=60, max_len=20)
    idx = build_index(corpus, 64, params=BM25Params(method=method))
    dr = DeviceRetriever(idx, regime="gathered", gather="host",
                         run_cache=run_cache, block_size=16, tile=16,
                         acc_block=16, q_max=8, device="cpu")
    assert (dr.run_cache is None) == (run_cache == 0)
    qs = [rng.integers(0, 64, size=rng.integers(1, 6)).astype(np.int32)
          for _ in range(4)] + [np.zeros(0, np.int32),
                                np.array([61, 63], np.int32)]
    csr.reset_transfer_stats()
    for k in (1, 7, 90, 200):
        r = dr.retrieve_batch(qs, k)
        assert r.degradations == [] and r.plan.regime == "gathered"
        assert r.ids.shape == (len(qs), min(k, 90))
        _check_exact(idx, qs, r.ids, r.scores, k)
    assert csr.TRANSFERS.posting_uploads == 4 * 4    # one gather a batch
