"""The port's kernels K1 and K2: twins against the JAX package's oracles.

On the CPU every kernel wrapper runs its plain torch twin, so these tests
pin the twins — the arithmetic the CUDA kernels must reproduce bit for
bit — against the reference semantics:

* K2 (``bm25_block_score_topk``) against ``repro.kernels.ref.
  bm25_block_topk_ref``: values at rtol 1e-6 / atol 1e-5 (the jnp
  segment-sum adds in another order);
* K1's retrieval path (``ops.bm25_retrieve_resident``) against
  ``repro.core.retrieval._device_gathered_topk`` on the same batch.

Ids may differ from the reference's only inside ties, so each returned id
is held to its own exact score instead: the reference's dense score of
that id equals the reported value, and no id repeats in a list.

The live Pallas kernels are not used: under the installed jax they do not
run (ROADMAP R1). ``test_torch_cuda.py`` holds the CUDA kernels against
these twins bitwise where a GPU is present.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from conftest import make_corpus  # noqa: E402
from repro.core.retrieval import _device_gathered_topk  # noqa: E402
from repro.kernels.ref import (bm25_block_score_ref,  # noqa: E402
                               bm25_block_topk_ref)

from repro_torch.core import (BM25Params, ScipyBM25, build_index,  # noqa: E402
                              rank_order)
from repro_torch.core.retrieval import default_doc_ids  # noqa: E402
from repro_torch.core.scoring import pad_queries  # noqa: E402
from repro_torch.kernels import bm25_block_score as k2  # noqa: E402
from repro_torch.kernels import bm25_gather_score as k1  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.sparse.block_csr import (DeviceIndex, fragment_plan,  # noqa: E402
                                          pack_query_batch,
                                          query_nonoccurrence_shift)

ALL_VARIANTS = ["robertson", "atire", "lucene", "bm25l", "bm25+"]


def _setup(method, seed=0, n_docs=150, n_vocab=60, b=8, block_size=16):
    rng = np.random.default_rng(seed)
    corpus = make_corpus(rng, n_docs=n_docs, n_vocab=n_vocab, max_len=25)
    idx = build_index(corpus, n_vocab, params=BM25Params(method=method))
    di = DeviceIndex.build(idx, device="cpu", block_size=block_size,
                           tile=16, frag=8)
    qs = [rng.integers(0, n_vocab, size=rng.integers(0, 6)
                       ).astype(np.int32) for _ in range(b)]
    toks, wts, uniq = pad_queries(qs, 8, return_uniq=True)
    tab, w = pack_query_batch(toks, wts, 64, uniq=uniq)
    return idx, di, qs, toks, wts, uniq, tab, w


def _ids_carry_their_scores(vals, ids, exact, axis, rtol=1e-6, atol=1e-5):
    """Every returned id's exact score (``exact``, taken at ``ids``) equals
    its reported value, and no id repeats along the rank ``axis``."""
    np.testing.assert_allclose(exact, vals, rtol=rtol, atol=atol)
    assert (np.diff(np.sort(ids, axis=axis), axis=axis) != 0).all()


@pytest.mark.parametrize("method", ALL_VARIANTS)
@pytest.mark.parametrize("k", [1, 7, 16])
def test_k2_twin_matches_reference_oracle(method, k):
    idx, di, *_, tab, w = _setup(method, seed=k)
    vals, rows = k2.bm25_block_score_topk(
        di.blk_tok, di.blk_loc, di.blk_sc, torch.as_tensor(tab),
        torch.as_tensor(w), block_size=16, k=k, n_docs=idx.n_docs)
    rv, ri = bm25_block_topk_ref(
        jnp.asarray(di.blk_tok.numpy()), jnp.asarray(di.blk_loc.numpy()),
        jnp.asarray(di.blk_sc.numpy()), jnp.asarray(tab), jnp.asarray(w),
        block_size=16, k=k, n_docs=idx.n_docs)
    np.testing.assert_allclose(vals.numpy(), np.asarray(rv), rtol=1e-6,
                               atol=1e-5)
    dense = np.array(bm25_block_score_ref(
        jnp.asarray(di.blk_tok.numpy()), jnp.asarray(di.blk_loc.numpy()),
        jnp.asarray(di.blk_sc.numpy()), jnp.asarray(tab), jnp.asarray(w),
        block_size=16))                                  # [nb, 16, B]
    gdoc = np.arange(dense.shape[0])[:, None] * 16 + np.arange(16)[None, :]
    dense[gdoc >= idx.n_docs] = np.finfo(np.float32).min
    rows = rows.numpy()
    _ids_carry_their_scores(vals.numpy(),
                            rows, np.take_along_axis(dense, rows, axis=1),
                            axis=1)


@pytest.mark.parametrize("method", ALL_VARIANTS)
@pytest.mark.parametrize("k", [1, 7, 150])
def test_k1_path_matches_device_gathered_topk(method, k):
    """Same batch through the port's resident path (K1 twin + splice +
    shift) and the reference's all-jnp gathered step."""
    idx, di, qs, toks, wts, uniq, tab, w = _setup(method, seed=k + 1)
    kk = min(k, idx.n_docs)
    rblock = 16 if kk <= 16 else 256
    fp = fragment_plan(idx, uniq, block_size=rblock, frag=8)
    ids, vals = ops.bm25_retrieve_resident(
        torch.as_tensor(fp.desc), torch.as_tensor(w), di.csc_doc_ids,
        di.csc_scores,
        torch.as_tensor(default_doc_ids(fp.vis_blocks, kk, idx.n_docs,
                                        rblock)),
        torch.as_tensor(query_nonoccurrence_shift(idx.nonoccurrence, toks,
                                                  wts)),
        block_size=rblock, frag=8, k=kk, n_docs=idx.n_docs)
    rids, rvals, over = _device_gathered_topk(
        jnp.asarray(idx.indptr.astype(np.int32)), jnp.asarray(idx.doc_ids),
        jnp.asarray(idx.scores), jnp.asarray(idx.nonoccurrence),
        jnp.asarray(toks), jnp.asarray(wts), idx.n_docs,
        p_max=max(idx.nnz, 1), k=kk, n_docs=idx.n_docs)
    assert not bool(over)
    vals, ids = vals.numpy(), ids.numpy()
    np.testing.assert_allclose(vals, np.asarray(rvals), rtol=1e-6,
                               atol=1e-5)
    oracle = ScipyBM25(idx)
    dense = np.stack([oracle.score(q) for q in qs])       # [B, n_docs]
    _ids_carry_their_scores(vals[:len(qs)], ids[:len(qs)],
                            np.take_along_axis(dense, ids[:len(qs)], axis=1),
                            axis=1)


@pytest.mark.parametrize("method", ALL_VARIANTS)
def test_k1_path_past_512_rows_matches_device_gathered_topk(method):
    """K1's twin at a resident block of 1,024 rows (k = 600, as the
    retriever sizes it: ``bucket_pow2(600, floor=512)``) against the
    reference's all-jnp gathered step."""
    idx, di, qs, toks, wts, uniq, tab, w = _setup(method, seed=3,
                                                  n_docs=2500, n_vocab=80)
    rblock, kk = 1024, 600
    fp = fragment_plan(idx, uniq, block_size=rblock, frag=8)
    ids, vals = ops.bm25_retrieve_resident(
        torch.as_tensor(fp.desc), torch.as_tensor(w), di.csc_doc_ids,
        di.csc_scores,
        torch.as_tensor(default_doc_ids(fp.vis_blocks, kk, idx.n_docs,
                                        rblock)),
        torch.as_tensor(query_nonoccurrence_shift(idx.nonoccurrence, toks,
                                                  wts)),
        block_size=rblock, frag=8, k=kk, n_docs=idx.n_docs)
    rids, rvals, over = _device_gathered_topk(
        jnp.asarray(idx.indptr.astype(np.int32)), jnp.asarray(idx.doc_ids),
        jnp.asarray(idx.scores), jnp.asarray(idx.nonoccurrence),
        jnp.asarray(toks), jnp.asarray(wts), idx.n_docs,
        p_max=max(idx.nnz, 1), k=kk, n_docs=idx.n_docs)
    assert not bool(over)
    vals, ids = vals.numpy(), ids.numpy()
    np.testing.assert_allclose(vals, np.asarray(rvals), rtol=1e-6,
                               atol=1e-5)
    oracle = ScipyBM25(idx)
    dense = np.stack([oracle.score(q) for q in qs])
    _ids_carry_their_scores(vals[:len(qs)], ids[:len(qs)],
                            np.take_along_axis(dense, ids[:len(qs)], axis=1),
                            axis=1)


def test_rank_order_is_score_desc_then_id_asc():
    v = torch.tensor([[1.0, 3.0, 3.0, -0.0, 0.0, -2.5,
                       torch.finfo(torch.float32).min]])
    ids = torch.tensor([[4, 9, 2, 7, 1, 0, -1]])
    order = rank_order(v, ids)[0].tolist()
    assert [ids[0, i].item() for i in order] == [2, 9, 4, 1, 7, 0, -1]


def test_cpu_tensors_take_the_twin_and_do_not_count():
    idx, di, *_, tab, w = _setup("lucene")
    n1, n2 = k1.LAUNCHES.n, k2.LAUNCHES.n
    k2.bm25_block_score_topk(di.blk_tok, di.blk_loc, di.blk_sc,
                             torch.as_tensor(tab), torch.as_tensor(w),
                             block_size=16, k=5, n_docs=idx.n_docs)
    fp = fragment_plan(idx, np.arange(5), block_size=16, frag=8)
    k1.bm25_resident_score_topk(torch.as_tensor(fp.desc),
                                torch.as_tensor(w), di.csc_doc_ids,
                                di.csc_scores, block_size=16, frag=8, k=5,
                                n_docs=idx.n_docs)
    assert (k1.LAUNCHES.n, k2.LAUNCHES.n) == (n1, n2)


def test_wrappers_reject_bad_operands():
    idx, di, *_, tab, w = _setup("lucene")
    w_t = torch.as_tensor(w)
    with pytest.raises(TypeError):
        k2.bm25_block_score_topk(di.blk_tok, di.blk_loc, di.blk_sc.double(),
                                 torch.as_tensor(tab), w_t, block_size=16,
                                 k=5, n_docs=idx.n_docs)
    with pytest.raises(ValueError):
        k2.bm25_block_score_topk(di.blk_tok, di.blk_loc, di.blk_sc,
                                 torch.as_tensor(tab), w_t, block_size=16,
                                 k=17, n_docs=idx.n_docs)
    fp = fragment_plan(idx, np.arange(5), block_size=16, frag=8)
    with pytest.raises(ValueError):
        k1.bm25_resident_score_topk(torch.as_tensor(fp.desc[:5]), w_t,
                                    di.csc_doc_ids, di.csc_scores,
                                    block_size=16, frag=8, k=5,
                                    n_docs=idx.n_docs)
    with pytest.raises(TypeError):
        k1.bm25_resident_score_topk(torch.as_tensor(fp.desc).long(), w_t,
                                    di.csc_doc_ids, di.csc_scores,
                                    block_size=16, frag=8, k=5,
                                    n_docs=idx.n_docs)


def test_k1_twin_board_for_empty_plan_is_padding():
    idx, di, *_, w = _setup("lucene")
    fp = fragment_plan(idx, np.zeros(0, np.int64), block_size=16, frag=8)
    v, g = k1.bm25_resident_score_topk(
        torch.as_tensor(fp.desc), torch.as_tensor(w), di.csc_doc_ids,
        di.csc_scores, block_size=16, frag=8, k=4, n_docs=idx.n_docs)
    assert (g == -1).all()
    assert (v == torch.finfo(torch.float32).min).all()
