"""K6 and the dense full-score path against the JAX package.

On the CPU the K6 wrapper (``kernels.bm25_block_score.bm25_block_score``)
runs its plain torch twin, ``block_accumulate``. These tests hold it, and
``kernels.ops.bm25_score_blocked`` built on it, against the live reference
``repro.kernels.bm25_block_score.bm25_block_score`` and
``repro.kernels.ops.bm25_score_blocked`` (the Pallas kernel in interpret
mode, which runs under the installed jax) on the same blocked postings and
query tables, for all six methods and B in {3, 32, 40} (one B-tile, a
partial one): rtol 1e-6 / atol 1e-5, since the reference sums each tile
with a one-hot matrix product and the twin adds postings one by one.
The dense rows are also held against ``dense_oracle_scores`` (float64
from the raw corpus) at atol 1e-4, as ``tests/test_kernels.py`` does.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro.kernels.bm25_block_score import \
    bm25_block_score as ref_block_score  # noqa: E402

from conftest import make_corpus  # noqa: E402
from repro_torch.core import (BM25Params, build_index,  # noqa: E402
                              dense_oracle_scores)
from repro_torch.core.scoring import pad_queries  # noqa: E402
from repro_torch.kernels import bm25_block_score as k6  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.sparse.block_csr import (DeviceIndex,  # noqa: E402
                                          pack_query_batch,
                                          query_nonoccurrence_shift)

METHODS = ["robertson", "atire", "lucene", "bm25l", "bm25+", "tfldp"]
RTOL, ATOL = 1e-6, 1e-5
BLOCK, TILE, N_VOCAB = 16, 16, 60


def _setup(method, b, seed):
    rng = np.random.default_rng(seed)
    corpus = make_corpus(rng, n_docs=150, n_vocab=N_VOCAB, max_len=25)
    idx = build_index(corpus, N_VOCAB, params=BM25Params(method=method))
    di = DeviceIndex.build(idx, device="cpu", block_size=BLOCK, tile=TILE,
                           frag=8)
    qs = [rng.integers(0, N_VOCAB, size=rng.integers(0, 6)).astype(np.int32)
          for _ in range(b)]
    toks, wts, uniq = pad_queries(qs, 8, return_uniq=True)
    tab, w = pack_query_batch(toks, wts, 64, uniq=uniq)
    shift = query_nonoccurrence_shift(idx.nonoccurrence, toks, wts)
    return corpus, idx, di, qs, tab, w, shift


def _jnp(*ts):
    return [jnp.asarray(t.numpy() if torch.is_tensor(t) else t) for t in ts]


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("b", [3, 32, 40])
def test_k6_twin_matches_reference_kernel(method, b):
    _, idx, di, _, tab, w, _ = _setup(method, b, seed=b)
    ops_t = (di.blk_tok, di.blk_loc, di.blk_sc, torch.as_tensor(tab),
             torch.as_tensor(w))
    got = k6.bm25_block_score(*ops_t, block_size=BLOCK)
    ref = ref_block_score(*_jnp(*ops_t), block_size=BLOCK, tile_p=TILE)
    assert got.shape == (di.blk_tok.shape[0], BLOCK, b)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)
    assert k6.LAUNCHES_DENSE.n == 0       # the twin is not a launch


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("b", [3, 32, 40])
def test_score_blocked_matches_reference_and_oracle(method, b):
    corpus, idx, di, qs, tab, w, shift = _setup(method, b, seed=100 + b)
    ops_t = (di.blk_tok, di.blk_loc, di.blk_sc, torch.as_tensor(tab),
             torch.as_tensor(w), torch.as_tensor(shift))
    got = ops.bm25_score_blocked(*ops_t, block_size=BLOCK,
                                 n_docs=idx.n_docs)
    ref = ref_ops.bm25_score_blocked(*_jnp(*ops_t), block_size=BLOCK,
                                     n_docs=idx.n_docs, tile_p=TILE)
    assert got.shape == (b, idx.n_docs) and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)
    for i, q in enumerate(qs):
        np.testing.assert_allclose(
            got[i].numpy(), dense_oracle_scores(corpus, N_VOCAB, q,
                                                idx.params), atol=1e-4)


def test_k6_padding_rows_are_not_masked():
    """The dense kernel masks nothing: rows past ``n_docs`` hold their
    (zero) sums, as the reference's ``_kernel`` leaves them."""
    _, idx, di, _, tab, w, _ = _setup("robertson", 8, seed=7)
    assert idx.n_docs % BLOCK                   # a partial last block
    got = k6.bm25_block_score(di.blk_tok, di.blk_loc, di.blk_sc,
                              torch.as_tensor(tab), torch.as_tensor(w),
                              block_size=BLOCK)
    pad = got.reshape(-1, got.shape[-1])[idx.n_docs:]
    assert pad.numel() and bool((pad == 0).all())


def test_k6_rejects_bad_operands():
    _, _, di, _, tab, w, _ = _setup("lucene", 4, seed=1)
    args = (di.blk_tok, di.blk_loc, di.blk_sc, torch.as_tensor(tab))
    with pytest.raises(TypeError):
        k6.bm25_block_score(*args, torch.as_tensor(w).double(),
                            block_size=BLOCK)
    with pytest.raises(ValueError):
        k6.bm25_block_score(di.blk_tok, di.blk_loc[:, :-1], di.blk_sc,
                            torch.as_tensor(tab), torch.as_tensor(w),
                            block_size=BLOCK)
    # a meta tensor (the dry run's trace) gets the output's shape, and is
    # checked as any other operand
    out = k6.bm25_block_score(*(t.to("meta") for t in args),
                              torch.as_tensor(w).to("meta"),
                              block_size=BLOCK)
    assert out.shape == (di.blk_tok.shape[0], BLOCK, w.shape[1])
    assert out.device.type == "meta" and out.dtype == torch.float32
    with pytest.raises(TypeError):
        k6.bm25_block_score(*(t.to("meta") for t in args),
                            torch.as_tensor(w).double().to("meta"),
                            block_size=BLOCK)
