"""``repro_torch.kernels.ref``: the plain torch oracles of the kernels.

Each of the six oracles takes the same numpy inputs (made from a seed)
as ``repro.kernels.ref``'s jnp oracle and as the port's twin (the kernel's
CPU path), and gives the same result: sums within atol 1e-5 (the jnp
segment-sum and the twins add in other orders), selections with the same
ids where no two values tie within rounding and tie-aware otherwise.
``repro_torch.kernels`` exports ``ref`` as the reference's package does.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402

from repro_torch import kernels  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.block_segment_sum import (  # noqa: E402
    block_segment_sum_plain)
from repro_torch.kernels.blockwise_topk import (  # noqa: E402
    blockwise_topk_plain)
from repro_torch.kernels.bm25_block_score import (  # noqa: E402
    block_accumulate, bm25_block_score_topk_plain)
from repro_torch.kernels.bm25_gather_score import (  # noqa: E402
    bm25_gather_score_topk_plain)
from repro_torch.kernels.embedding_bag import (  # noqa: E402
    embedding_bag_plain)

ATOL = 1e-5


def _blocked(seed, nb=5, p=48, block=16, n_vocab=30, u=9, b=6):
    """Blocked postings (a quarter of them padding: token -1, row 0, score
    0), a sorted unique-token table and its ``[U, B]`` weights."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, n_vocab, size=(nb, p)).astype(np.int32)
    loc = rng.integers(0, block, size=(nb, p)).astype(np.int32)
    sc = rng.normal(size=(nb, p)).astype(np.float32)
    pad = rng.random((nb, p)) < 0.25
    tok[pad], loc[pad], sc[pad] = -1, 0, 0.0
    uniq = np.sort(rng.choice(n_vocab, size=u, replace=False)).astype(
        np.int32)
    w = rng.integers(0, 3, size=(u, b)).astype(np.float32)
    return tok, loc, sc, uniq, w


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def test_ref_is_exported_like_the_reference():
    assert kernels.ref is ref and "ref" in kernels.__all__
    assert {n for n in dir(jref) if n.endswith("_ref")} == {
        n for n in dir(ref) if n.endswith("_ref")}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_block_score_ref(seed):
    ops = _blocked(seed)
    got = ref.bm25_block_score_ref(*_t(*ops), block_size=16)
    want = np.asarray(jref.bm25_block_score_ref(*_j(*ops), block_size=16))
    assert got.shape == (5, 16, 6) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    twin = block_accumulate(*_t(*ops), block_size=16)
    np.testing.assert_allclose(got.numpy(), twin.numpy(), atol=ATOL)


def _tie_aware(vals, ids, want_vals, want_ids, dense_of):
    """Equal values within ATOL; where an id differs, both carry the same
    value (a tie within rounding)."""
    np.testing.assert_allclose(vals, want_vals, atol=ATOL)
    diff = ids != want_ids
    np.testing.assert_allclose(dense_of(ids)[diff], dense_of(want_ids)[diff],
                               atol=ATOL)


@pytest.mark.parametrize("k,n_docs", [(1, 80), (5, 77), (16, 70)])
def test_block_topk_ref(k, n_docs):
    ops = _blocked(3 + k)
    vals, ids = ref.bm25_block_topk_ref(*_t(*ops), block_size=16, k=k,
                                        n_docs=n_docs)
    jv, ji = jref.bm25_block_topk_ref(*_j(*ops), block_size=16, k=k,
                                      n_docs=n_docs)
    dense = ref.bm25_block_score_ref(*_t(*ops), block_size=16).numpy()
    gdoc = np.arange(5)[:, None] * 16 + np.arange(16)[None, :]
    dense[gdoc >= n_docs] = np.finfo(np.float32).min

    def dense_of(rows):
        return np.take_along_axis(dense, rows.astype(np.int64), axis=1)

    assert ids.dtype == torch.int32 and vals.shape == (5, k, 6)
    _tie_aware(vals.numpy(), ids.numpy(), np.asarray(jv), np.asarray(ji),
               dense_of)
    tv, ti = bm25_block_score_topk_plain(*_t(*ops), block_size=16, k=k,
                                         n_docs=n_docs)
    _tie_aware(vals.numpy(), ids.numpy(), tv.numpy(), ti.numpy(), dense_of)


@pytest.mark.parametrize("k", [1, 4, 16])
def test_gather_topk_ref(k):
    tok, slot, sc, uniq, w = _blocked(10 + k)
    rng = np.random.default_rng(k)
    cand = np.sort(rng.choice(1000, size=(5, 16), replace=False), axis=1
                   ).astype(np.int32)
    cand[:, 12:] = -1                     # padding slots
    slot = np.where(slot >= 12, slot - 4, slot).astype(np.int32)
    ops = (tok, slot, sc, uniq, w, cand)
    vals, ids = ref.bm25_gather_topk_ref(*_t(*ops), acc_block=16, k=k)
    jv, ji = jref.bm25_gather_topk_ref(*_j(*ops), acc_block=16, k=k)
    dense = ref.bm25_block_score_ref(*_t(tok, slot, sc, uniq, w),
                                     block_size=16).numpy()
    dense[cand < 0] = np.finfo(np.float32).min
    slot_of = {(c, int(d)): s for c in range(5)
               for s, d in enumerate(cand[c]) if d >= 0}

    def dense_of(doc_ids):
        out = np.empty(doc_ids.shape, np.float32)
        for c, kk, b in np.ndindex(*doc_ids.shape):
            d = int(doc_ids[c, kk, b])
            out[c, kk, b] = (dense[c, slot_of[c, d], b] if d >= 0
                             else np.finfo(np.float32).min)
        return out

    assert ids.dtype == torch.int32 and vals.shape == (5, k, 6)
    _tie_aware(vals.numpy(), ids.numpy(), np.asarray(jv), np.asarray(ji),
               dense_of)
    tv, ti = bm25_gather_score_topk_plain(*_t(*ops), acc_block=16, k=k)
    _tie_aware(vals.numpy(), ids.numpy(), tv.numpy(), ti.numpy(), dense_of)


@pytest.mark.parametrize("d", [1, 8, 33])
def test_block_segment_sum_ref(d):
    rng = np.random.default_rng(d)
    seg = rng.integers(0, 10, size=(4, 24)).astype(np.int32)
    vals = rng.normal(size=(4, 24, d)).astype(np.float32)
    vals[:, 20:] = 0.0                    # padding rows carry zeros
    got = ref.block_segment_sum_ref(*_t(vals, seg), num_segments=10)
    want = jref.block_segment_sum_ref(*_j(vals, seg), num_segments=10)
    assert got.shape == (4, 10, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    twin = block_segment_sum_plain(*_t(vals, seg), num_segments=10, tile_p=8)
    np.testing.assert_allclose(got.numpy(), twin.numpy(), atol=ATOL)


@pytest.mark.parametrize("f", [1, 5, 12])
def test_embedding_bag_ref(f):
    rng = np.random.default_rng(f)
    table = rng.normal(size=(40, 7)).astype(np.float32)
    idx = rng.integers(-1, 40, size=(9, f)).astype(np.int32)   # -1 pads
    w = rng.random((9, f)).astype(np.float32)
    got = ref.embedding_bag_ref(*_t(table, idx, w))
    want = jref.embedding_bag_ref(*_j(table, idx, w))
    assert got.shape == (9, 7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    twin = embedding_bag_plain(*_t(table, idx, w))
    np.testing.assert_allclose(got.numpy(), twin.numpy(), atol=ATOL)


@pytest.mark.parametrize("k,block", [(1, 8), (3, 8), (8, 8), (5, 32)])
def test_blockwise_topk_ref(k, block):
    rng = np.random.default_rng(k * block)
    x = rng.normal(size=256).astype(np.float32)
    x[10:20] = x[10]                      # ties: position order
    vals, gidx = ref.blockwise_topk_ref(torch.as_tensor(x), k=k, block=block)
    jv, ji = jref.blockwise_topk_ref(jnp.asarray(x), k=k, block=block)
    assert vals.shape == (256 // block, k)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(gidx.numpy(), np.asarray(ji))
    tv, ti = blockwise_topk_plain(torch.as_tensor(x)[None], k=k,
                                  block=block)
    base = (np.arange(256 // block) * block)[:, None]
    np.testing.assert_array_equal(vals.numpy(), tv.numpy())
    np.testing.assert_array_equal(gidx.numpy(), ti.numpy() + base)
