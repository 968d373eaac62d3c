"""The blocked regime's merge through ``ops.topk`` against the full sort it
replaced.

``ops.bm25_retrieve_blocked`` ranks K2's ``[nb, kb, B]`` block winners
with ``ops.topk`` (K5 over segments of 4,096 when there are more than
4,096 candidates a query, its twin on the CPU, then the rank merge) and
gathers the winners' global ids at the positions it returns, in place
of a sort of every candidate by (score desc, doc id asc) with
``rank_order``. The two must agree bit for bit, ids and values: a
candidate's position is ``blk·kb + r`` and K2 ranks equal scores by row
ascending, so among equal scores position order is doc id order. Held
here for the five variants, on both sides of the 4,096 segment, with
repeated documents and columns of ties only, and with a last block part
padding and k up to the corpus size.
"""

import numpy as np
import pytest
import torch

from conftest import make_corpus
from repro_torch.core import BM25Params, build_index
from repro_torch.core.retrieval import rank_order
from repro_torch.core.scoring import pad_queries
from repro_torch.kernels import bm25_block_score as k2
from repro_torch.kernels import ops
from repro_torch.sparse.block_csr import DeviceIndex, pack_query_batch

VARIANTS = ["robertson", "atire", "lucene", "bm25l", "bm25+"]
# name: (n_docs, block_size, k, ties); kb = min(k, block_size, n_docs)
CASES = {
    "one_segment": (500, 16, 10, False),     # nb·kb = 320 <= 4,096
    "segments": (5000, 16, 16, False),       # nb·kb = 5,008 > 4,096
    "ties": (5000, 16, 30, True),            # kb = 16 < k, many equal
    "padding": (100, 64, 100, True),         # last block part padding,
}                                            # k = n_docs


def _sort_merge(token_ids, local_doc, scores, uniq, weights, shift, *,
                block_size, n_docs, k):
    """The merge ``bm25_retrieve_blocked`` had: K2's winners sorted whole
    by (score desc, doc id asc)."""
    kb = min(k, block_size, n_docs)
    vals, loc = k2.bm25_block_score_topk(
        token_ids, local_doc, scores, uniq, weights, block_size=block_size,
        k=kb, n_docs=n_docs)
    nb, _, b = vals.shape
    gids = loc + (torch.arange(nb, dtype=torch.int32)
                  * block_size)[:, None, None]
    flat_v = vals.permute(2, 0, 1).reshape(b, nb * kb)
    flat_i = gids.permute(2, 0, 1).reshape(b, nb * kb)
    sel = rank_order(flat_v, flat_i)[:, :min(k, n_docs, nb * kb)]
    return (torch.gather(flat_i, 1, sel),
            torch.gather(flat_v, 1, sel) + shift[:, None])


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("method", VARIANTS)
def test_blocked_merge_through_topk_equals_full_sort(method, case,
                                                     monkeypatch):
    n_docs, bs, k, ties = CASES[case]
    rng = np.random.default_rng(VARIANTS.index(method) * 10 + len(case))
    corpus = make_corpus(rng, n_docs=n_docs, n_vocab=80, max_len=25)
    if ties:                              # every other document repeated
        corpus[1::2] = corpus[0::2][:len(corpus[1::2])]
    idx = build_index(corpus, 80, params=BM25Params(method=method))
    di = DeviceIndex.build(idx, device="cpu", block_size=bs, tile=16,
                           frag=8, with_bmax=False)
    qs = [rng.integers(0, 80, size=rng.integers(0, 6)).astype(np.int32)
          for _ in range(24)]
    toks, wts, uniq = pad_queries(qs, 8, return_uniq=True)
    tab, w = pack_query_batch(toks, wts, 128, uniq=uniq)
    w = torch.as_tensor(w)
    if ties:
        w[:, ::3] = 0.0                   # columns of ties only
    shift = torch.as_tensor(rng.normal(size=w.shape[1]).astype(np.float32))
    ops_t = (di.blk_tok, di.blk_loc, di.blk_sc, torch.as_tensor(tab), w,
             shift)
    kw = dict(block_size=bs, n_docs=idx.n_docs, k=k)
    assert idx.n_docs % bs != 0 or case != "padding"
    seen = []
    real = ops.blockwise_topk

    def counting(*a, **kw_):
        seen.append(a[0].shape)
        return real(*a, **kw_)

    monkeypatch.setattr(ops, "blockwise_topk", counting)
    ids, vals = ops.bm25_retrieve_blocked(*ops_t, **kw)
    ref_ids, ref_vals = _sort_merge(*ops_t, **kw)
    nb = di.blk_tok.shape[0]
    assert bool(seen) == (nb * min(k, bs, idx.n_docs) > 4096)
    assert ids.dtype == ref_ids.dtype == torch.int32
    assert torch.equal(ids, ref_ids)
    assert torch.equal(vals.view(torch.int32), ref_vals.view(torch.int32))
    if ties:                              # the tie rule was exercised
        assert int((vals[:, 1:] == vals[:, :-1]).sum()) > 0
