"""Doc-id reordering in the port (``repro_torch.sparse.reorder``), held
against the JAX package and the scipy oracle on the CPU.

* **sparse** — ``repro_torch.sparse.reorder`` is a numpy copy of
  ``repro.sparse.reorder``: for one index the permutation of both modes,
  the signatures, ``permute_index`` / ``unpermute_index`` and
  ``remap_board`` are byte-identical to the reference's; a reordered
  ``DeviceIndex``'s layouts (permuted host CSC, resident CSC, blocked
  layout, block-max table) equal those of the reference's
  ``DeviceIndex.build(reorder=...)``, which runs no Pallas kernel.
* **serve** — a reordered ``DeviceRetriever`` answers in client ids:
  every regime, both planners and every ladder rung (pruned, resident,
  host, blocked, oracle) exact against ``ScipyBM25`` in all five variants;
  bit for bit the reordered same-layout oracle for pruned; ties (a corpus
  of duplicated documents) come back with equal scores in ascending client
  id order inside each row.
* **bytes** — a reordered retriever ships zero posting and zero
  descriptor bytes per batch under ``plan="device"``, and under
  ``plan="host"`` no more than random order.
* **engine** — reordered shard scorers serve exactly through
  ``RetrievalEngine`` and across a ragged rescale; donor adoption honours
  the permutation.

No test compares against the live Pallas kernels (ROADMAP R1).
"""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

from conftest import make_corpus  # noqa: E402
from repro.core import BM25Params as RefParams  # noqa: E402
from repro.core import build_index as ref_build_index  # noqa: E402
from repro.sparse import reorder as ref_reorder  # noqa: E402
from repro.sparse.block_csr import DeviceIndex as RefDeviceIndex  # noqa: E402

from repro_torch.core import (BM25Params, ScipyBM25, build_index,  # noqa: E402
                              build_sharded_indexes, topk_numpy)
from repro_torch.serve import DeviceRetriever, RetrievalEngine  # noqa: E402
from repro_torch.sparse import reorder  # noqa: E402
from repro_torch.sparse.block_csr import (TRANSFERS, DeviceIndex,  # noqa: E402
                                          reset_transfer_stats)

ALL_VARIANTS = ["robertson", "atire", "lucene", "bm25l", "bm25+"]
SMALL = dict(block_size=16, tile=16, acc_block=16, frag=8, q_max=8,
             device="cpu")


def _clustered_corpus(rng, n_docs=300, n_vocab=60):
    """Half the docs spike on token 0, half on token 1 (the reference's
    clustered corpus): a signature sort separates them into blocks."""
    corpus = []
    for d in range(n_docs):
        base = rng.integers(2, n_vocab, size=10).astype(np.int32)
        tf = 20 if d % 30 == 0 else 3
        corpus.append(np.concatenate([np.full(tf, d % 2, np.int32), base]))
    rng.shuffle(corpus)
    return corpus


def _both(corpus, n_vocab, method="lucene"):
    return (build_index(corpus, n_vocab, params=BM25Params(method=method)),
            ref_build_index(corpus, n_vocab,
                            params=RefParams(method=method)))


def _same_array(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def _check_exact(idx, queries, ids, vals, k, atol=1e-4):
    sc = ScipyBM25(idx)
    for i, q in enumerate(queries):
        oracle = sc.score(q)
        _, ref_v = topk_numpy(oracle[None], k)
        np.testing.assert_allclose(vals[i], ref_v[0], atol=atol)
        np.testing.assert_allclose(oracle[ids[i] - idx.doc_offset], vals[i],
                                   atol=atol)
        assert len(set(ids[i].tolist())) == ids.shape[1]


# -- sparse: byte-identical to the reference ---------------------------------

@pytest.mark.parametrize("mode", ["signature", "minhash"])
@pytest.mark.parametrize("method", ["robertson", "lucene", "bm25+"])
def test_permutation_and_permuted_index_byte_identical(mode, method, rng):
    idx, ref = _both(_clustered_corpus(rng), 60, method)
    perm = reorder.signature_permutation(idx, mode=mode)
    ref_perm = ref_reorder.signature_permutation(ref, mode=mode)
    assert perm is not None and reorder.is_permutation(perm, idx.n_docs)
    _same_array(perm, ref_perm)
    sig = (reorder.doc_signatures if mode == "signature"
           else reorder.minhash_signatures)
    ref_sig = (ref_reorder.doc_signatures if mode == "signature"
               else ref_reorder.minhash_signatures)
    _same_array(sig(idx), ref_sig(ref))
    p, rp = reorder.permute_index(idx, perm), ref_reorder.permute_index(ref,
                                                                       perm)
    for f in ("indptr", "doc_ids", "scores", "nonoccurrence", "doc_lens"):
        _same_array(getattr(p, f), getattr(rp, f))
    back = reorder.unpermute_index(p, perm)
    rback = ref_reorder.unpermute_index(rp, perm)
    for f in ("doc_ids", "scores", "doc_lens"):
        _same_array(getattr(back, f), getattr(rback, f))
        _same_array(getattr(back, f), getattr(idx, f))
    _same_array(reorder.invert_permutation(perm),
                ref_reorder.invert_permutation(perm))
    assert reorder.REORDER_MODES == ref_reorder.REORDER_MODES


def test_remap_board_equals_reference(rng):
    perm = rng.permutation(40).astype(np.int32)
    ids = np.stack([rng.permutation(40)[:9] for _ in range(5)])
    board = np.sort(rng.integers(0, 4, size=(5, 9)).astype(np.float32),
                    axis=1)[:, ::-1]                 # heavy ties
    _same_array(reorder.remap_board(ids, board, perm),
                ref_reorder.remap_board(ids, board, perm))
    assert reorder.remap_board(np.zeros((2, 0), np.int64),
                               np.zeros((2, 0), np.float32), perm).size == 0


@pytest.mark.parametrize("mode", ["signature", "minhash"])
@pytest.mark.parametrize("bmax_dtype", ["f32", "u8"])
def test_reordered_device_index_equals_reference_build(mode, bmax_dtype,
                                                       rng):
    idx, ref = _both(_clustered_corpus(rng, n_docs=200), 60)
    kw = dict(block_size=16, tile=16, frag=8, reorder=mode,
              bmax_dtype=bmax_dtype)
    di = DeviceIndex.build(idx, device="cpu", **kw)
    rd = RefDeviceIndex.build(ref, **kw)
    assert di.reorder == rd.reorder == mode
    _same_array(di.perm, rd.perm)
    for f in ("indptr", "doc_ids", "scores", "doc_lens"):
        _same_array(getattr(di.host, f), getattr(rd.host, f))
    for f in ("csc_doc_ids", "csc_scores", "blk_tok", "blk_loc", "blk_sc"):
        _same_array(getattr(di, f).numpy(), np.asarray(getattr(rd, f)))
    _same_array(di.bmax.host, rd.bmax.host)
    _same_array(di.bmax.scale, rd.bmax.scale)
    assert di.tile_p == rd.tile_p


def test_reuse_requires_matching_permutation(rng):
    idx = build_index(make_corpus(rng, n_docs=40, n_vocab=20), 20,
                      params=BM25Params())
    kw = dict(device="cpu", block_size=16, tile=16, frag=8)
    di_r = DeviceIndex.build(idx, reorder="signature", **kw)
    assert di_r.perm is not None and di_r.reorder == "signature"
    di2 = DeviceIndex.build(idx, reorder="signature", reuse_from=di_r, **kw)
    assert di2.reused == {"csc": True, "blocked": True, "bmax": True}
    np.testing.assert_array_equal(di2.perm, di_r.perm)
    di3 = DeviceIndex.build(idx, reuse_from=di_r, **kw)
    assert di3.reused == {"csc": False, "blocked": False, "bmax": False}
    assert di3.perm is None
    di_n = DeviceIndex.build(idx, **kw)
    di4 = DeviceIndex.build(idx, reorder="signature", reuse_from=di_n, **kw)
    assert di4.reused == {"csc": False, "blocked": False, "bmax": False}


# -- serve: exact in client ids ------------------------------------------------

@pytest.mark.parametrize("method", ALL_VARIANTS)
@pytest.mark.parametrize("regime,plan", [("auto", "host"), ("auto", "device"),
                                         ("gathered", "host"),
                                         ("gathered", "device"),
                                         ("blocked", "host"),
                                         ("pruned", "host"),
                                         ("pruned", "device")])
def test_reordered_regimes_exact(method, regime, plan, rng):
    corpus = _clustered_corpus(rng, n_docs=150, n_vocab=50)
    idx = build_index(corpus, 50, params=BM25Params(method=method))
    dr = DeviceRetriever(idx, regime=regime, plan=plan,
                         reorder="signature", **SMALL)
    assert dr.dindex.perm is not None and dr.index is dr.dindex.host
    queries = [np.array([0], np.int32), np.zeros(0, np.int32)] + [
        rng.integers(0, 50, size=rng.integers(1, 6)).astype(np.int32)
        for _ in range(4)]
    for k in (1, 9, 150):
        ids, vals = dr.retrieve_batch(queries, k)
        _check_exact(idx, queries, ids, vals, k)


@pytest.mark.parametrize("method", ALL_VARIANTS)
def test_reordered_every_rung_serves_exact(method, rng):
    """An auto build entered at pruned, the rungs above tripped one by one:
    every rung — the host gather and the oracle read the permuted host
    copy — serves the batch exactly in client ids."""
    corpus = _clustered_corpus(rng, n_docs=150, n_vocab=50)
    idx = build_index(corpus, 50, params=BM25Params(method=method))
    dr = DeviceRetriever(idx, regime="auto", plan="host",
                         reorder="signature", **SMALL)
    dr.regime = "pruned"
    queries = [rng.integers(0, 50, size=4).astype(np.int32)
               for _ in range(4)] + [np.zeros(0, np.int32)]
    ladder = DeviceRetriever._LADDER
    for n, rung in enumerate(ladder):
        if n:
            dr.trip_breaker(ladder[n - 1], cooldown_s=60.0)
        r = dr.retrieve_batch(queries, 7)
        _check_exact(idx, queries, r.ids, r.scores, 7)
        if n:
            assert r.degradations[-1]["to"] == rung


@pytest.mark.parametrize("bmax_dtype", ["f32", "u8"])
@pytest.mark.parametrize("plan", ["host", "device"])
def test_reordered_pruned_bit_identical_to_same_layout_oracle(bmax_dtype,
                                                              plan, rng):
    idx = build_index(_clustered_corpus(rng), 60, params=BM25Params())
    oracle = DeviceRetriever(idx, regime="gathered", plan=plan,
                             bmax_dtype=bmax_dtype, reorder="signature",
                             **SMALL)
    pruned = DeviceRetriever(idx, regime="pruned", plan=plan,
                             bmax_dtype=bmax_dtype, reorder="signature",
                             **SMALL)
    queries = [np.array([0], np.int32),
               rng.integers(0, 60, size=4).astype(np.int32),
               np.zeros(0, np.int32)]
    for k in (1, 9, 300):
        i0, v0 = oracle.retrieve_batch(queries, k)
        i1, v1 = pruned.retrieve_batch(queries, k)
        np.testing.assert_array_equal(v0.view(np.int32), v1.view(np.int32))
        np.testing.assert_array_equal(i0, i1)


@pytest.mark.parametrize("regime", ["gathered", "blocked", "pruned"])
def test_reordered_ties_come_back_in_client_id_order(regime, rng):
    """A corpus of duplicated documents: every returned row holds the
    oracle's scores, and inside each run of equal scores the client ids
    ascend (``remap_board`` re-sorts the row after the remap)."""
    uniq = make_corpus(rng, n_docs=12, n_vocab=30, max_len=12)
    corpus = [uniq[i % 12] for i in rng.permutation(240)]
    idx = build_index(corpus, 30, params=BM25Params(method="lucene"))
    dr = DeviceRetriever(idx, regime=regime, reorder="minhash", **SMALL)
    plain = DeviceRetriever(idx, regime=regime, **SMALL)
    assert dr.dindex.perm is not None
    queries = [rng.integers(0, 30, size=3).astype(np.int32)
               for _ in range(5)]
    ids, vals = dr.retrieve_batch(queries, 50)
    _check_exact(idx, queries, ids, vals, 50)
    pi, pv = plain.retrieve_batch(queries, 50)
    np.testing.assert_array_equal(vals.view(np.int32), pv.view(np.int32))
    ties = 0
    for row_i, row_v in zip(ids, vals):
        same = row_v[1:] == row_v[:-1]
        ties += int(same.sum())
        assert (row_i[1:][same] > row_i[:-1][same]).all()
    assert ties > 0


def test_reordered_host_arrays_drop_serves_exactly(rng):
    idx = build_index(_clustered_corpus(rng, n_docs=120, n_vocab=40), 40,
                      params=BM25Params())
    keep = DeviceRetriever(idx, regime="pruned", reorder="signature",
                           plan="device", **SMALL)
    drop = DeviceRetriever(idx, regime="pruned", reorder="signature",
                           plan="device", host_arrays="drop", **SMALL)
    assert drop.dindex.host.doc_ids.size == 0
    np.testing.assert_array_equal(drop.index.doc_lens,
                                  keep.dindex.host.doc_lens)
    queries = [rng.integers(0, 40, size=4).astype(np.int32),
               np.array([0], np.int32)]
    i0, v0 = keep.retrieve_batch(queries, 5)
    i1, v1 = drop.retrieve_batch(queries, 5)
    np.testing.assert_array_equal(i0, i1)
    np.testing.assert_array_equal(v0, v1)


# -- bytes ---------------------------------------------------------------------

@pytest.mark.parametrize("plan", ["host", "device"])
def test_reorder_ships_no_more_bytes_than_random_order(plan, rng):
    """Posting bytes equal (zero) and descriptor bytes never larger; under
    ``plan="device"`` both are zero."""
    idx = build_index(_clustered_corpus(rng), 60, params=BM25Params())
    plain = DeviceRetriever(idx, regime="pruned", plan=plan, **SMALL)
    reord = DeviceRetriever(idx, regime="pruned", plan=plan,
                            reorder="signature", **SMALL)
    queries = [rng.integers(0, 60, size=4).astype(np.int32),
               np.array([1], np.int32)]

    def batch_bytes(r):
        r.retrieve_batch(queries, 5)
        reset_transfer_stats()
        r.retrieve_batch(queries, 5)
        return TRANSFERS.posting_bytes, TRANSFERS.descriptor_bytes

    post_p, desc_p = batch_bytes(plain)
    post_r, desc_r = batch_bytes(reord)
    assert post_r == post_p == 0
    assert desc_r <= desc_p
    if plan == "device":
        assert desc_r == desc_p == 0


def test_reorder_raises_skip_rate_on_clustered_corpus(rng):
    idx = build_index(_clustered_corpus(rng, n_docs=600), 60,
                      params=BM25Params())
    plain = DeviceRetriever(idx, regime="pruned", plan="host", **SMALL)
    reord = DeviceRetriever(idx, regime="pruned", plan="host",
                            reorder="signature", **SMALL)

    def skip_rate(r):
        tot_p = tot_d = 0
        for seed in range(8):
            q = [np.array([seed % 2], np.int32),
                 np.random.default_rng(seed).integers(
                     0, 60, size=3).astype(np.int32)]
            r.retrieve_batch(q, 3)
            p = r.last_plan
            tot_p += p.frags_planned
            tot_d += p.frags_planned - p.frags_pruned - p.frags_skipped
        return (tot_p - tot_d) / max(tot_p, 1)

    assert skip_rate(reord) > skip_rate(plain)


# -- engine ----------------------------------------------------------------------

def test_engine_reordered_scorer_exact_and_ragged_rescale(rng):
    corpus = _clustered_corpus(rng, n_docs=130, n_vocab=40)
    p = BM25Params(method="bm25+")
    shards = build_sharded_indexes(corpus, 40, 3, params=p)
    eng = RetrievalEngine(shards, k=5, deadline_s=30.0, scorer="pruned",
                          scorer_opts=dict(reorder="signature", **SMALL))
    full = build_index(corpus, 40, params=p)
    qs = [np.array([0], np.int32),
          rng.integers(0, 40, size=4).astype(np.int32)]

    def check(eng):
        rb = eng.retrieve_batch(qs)
        assert not rb.degraded
        _check_exact(full, qs, rb.ids, rb.scores, 5, atol=1e-3)

    check(eng)
    assert all(rt._scorer.dindex.perm is not None for rt in eng.runtimes)
    eng.rescale(4)
    check(eng)
    eng.rescale(2)
    check(eng)


def test_reordered_dataclass_fields_match_reference():
    """The port's DeviceIndex carries the reference's reorder fields."""
    mine = {f.name for f in dataclasses.fields(DeviceIndex)}
    assert {"perm", "reorder", "snapshot_report"} <= mine


@pytest.mark.parametrize("mode", ["none", "signature"])
def test_convert_carries_a_reordered_reference_index(mode, rng):
    """``convert.device_index_from_reference`` brings a reference
    ``DeviceIndex`` (its permuted host, perm and reorder mode) across: the
    port serves it exact in client ids, bit for bit the port's own
    reordered build."""
    from repro_torch.convert import device_index_from_reference
    corpus = _clustered_corpus(rng, n_docs=150, n_vocab=50)
    idx, ref = _both(corpus, 50, "bm25+")
    rd = RefDeviceIndex.build(ref, reorder=mode, bmax_dtype="u8",
                              block_size=16, tile=16, frag=8)
    di = device_index_from_reference(rd, device="cpu")
    assert di.reorder == mode and (di.perm is None) == (mode == "none")
    for f in ("csc_doc_ids", "csc_scores", "blk_tok", "blk_loc", "blk_sc"):
        _same_array(getattr(di, f).numpy(), np.asarray(getattr(rd, f)))
    _same_array(di.bmax.host, rd.bmax.host)
    carried = DeviceRetriever(None, device_index=di, regime="auto",
                              plan="device", **SMALL)
    own = DeviceRetriever(idx, regime="auto", plan="device", reorder=mode,
                          bmax_dtype="u8", **SMALL)
    queries = [rng.integers(0, 50, size=4).astype(np.int32)
               for _ in range(4)]
    for regime in ("gathered", "blocked", "pruned"):
        a = carried.retrieve_batch(queries, 9, regime=regime)
        b = own.retrieve_batch(queries, 9, regime=regime)
        np.testing.assert_array_equal(a.ids, b.ids)
        np.testing.assert_array_equal(a.scores.view(np.int32),
                                      b.scores.view(np.int32))
        _check_exact(idx, queries, a.ids, a.scores, 9)
