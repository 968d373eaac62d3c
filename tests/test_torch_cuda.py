"""The CUDA kernels against their plain torch twins, on the card.

Every test here carries the ``cuda`` marker and skips without an NVIDIA
GPU (a CUDA kernel has no CPU mode). On a machine with one, run

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The kernels run on CUDA copies of the inputs, the twins on the CPU
tensors, and results must agree bit for bit: the kernels add in the same
fixed order as the CPU twins' ``index_add_`` and round each product and
sum separately. K3 is held in the columns whose bounds are finite (in
padding columns the kernel decides per column group of 64, the twin
over the whole batch), also at the edges of its persistent schedule;
the device planner on the card must equal the host plan byte for byte,
and the pruned retriever on the card the CPU path. K4 is held
bitwise to its twin in both modes (per-chunk boards and the two-level
fold), and the ladder walked on the card with faults armed and breakers
tripped serves every rung exactly, bit for bit the CPU path's boards. The
file imports neither jax nor ``repro``, so it runs on a machine that has
only the port's dependencies.
"""

import numpy as np
import pytest
import torch

from conftest import make_corpus
from repro_torch.core import BM25Params, ScipyBM25, build_index, topk_numpy
from repro_torch.core.scoring import pad_queries
from repro_torch.kernels import bm25_block_score as k2
from repro_torch.kernels import bm25_gather_score as k1
from repro_torch.core.retrieval import default_doc_ids
from repro_torch.serve import DeviceRetriever, RetrievalEngine
from repro_torch.serve.faults import inject_faults
from repro_torch.sparse.block_csr import (TRANSFERS, DeviceIndex,
                                          block_upper_bounds, fragment_plan,
                                          gather_posting_runs,
                                          pack_query_batch,
                                          reset_transfer_stats)
from repro_torch.sparse.fragment_device import plan_fragments_device

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _bits(a):
    a = a.cpu()
    return a.view(torch.int32) if a.dtype == torch.float32 else a


@pytest.mark.parametrize("method", ["robertson", "lucene", "bm25l"])
@pytest.mark.parametrize("k", [1, 7, 16])
def test_kernels_bitwise_equal_twins(cuda_device, method, k):
    rng = np.random.default_rng(k)
    corpus = make_corpus(rng, n_docs=1000, n_vocab=60, max_len=25)
    idx = build_index(corpus, 60, params=BM25Params(method=method))
    di = DeviceIndex.build(idx, device="cpu", block_size=16, tile=16,
                           frag=8)
    qs = [rng.integers(0, 60, size=rng.integers(0, 6)).astype(np.int32)
          for _ in range(16)]
    toks, wts, uniq = pad_queries(qs, 8, return_uniq=True)
    tab, w = pack_query_batch(toks, wts, 64, uniq=uniq)
    fp = fragment_plan(idx, uniq, block_size=16, frag=8)
    w_t = torch.as_tensor(w)
    cases = ((k1.bm25_resident_score_topk,
              (torch.as_tensor(fp.desc), w_t, di.csc_doc_ids, di.csc_scores),
              dict(frag=8)),
             (k2.bm25_block_score_topk,
              (di.blk_tok, di.blk_loc, di.blk_sc, torch.as_tensor(tab), w_t),
              {}))
    for fn, ops, extra in cases:
        kw = dict(block_size=16, k=k, n_docs=idx.n_docs, **extra)
        n0 = (k1.LAUNCHES.n, k2.LAUNCHES.n)
        ref = fn(*ops, **kw)
        got = fn(*(t.to(cuda_device) for t in ops), **kw)
        assert (k1.LAUNCHES.n + k2.LAUNCHES.n) == sum(n0) + 1
        for a, b in zip(got, ref):
            assert torch.equal(_bits(a), _bits(b))


def test_retriever_on_cuda_equals_cpu_twin_path(cuda_device):
    rng = np.random.default_rng(5)
    corpus = make_corpus(rng, n_docs=700, n_vocab=80, max_len=30)
    idx = build_index(corpus, 80, params=BM25Params(method="robertson"))
    queries = [rng.integers(0, 80, size=5).astype(np.int32)
               for _ in range(9)]
    for regime in ("gathered", "blocked"):
        on_gpu = DeviceRetriever(idx, regime=regime, block_size=64,
                                 device=cuda_device).retrieve_batch(queries,
                                                                    7)
        on_cpu = DeviceRetriever(idx, regime=regime, block_size=64,
                                 device="cpu").retrieve_batch(queries, 7)
        np.testing.assert_array_equal(on_gpu.ids, on_cpu.ids)
        np.testing.assert_array_equal(on_gpu.scores, on_cpu.scores)


@pytest.mark.parametrize("method", ["robertson", "lucene", "bm25l"])
@pytest.mark.parametrize("k", [1, 7, 16])
def test_k3_bitwise_equal_twin_and_k1(cuda_device, method, k):
    """K3 on the card equals its CPU twin, and K1 on the card, in every
    column whose bounds are finite."""
    rng = np.random.default_rng(100 + k)
    corpus = make_corpus(rng, n_docs=1000, n_vocab=60, max_len=25)
    idx = build_index(corpus, 60, params=BM25Params(method=method))
    di = DeviceIndex.build(idx, device="cpu", block_size=16, tile=16,
                           frag=8, with_blocked=False)
    qs = [rng.integers(0, 60, size=rng.integers(0, 6)).astype(np.int32)
          for _ in range(40)]
    toks, wts, uniq = pad_queries(qs, 8, return_uniq=True)
    tab, w = pack_query_batch(toks, wts, 64, uniq=uniq)
    w = np.concatenate([w, np.zeros((64, 8), np.float32)], axis=1)
    fp = fragment_plan(idx, uniq, block_size=16, frag=8)
    ub = block_upper_bounds(di.bmax, tab, w)
    ub[:, 40:] = -np.inf                             # eight padding columns
    ops = (torch.as_tensor(fp.desc), torch.as_tensor(w),
           torch.as_tensor(ub), di.csc_doc_ids, di.csc_scores)
    kw = dict(block_size=16, frag=8, k=k, n_docs=idx.n_docs)
    ref = k1.bm25_resident_score_topk_pruned(*ops, **kw)
    n0 = k1.LAUNCHES_PRUNED.n
    got = k1.bm25_resident_score_topk_pruned(
        *(t.to(cuda_device) for t in ops), **kw)
    torch.cuda.synchronize()
    assert k1.LAUNCHES_PRUNED.n == n0 + 1
    plain = k1.bm25_resident_score_topk(
        *(t.to(cuda_device) for t in ops[:2] + ops[3:]), **kw)
    for a in (ref, plain):
        assert torch.equal(_bits(got[0])[:, :40], _bits(a[0])[:, :40])
        assert torch.equal(_bits(got[1])[:, :40], _bits(a[1])[:, :40])


def _late_saturating_index(rng, bs=16):
    """Loose decoy blocks 0-1, the tight winner in block 2, and twenty
    victim blocks the board beats once block 2 has folded (blocks of
    ``bs`` documents)."""
    def filler():
        return rng.integers(5, 40, size=8).astype(np.int32)

    docs = [filler() for _ in range(23 * bs)]

    def setdoc(i, tf0=0, tf1=0):
        docs[i] = np.concatenate([np.zeros(tf0, np.int32),
                                  np.ones(tf1, np.int32), filler()])

    for b in (0, 1):
        setdoc(b * bs, tf0=25)
        setdoc(b * bs + 1, tf1=25)
    setdoc(2 * bs, tf0=15, tf1=15)
    for b in range(3, 23):
        setdoc(b * bs, tf0=4)
        setdoc(b * bs + 1, tf1=4)
    return build_index(docs, 40, params=BM25Params())


def test_k3_one_cta_per_tile_counts_as_twin(cuda_device, monkeypatch):
    """With one CTA per column group (one group of 64 here) K3 walks the
    table in order, as the twin does: the same board and the same skip
    count, above half the table."""
    idx = _late_saturating_index(np.random.default_rng(0))
    di = DeviceIndex.build(idx, device="cpu", block_size=16, tile=16,
                           frag=8, with_blocked=False)
    toks, wts, uniq = pad_queries([np.array([0, 1], np.int32)], 8,
                                  return_uniq=True)
    tab, w = pack_query_batch(toks, wts, 8, uniq=uniq)
    fp = fragment_plan(idx, uniq, block_size=16, frag=8)
    ub = block_upper_bounds(di.bmax, tab, w)
    ops = (torch.as_tensor(fp.desc), torch.as_tensor(w),
           torch.as_tensor(ub), di.csc_doc_ids, di.csc_scores)
    kw = dict(block_size=16, frag=8, k=1, n_docs=idx.n_docs)
    ref = k1.bm25_resident_score_topk_pruned(*ops, **kw)
    monkeypatch.setattr(k1, "_CTAS", 1)
    got = k1.bm25_resident_score_topk_pruned(
        *(t.to(cuda_device) for t in ops), **kw)
    assert torch.equal(_bits(got[0]), _bits(ref[0]))
    assert torch.equal(_bits(got[1]), _bits(ref[1]))
    assert int(got[2]) == int(ref[2]) > fp.n_frags // 2


# K1/K3's schedule edges: (block size, frag, docs, vocab, max doc
# length, queries, tokens a query, table rows, padding columns, k, CTAs)
_RESIDENT_EDGES = {
    # spans of ~10,000 postings (several 2,048-posting rounds); 3,000
    # docs leave the last block of 512 partly padding
    "long-spans": (512, 512, 3000, 40, 60, 64, 5, 64, 0, 100, None),
    "k-512": (512, 512, 1200, 50, 40, 8, 5, 64, 0, 512, None),
    "k-1-b-1": (512, 512, 2500, 40, 60, 1, 5, 64, 0, 1, None),
    "b-8": (16, 8, 1000, 60, 25, 8, 5, 64, 0, 7, None),
    "b-48-pad-8": (16, 8, 1000, 60, 25, 40, 5, 64, 8, 7, None),
    "b-100": (16, 8, 900, 70, 25, 100, 5, 128, 0, 9, None),
    # 4,096 weight rows (past K6's 2,048-row pieces) and 4 column groups
    "b-256-wide-table": (16, 8, 4001, 6000, 30, 256, 12, 4096, 0, 10,
                         None),
    # one posting a fragment: spans of ~8,000 fragments, several windows
    # of 2,048, and rounds cut at 128 runs
    "frag-1-windows": (512, 1, 3000, 30, 80, 16, 4, 32, 0, 50, None),
    # a range a fragment: range boundaries fall inside long spans
    "ranges-through-spans": (512, 512, 3000, 40, 60, 64, 5, 64, 0, 100,
                             4096),
    "one-cta": (512, 512, 3000, 40, 60, 64, 5, 64, 0, 100, 1),
}


@pytest.mark.parametrize("edge", sorted(_RESIDENT_EDGES))
def test_k1_k3_bitwise_at_schedule_edges(cuda_device, monkeypatch, edge):
    """K1 on the card equals its CPU twin bit for bit in every column,
    and K3 equals K1 in every column whose bounds are finite, at the
    edges of the persistent schedule: rounds, windows, column groups,
    wide weight tables, k up to the block size, a partly padded last
    block and ranges that would cut through spans."""
    (bs, frag, n_docs, n_vocab, max_len, n_q, q_len, u_max, pad_cols, k,
     ctas) = _RESIDENT_EDGES[edge]
    rng = np.random.default_rng(len(edge))
    corpus = make_corpus(rng, n_docs=n_docs, n_vocab=n_vocab,
                         max_len=max_len)
    idx = build_index(corpus, n_vocab, params=BM25Params(method="bm25l"))
    assert idx.n_docs % bs != 0                      # a partly padded block
    di = DeviceIndex.build(idx, device="cpu", block_size=bs, tile=bs,
                           frag=frag, with_blocked=False)
    qs = [rng.integers(0, n_vocab, size=rng.integers(1, q_len + 1)
                       ).astype(np.int32) for _ in range(n_q)]
    toks, wts, uniq = pad_queries(qs, max(8, q_len), return_uniq=True)
    tab, w = pack_query_batch(toks, wts, u_max, uniq=uniq)
    w = np.concatenate([w, np.zeros((u_max, pad_cols), np.float32)], 1)
    fp = fragment_plan(idx, uniq, block_size=bs, frag=frag)
    ub = block_upper_bounds(di.bmax, tab, w)
    live = w.shape[1] - pad_cols
    ub[:, live:] = -np.inf
    ops = (torch.as_tensor(fp.desc), torch.as_tensor(w), di.csc_doc_ids,
           di.csc_scores)
    kw = dict(block_size=bs, frag=frag, k=k, n_docs=idx.n_docs)
    if ctas is not None:
        monkeypatch.setattr(k1, "_CTAS", ctas)
    ref = k1.bm25_resident_score_topk(*ops, **kw)
    got = k1.bm25_resident_score_topk(*(t.to(cuda_device) for t in ops),
                                      **kw)
    assert torch.equal(_bits(got[0]), _bits(ref[0]))
    assert torch.equal(_bits(got[1]), _bits(ref[1]))
    ops3 = ops[:2] + (torch.as_tensor(ub),) + ops[2:]
    got3 = k1.bm25_resident_score_topk_pruned(
        *(t.to(cuda_device) for t in ops3), **kw)
    assert torch.equal(_bits(got3[0])[:, :live], _bits(ref[0])[:, :live])
    assert torch.equal(_bits(got3[1])[:, :live], _bits(ref[1])[:, :live])
    if ctas == 1 and w.shape[1] <= 64:      # in order, as the twin
        ref3 = k1.bm25_resident_score_topk_pruned(*ops3, **kw)
        assert int(got3[2]) == int(ref3[2])


def test_k1_k3_all_padding_table(cuda_device):
    """A table of padding only (no span) gives the empty board: the float
    minimum and id -1 everywhere, and K3 skips nothing."""
    desc = torch.zeros((6, 64), dtype=torch.int32)
    w = torch.rand(64, 70)
    doc = torch.zeros((1, 64), dtype=torch.int32)
    sc = torch.zeros((1, 64))
    kw = dict(block_size=16, frag=8, k=5, n_docs=100)
    ref = k1.bm25_resident_score_topk(desc, w, doc, sc, **kw)
    assert bool((ref[1] == -1).all())
    got = k1.bm25_resident_score_topk(
        *(t.to(cuda_device) for t in (desc, w, doc, sc)), **kw)
    got3 = k1.bm25_resident_score_topk_pruned(
        *(t.to(cuda_device) for t in (desc, w, torch.zeros(4, 70), doc,
                                      sc)), **kw)
    for g in (got, got3):
        assert torch.equal(_bits(g[0]), _bits(ref[0]))
        assert torch.equal(_bits(g[1]), _bits(ref[1]))
    assert int(got3[2]) == 0


# Blocks past 512 rows: K1/K3 take them in windows of 512 rows, each
# fragment cut to the window by two searches, every window folded into
# the running board (k past 512 lives only in the device-memory board)
_PAST_512 = [(1024, 1), (1024, 100), (1024, 600), (1024, 1024),
             (2048, 1), (2048, 100), (2048, 600), (2048, 1024)]


@pytest.mark.parametrize("block_size,k", _PAST_512)
def test_k1_k3_bitwise_past_512_rows(cuda_device, monkeypatch, block_size,
                                     k):
    """K1 on the card equals its CPU twin bit for bit at blocks of 1,024
    and 2,048 rows, k up to the block, with robertson's negative scores,
    a partly padded last block and eight padding columns; K3 equals K1 in
    the live columns, and with one CTA it skips what its twin skips."""
    rng = np.random.default_rng(block_size + k)
    n_docs = 3 * block_size + 333                    # a partly padded block
    corpus = make_corpus(rng, n_docs=n_docs, n_vocab=40, max_len=40)
    # token 0 in nine docs of ten: its robertson IDF is negative, so the
    # query [0] ranks the docs without it (0.0) above all the others
    corpus = [np.concatenate([[0], d[d != 0]]).astype(np.int32)
              if rng.random() < 0.9 else d for d in corpus]
    idx = build_index(corpus, 40, params=BM25Params(method="robertson"))
    di = DeviceIndex.build(idx, device="cpu", block_size=block_size,
                           tile=block_size, frag=64, with_blocked=False)
    qs = [rng.integers(0, 40, size=rng.integers(1, 6)).astype(np.int32)
          for _ in range(44)] + [np.array([0], np.int32)] * 4
    toks, wts, uniq = pad_queries(qs, 8, return_uniq=True)
    tab, w = pack_query_batch(toks, wts, 64, uniq=uniq)
    w = np.concatenate([w, np.zeros((64, 8), np.float32)], axis=1)
    fp = fragment_plan(idx, uniq, block_size=block_size, frag=64)
    ub = block_upper_bounds(di.bmax, tab, w)
    ub[:, 48:] = -np.inf
    ops = (torch.as_tensor(fp.desc), torch.as_tensor(w), di.csc_doc_ids,
           di.csc_scores)
    ops3 = ops[:2] + (torch.as_tensor(ub),) + ops[2:]
    kw = dict(block_size=block_size, frag=64, k=k, n_docs=idx.n_docs)
    ref = k1.bm25_resident_score_topk(*ops, **kw)
    # past the zeros, negative scores rank, above the padding rows
    assert bool((ref[0][:, 44:48] < 0).any()) == (k >= 600)
    n0 = (k1.LAUNCHES.n, k1.LAUNCHES_PRUNED.n)
    got = k1.bm25_resident_score_topk(*(t.to(cuda_device) for t in ops),
                                      **kw)
    got3 = k1.bm25_resident_score_topk_pruned(
        *(t.to(cuda_device) for t in ops3), **kw)
    assert (k1.LAUNCHES.n, k1.LAUNCHES_PRUNED.n) == (n0[0] + 1, n0[1] + 1)
    assert torch.equal(_bits(got[0]), _bits(ref[0]))
    assert torch.equal(_bits(got[1]), _bits(ref[1]))
    assert torch.equal(_bits(got3[0])[:, :48], _bits(ref[0])[:, :48])
    assert torch.equal(_bits(got3[1])[:, :48], _bits(ref[1])[:, :48])
    monkeypatch.setattr(k1, "_CTAS", 1)
    one = k1.bm25_resident_score_topk_pruned(
        *(t.to(cuda_device) for t in ops3), **kw)
    ref3 = k1.bm25_resident_score_topk_pruned(*ops3, **kw)
    assert torch.equal(_bits(one[0])[:, :48], _bits(ref3[0])[:, :48])
    assert int(one[2]) == int(ref3[2])


def test_k3_skips_past_512_rows_as_twin(cuda_device, monkeypatch):
    """The late-saturating index at blocks of 1,024 rows: with one CTA, K3
    skips above half the table, the same count as its twin, and its board
    is the twin's."""
    idx = _late_saturating_index(np.random.default_rng(0), bs=1024)
    di = DeviceIndex.build(idx, device="cpu", block_size=1024, tile=1024,
                           frag=8, with_blocked=False)
    toks, wts, uniq = pad_queries([np.array([0, 1], np.int32)], 8,
                                  return_uniq=True)
    tab, w = pack_query_batch(toks, wts, 8, uniq=uniq)
    fp = fragment_plan(idx, uniq, block_size=1024, frag=8)
    ub = block_upper_bounds(di.bmax, tab, w)
    ops = (torch.as_tensor(fp.desc), torch.as_tensor(w),
           torch.as_tensor(ub), di.csc_doc_ids, di.csc_scores)
    kw = dict(block_size=1024, frag=8, k=1, n_docs=idx.n_docs)
    ref = k1.bm25_resident_score_topk_pruned(*ops, **kw)
    monkeypatch.setattr(k1, "_CTAS", 1)
    got = k1.bm25_resident_score_topk_pruned(
        *(t.to(cuda_device) for t in ops), **kw)
    assert torch.equal(_bits(got[0]), _bits(ref[0]))
    assert torch.equal(_bits(got[1]), _bits(ref[1]))
    assert int(got[2]) == int(ref[2]) > fp.n_frags // 2


_ALL_VARIANTS = ["robertson", "atire", "lucene", "bm25l", "bm25+"]


@pytest.mark.parametrize("method", _ALL_VARIANTS)
@pytest.mark.parametrize("block_size,k", [(512, 600), (1024, 100)])
def test_retriever_past_512_rows_exact(cuda_device, method, block_size, k):
    """DeviceRetriever on the card under gathered, auto and pruned at
    k = 600 (a resident block of 1,024 rows) and at block_size 1,024: every
    board exact against ScipyBM25 (tie-aware) and bitwise the CPU path's."""
    rng = np.random.default_rng(block_size + k)
    corpus = make_corpus(rng, n_docs=2900, n_vocab=120, max_len=30)
    idx = build_index(corpus, 120, params=BM25Params(method=method))
    oracle = ScipyBM25(idx)
    queries = [rng.integers(0, 120, size=rng.integers(1, 6)
                            ).astype(np.int32) for _ in range(12)]
    n0 = k1.LAUNCHES.n
    for regime in ("gathered", "auto", "pruned"):
        dr = DeviceRetriever(idx, regime=regime, block_size=block_size,
                             device=cuda_device)
        cpu = DeviceRetriever(idx, regime=regime, block_size=block_size,
                              plan="device", device="cpu")
        r = dr.retrieve_batch(queries, k)
        c = cpu.retrieve_batch(queries, k)
        np.testing.assert_array_equal(r.ids, c.ids)
        np.testing.assert_array_equal(r.scores.view(np.int32),
                                      c.scores.view(np.int32))
        for i, q in enumerate(queries):
            o = oracle.score(q)
            _, ref_v = topk_numpy(o[None], k)
            np.testing.assert_allclose(r.scores[i], ref_v[0], atol=1e-4)
            np.testing.assert_allclose(o[r.ids[i]], r.scores[i], atol=1e-4)
            assert len(set(r.ids[i].tolist())) == r.ids.shape[1]
    assert k1.LAUNCHES.n > n0


def test_cold_start_on_the_card(cuda_device, tmp_path):
    """Save a retriever on the card, load the snapshot memmapped onto the
    card and adopt it: one posting upload per layout, boards bitwise the
    saving retriever's under every regime, and a second batch ships zero
    posting and zero descriptor bytes."""
    rng = np.random.default_rng(21)
    corpus = make_corpus(rng, n_docs=3000, n_vocab=90, max_len=30)
    idx = build_index(corpus, 90, params=BM25Params(method="bm25l"))
    warm = DeviceRetriever(idx, regime="auto", block_size=64,
                           device=cuda_device)
    path = str(tmp_path / "snap")
    warm.save(path)
    reset_transfer_stats()
    di = DeviceIndex.load(path, mmap=True, device=cuda_device)
    assert di.csc_doc_ids.device.type == "cuda"
    assert TRANSFERS.posting_uploads == 5
    assert TRANSFERS.posting_bytes == sum(
        t.numel() * 4 for t in (di.csc_doc_ids, di.csc_scores, di.blk_tok,
                                di.blk_loc, di.blk_sc))
    cold = DeviceRetriever(None, device_index=di)
    assert cold.device.type == "cuda" and cold.plan_mode == "device"
    queries = [rng.integers(0, 90, size=5).astype(np.int32)
               for _ in range(20)]
    for regime in ("auto", "gathered", "blocked", "pruned"):
        a = cold.retrieve_batch(queries, 9, regime=regime)
        b = warm.retrieve_batch(queries, 9, regime=regime)
        np.testing.assert_array_equal(a.ids, b.ids)
        np.testing.assert_array_equal(a.scores.view(np.int32),
                                      b.scores.view(np.int32))
    reset_transfer_stats()
    cold.retrieve_batch(queries, 9)
    assert TRANSFERS.posting_bytes == TRANSFERS.descriptor_bytes == 0


@pytest.mark.parametrize("regime", ["auto", "gathered", "pruned"])
def test_reordered_retriever_on_the_card_exact(cuda_device, regime):
    """A reordered retriever on the card answers in client ids, exact
    against ScipyBM25 and bitwise the CPU path's boards, shipping no
    posting or descriptor byte per batch."""
    rng = np.random.default_rng(22)
    corpus = make_corpus(rng, n_docs=2000, n_vocab=90, max_len=30)
    idx = build_index(corpus, 90, params=BM25Params(method="robertson"))
    kw = dict(regime=regime, block_size=64, reorder="signature")
    gpu = DeviceRetriever(idx, device=cuda_device, **kw)
    cpu = DeviceRetriever(idx, plan="device", device="cpu", **kw)
    assert gpu.dindex.perm is not None
    queries = [rng.integers(0, 90, size=5).astype(np.int32)
               for _ in range(12)]
    gpu.retrieve_batch(queries, 11)
    reset_transfer_stats()
    a = gpu.retrieve_batch(queries, 11)
    assert TRANSFERS.posting_bytes == TRANSFERS.descriptor_bytes == 0
    b = cpu.retrieve_batch(queries, 11)
    np.testing.assert_array_equal(a.ids, b.ids)
    np.testing.assert_array_equal(a.scores.view(np.int32),
                                  b.scores.view(np.int32))
    oracle = ScipyBM25(idx)
    for i, q in enumerate(queries):
        o = oracle.score(q)
        _, ref_v = topk_numpy(o[None], 11)
        np.testing.assert_allclose(a.scores[i], ref_v[0], atol=1e-4)
        np.testing.assert_allclose(o[a.ids[i]], a.scores[i], atol=1e-4)


@pytest.mark.parametrize("profile", ["head", "dense"])
def test_device_planner_on_card_equals_host_plan(cuda_device, profile):
    rng = np.random.default_rng(11)
    corpus = make_corpus(rng, n_docs=3000, n_vocab=80, max_len=30)
    idx = build_index(corpus, 80, params=BM25Params())
    di = DeviceIndex.build(idx, device=cuda_device, block_size=64, tile=16,
                           frag=8, with_blocked=False, with_bmax=False)
    uniq = (np.arange(80, dtype=np.int64) if profile == "dense"
            else np.unique(rng.integers(0, 10, size=6)).astype(np.int64))
    tab = np.full(128, np.iinfo(np.int32).max, np.int32)
    tab[:uniq.size] = uniq
    fp = fragment_plan(idx, uniq, block_size=64, frag=8)
    desc, dids, nf_pad = plan_fragments_device(di, tab, sum_df=fp.sum_df,
                                               k=9, block_size=64)
    host = fragment_plan(idx, uniq, block_size=64, frag=8,
                         nf_bucket=nf_pad)
    assert torch.equal(desc.cpu(), torch.as_tensor(host.desc))
    assert torch.equal(dids.cpu(), torch.as_tensor(default_doc_ids(
        host.vis_blocks, 9, idx.n_docs, 64)))


def test_pruned_retriever_on_cuda_equals_cpu_path(cuda_device):
    rng = np.random.default_rng(6)
    corpus = make_corpus(rng, n_docs=700, n_vocab=80, max_len=30)
    idx = build_index(corpus, 80, params=BM25Params(method="bm25l"))
    queries = [rng.integers(0, 80, size=5).astype(np.int32)
               for _ in range(9)] + [np.array([3], np.int32)]
    for k in (1, 7):
        on_gpu = DeviceRetriever(idx, regime="pruned", block_size=64,
                                 device=cuda_device)
        on_cpu = DeviceRetriever(idx, regime="pruned", block_size=64,
                                 plan="device", device="cpu")
        assert on_gpu.plan_mode == "device"
        a = on_gpu.retrieve_batch(queries, k)
        b = on_cpu.retrieve_batch(queries, k)
        np.testing.assert_array_equal(a.ids, b.ids)
        np.testing.assert_array_equal(a.scores.view(np.int32),
                                      b.scores.view(np.int32))
        assert a.plan.frags_pruned == b.plan.frags_pruned


@pytest.mark.parametrize("method", ["robertson", "lucene", "bm25l"])
@pytest.mark.parametrize("k", [1, 7, 32])
@pytest.mark.parametrize("two_level", [False, True])
def test_k4_bitwise_equal_twin(cuda_device, method, k, two_level):
    """K4 on the card equals its CPU twin bit for bit: the per-chunk
    boards, and their fold into one board."""
    rng = np.random.default_rng(200 + k)
    corpus = make_corpus(rng, n_docs=1500, n_vocab=60, max_len=25)
    idx = build_index(corpus, 60, params=BM25Params(method=method))
    qs = [rng.integers(0, 60, size=rng.integers(0, 6)).astype(np.int32)
          for _ in range(40)]
    toks, wts, uniq = pad_queries(qs, 8, return_uniq=True)
    tab, w = pack_query_batch(toks, wts, 64, uniq=uniq)
    gp = gather_posting_runs(idx, uniq, acc_block=32, tile=16)
    ops = tuple(torch.as_tensor(a) for a in (
        gp.token_ids, gp.slot_ids, gp.scores, tab, w, gp.candidates))
    kw = dict(acc_block=32, k=k, two_level=two_level)
    ref = k1.bm25_gather_score_topk(*ops, **kw)
    n0 = k1.LAUNCHES_GATHER.n
    got = k1.bm25_gather_score_topk(*(t.to(cuda_device) for t in ops), **kw)
    torch.cuda.synchronize()
    assert k1.LAUNCHES_GATHER.n == n0 + 1
    assert gp.n_chunks > 1
    for a, b in zip(got, ref):
        assert torch.equal(_bits(a), _bits(b))


def test_ladder_walk_on_the_card_is_exact(cuda_device):
    """On the card: an auto retriever entered at pruned serves healthy,
    recovers a poisoned pruned board on the resident rung, and with the
    breakers tripped rung by rung serves on the host rung (K4), blocked
    and the oracle — every board exact against ScipyBM25 and, for the
    device rungs, bit for bit the CPU path's."""
    rng = np.random.default_rng(8)
    corpus = make_corpus(rng, n_docs=2000, n_vocab=80, max_len=30)
    idx = build_index(corpus, 80, params=BM25Params(method="robertson"))
    qs = [rng.integers(0, 80, size=5).astype(np.int32)
          for _ in range(12)] + [np.zeros(0, np.int32)]
    kw = dict(block_size=64, acc_block=64, q_max=8)
    gpu = DeviceRetriever(idx, regime="auto", device=cuda_device, **kw)
    cpu = DeviceRetriever(idx, regime="auto", plan="device", device="cpu",
                          **kw)
    oracle = ScipyBM25(idx)
    n_k4 = k1.LAUNCHES_GATHER.n
    steps = [("pruned", None, []),
             ("resident", {"site": "kernel.resident_pruned",
                           "kind": "nan_board", "times": 1, "seed": 3}, []),
             ("host", None, ["pruned", "resident"]),
             ("blocked", None, ["host"]),
             ("oracle", None, ["blocked"])]
    for rung, fault, trip in steps:
        boards = []
        for dr in (gpu, cpu):
            dr.regime = "pruned"
            for hop in trip:
                dr.trip_breaker(hop, cooldown_s=600.0)
            if fault is None:
                r = dr.retrieve_batch(qs, 9)
            else:
                with inject_faults(dict(fault)):
                    r = dr.retrieve_batch(qs, 9)
            served = r.degradations[-1]["to"] if r.degradations \
                else "pruned"
            assert served == rung, (rung, r.degradations)
            boards.append(r)
        for i, q in enumerate(qs):
            s_ = oracle.score(q)
            _, ref_v = topk_numpy(s_[None], 9)
            np.testing.assert_allclose(boards[0].scores[i], ref_v[0],
                                       atol=1e-4)
            np.testing.assert_allclose(s_[boards[0].ids[i]],
                                       boards[0].scores[i], atol=1e-4)
        if rung != "oracle":
            np.testing.assert_array_equal(boards[0].ids, boards[1].ids)
            np.testing.assert_array_equal(boards[0].scores.view(np.int32),
                                          boards[1].scores.view(np.int32))
    assert k1.LAUNCHES_GATHER.n > n_k4
    # the engine on the card: the CPU path's scores (its merge orders
    # ties its own way), each id carrying its oracle score
    eng = RetrievalEngine([idx], k=9, deadline_s=60.0, quorum=1.0,
                          scorer_opts=dict(device=cuda_device, **kw))
    fresh = DeviceRetriever(idx, regime="auto", plan="device", device="cpu",
                            **kw).retrieve_batch(qs, 9)
    r = eng.retrieve_batch(qs)
    np.testing.assert_array_equal(r.scores.view(np.int32),
                                  fresh.scores.view(np.int32))
    for i, q in enumerate(qs):
        np.testing.assert_allclose(oracle.score(q)[r.ids[i]], r.scores[i],
                                   atol=1e-4)


@pytest.mark.parametrize("method", ["robertson", "lucene", "bm25l"])
@pytest.mark.parametrize("b", [3, 40])
def test_k6_bitwise_equal_twin(cuda_device, method, b):
    from repro_torch.kernels import ops
    rng = np.random.default_rng(b)
    corpus = make_corpus(rng, n_docs=1003, n_vocab=60, max_len=25)
    idx = build_index(corpus, 60, params=BM25Params(method=method))
    di = DeviceIndex.build(idx, device="cpu", block_size=16, tile=16,
                           frag=8)
    qs = [rng.integers(0, 60, size=rng.integers(0, 6)).astype(np.int32)
          for _ in range(b)]
    toks, wts, uniq = pad_queries(qs, 8, return_uniq=True)
    tab, w = pack_query_batch(toks, wts, 64, uniq=uniq)
    ops_t = (di.blk_tok, di.blk_loc, di.blk_sc, torch.as_tensor(tab),
             torch.as_tensor(w))
    n0 = k2.LAUNCHES_DENSE.n
    ref = k2.bm25_block_score(*ops_t, block_size=16)
    got = k2.bm25_block_score(*(t.to(cuda_device) for t in ops_t),
                              block_size=16)
    assert k2.LAUNCHES_DENSE.n == n0 + 1
    assert torch.equal(_bits(got), _bits(ref))
    shift = torch.arange(b, dtype=torch.float32)
    dense = ops.bm25_score_blocked(*(t.to(cuda_device) for t in ops_t),
                                   shift.to(cuda_device), block_size=16,
                                   n_docs=idx.n_docs)
    assert torch.equal(_bits(dense), _bits(ops.bm25_score_blocked(
        *ops_t, shift, block_size=16, n_docs=idx.n_docs)))


@pytest.mark.parametrize("layout", ["sorted", "shuffled", "holes"])
@pytest.mark.parametrize("b", [8, 64, 100, 256])
def test_k6_bitwise_equal_twin_any_layout(cuda_device, b, layout):
    """K6 at B in {8, 64, 100, 256} (not multiples of 64 among them) with a
    raw table of 1,280 rows, against its CPU twin bit for bit: the
    token-sorted layout, the same postings shuffled within each block (the
    kernel's path for any order), and one with an empty block, a block of
    padding only, rows out of range and a repeated table row."""
    rng = np.random.default_rng(b)
    corpus = make_corpus(rng, n_docs=2000, n_vocab=3000, max_len=60)
    idx = build_index(corpus, 3000, params=BM25Params(method="lucene"))
    di = DeviceIndex.build(idx, device="cpu", block_size=64, tile=64,
                           frag=8)
    tok, loc, sc = (t.clone() for t in (di.blk_tok, di.blk_loc, di.blk_sc))
    uniq = torch.as_tensor(np.sort(rng.choice(3000, 1280, replace=False))
                           .astype(np.int32))
    if layout == "shuffled":
        perm = torch.as_tensor(np.stack([rng.permutation(tok.shape[1])
                                         for _ in range(tok.shape[0])]))
        tok, loc, sc = (torch.gather(t, 1, perm) for t in (tok, loc, sc))
    elif layout == "holes":
        tok[1] = -1                              # no posting at all
        tok[2, : tok.shape[1] // 2] = int(uniq[5])   # one long run
        loc[3, ::7] = 64                         # rows out of range
        loc[4, ::5] = -3
        uniq[11] = uniq[10]                      # a repeated row
    w = torch.as_tensor(rng.normal(size=(1280, b)).astype(np.float32))
    ops_t = (tok, loc, sc, uniq, w)
    n0 = k2.LAUNCHES_DENSE.n
    ref = k2.bm25_block_score(*ops_t, block_size=64)
    got = k2.bm25_block_score(*(t.to(cuda_device) for t in ops_t),
                              block_size=64)
    assert k2.LAUNCHES_DENSE.n == n0 + 1
    assert torch.equal(_bits(got), _bits(ref))


@pytest.mark.parametrize("layout", ["sorted", "shuffled", "holes"])
@pytest.mark.parametrize("n_uniq", [2048, 2049, 4096, 8192])
def test_k6_bitwise_equal_twin_wide_table(cuda_device, n_uniq, layout):
    """K6 with unique tables past one 2,048-row piece, up to 8,192 rows
    (256 queries of Q_MAX 32 tokens), at B = 256 against its CPU twin bit
    for bit: the kernel searches the table a piece at a time and holds the
    same shared memory at every U. "holes" repeats a table row (across
    the first piece boundary where U > 2,148) and ends the table with the
    pack's pad rows."""
    rng = np.random.default_rng(n_uniq)
    n_vocab = 12_000
    corpus = make_corpus(rng, n_docs=3000, n_vocab=n_vocab, max_len=80)
    idx = build_index(corpus, n_vocab, params=BM25Params(method="lucene"))
    di = DeviceIndex.build(idx, device="cpu", block_size=512, tile=64,
                           frag=8)
    tok, loc, sc = di.blk_tok, di.blk_loc, di.blk_sc
    uniq = torch.as_tensor(np.sort(rng.choice(n_vocab, n_uniq,
                                              replace=False))
                           .astype(np.int32))
    if layout == "shuffled":
        perm = torch.as_tensor(np.stack([rng.permutation(tok.shape[1])
                                         for _ in range(tok.shape[0])]))
        tok, loc, sc = (torch.gather(t, 1, perm) for t in (tok, loc, sc))
    elif layout == "holes":
        uniq[-100:] = 2**31 - 1                  # the pack's pad rows
        at = min(2048, n_uniq - 101)
        uniq[at] = uniq[at - 1]                  # repeated across a piece
    w = torch.as_tensor(rng.normal(size=(n_uniq, 256)).astype(np.float32))
    ops_t = (tok, loc, sc, uniq, w)
    n0 = k2.LAUNCHES_DENSE.n
    ref = k2.bm25_block_score(*ops_t, block_size=512)
    got = k2.bm25_block_score(*(t.to(cuda_device) for t in ops_t),
                              block_size=512)
    assert k2.LAUNCHES_DENSE.n == n0 + 1
    assert torch.equal(_bits(got), _bits(ref))


def _k2_operands(rng, method, block_size, b, layout, n_uniq=None):
    """Blocked postings of a seeded corpus (its last block part padding),
    every third document a copy of the one before (exact ties), and a
    query table: a packed batch of ``b`` queries or, with ``n_uniq``, that
    many sorted table rows. Every fifth weight column is zero (a column of
    ties only). Layouts as K6's tests: token-sorted, shuffled within each
    block, and one with an empty block, a long run, rows out of range and
    a repeated table row."""
    n_vocab = 3000 if n_uniq is None else 12_000
    n_docs = 2 * block_size + block_size // 3 + 5
    corpus = make_corpus(rng, n_docs=n_docs, n_vocab=n_vocab, max_len=60)
    corpus[2::3] = corpus[1::3][:len(corpus[2::3])]
    idx = build_index(corpus, n_vocab, params=BM25Params(method=method))
    di = DeviceIndex.build(idx, device="cpu", block_size=block_size, tile=64,
                           frag=8, with_bmax=False)
    tok, loc, sc = (t.clone() for t in (di.blk_tok, di.blk_loc, di.blk_sc))
    if n_uniq is None:
        qs = [rng.integers(0, n_vocab, size=rng.integers(1, 8))
              .astype(np.int32) for _ in range(b)]
        toks, wts, uniq = pad_queries(qs, 8, return_uniq=True)
        tab, w = pack_query_batch(toks, wts, 8 * b, uniq=uniq)
        tab, w = torch.as_tensor(tab), torch.as_tensor(w)
    else:
        tab = torch.as_tensor(np.sort(rng.choice(n_vocab, n_uniq,
                                                 replace=False))
                              .astype(np.int32))
        w = torch.as_tensor(rng.normal(size=(n_uniq, b)).astype(np.float32))
    w[:, ::5] = 0.0
    if layout == "shuffled":
        perm = torch.as_tensor(np.stack([rng.permutation(tok.shape[1])
                                         for _ in range(tok.shape[0])]))
        tok, loc, sc = (torch.gather(t, 1, perm) for t in (tok, loc, sc))
    elif layout == "holes":
        tok[1] = -1                              # no posting at all
        tok[2, : tok.shape[1] // 2] = int(tab[5])    # one long run
        loc[0, ::7] = block_size                 # rows out of range
        loc[0, 3::11] = -3
        tab[11] = tab[10]                        # a repeated row
    return (tok, loc, sc, tab, w), idx.n_docs


# (block_size, k): blocks of 16, 200 and 700 rows (not multiples of 32 or
# 512), one window of 512 and two of 1,024; k from 1 to the whole block.
# A block of at most 512 rows selects its board 128 rows a pass (k = 129
# to 512 in two to four passes); a block past 512 rows puts the board in
# device memory
_K2_SHAPES = [(16, 1), (16, 7), (16, 16), (64, 1), (64, 7), (64, 32),
              (64, 64), (512, 1), (512, 32), (512, 100), (512, 512),
              (700, 1), (700, 100), (700, 700), (1024, 7), (1024, 100),
              (1024, 1024), (512, 7), (700, 7), (700, 32), (1024, 1),
              (1024, 32), (512, 128), (512, 129), (512, 200), (512, 385),
              (200, 150)]


@pytest.mark.parametrize("layout", ["sorted", "shuffled", "holes"])
@pytest.mark.parametrize("block_size,k", _K2_SHAPES)
def test_k2_bitwise_equal_twin_any_shape(cuda_device, block_size, k,
                                         layout):
    """K2 (K6's walk, a window of 512 rows at a time, then the select in
    passes of 128 board rows, or past 512 rows the threshold fold into an
    empty board) against its CPU twin bit for bit, values and rows: block
    sizes 16 to 1,024, k from 1 to the block, B in {3, 64,
    100, 256}, robertson's negative IDF among three variants, columns of
    ties only, repeated documents, and a last block part padding (its
    padding rows are taken, in row order, when k asks for them)."""
    i = _K2_SHAPES.index((block_size, k))
    b = (3, 64, 100, 256)[i % 4]
    method = ("robertson", "lucene", "bm25l")[i % 3]
    ops_t, n_docs = _k2_operands(np.random.default_rng(1000 + i), method,
                                 block_size, b, layout)
    assert n_docs % block_size != 0
    kw = dict(block_size=block_size, k=k, n_docs=n_docs)
    n0 = k2.LAUNCHES.n
    ref = k2.bm25_block_score_topk(*ops_t, **kw)
    got = k2.bm25_block_score_topk(*(t.to(cuda_device) for t in ops_t),
                                   **kw)
    torch.cuda.synchronize()
    assert k2.LAUNCHES.n == n0 + 1
    for a, r in zip(got, ref):
        assert torch.equal(_bits(a), _bits(r))


@pytest.mark.parametrize("layout", ["sorted", "shuffled", "holes"])
@pytest.mark.parametrize("n_uniq", [2048, 2049, 8192])
def test_k2_bitwise_equal_twin_wide_table(cuda_device, n_uniq, layout):
    """K2 at B = 256, k = 100, block 512 with unique tables of one to four
    2,048-row pieces (8,192 rows: 256 queries of Q_MAX 32 tokens), against
    its CPU twin bit for bit."""
    ops_t, n_docs = _k2_operands(np.random.default_rng(n_uniq), "robertson",
                                 512, 256, layout, n_uniq=n_uniq)
    kw = dict(block_size=512, k=100, n_docs=n_docs)
    ref = k2.bm25_block_score_topk(*ops_t, **kw)
    got = k2.bm25_block_score_topk(*(t.to(cuda_device) for t in ops_t),
                                   **kw)
    for a, r in zip(got, ref):
        assert torch.equal(_bits(a), _bits(r))


def test_k2_k4_take_tables_the_first_kernels_refused(cuda_device):
    """The first K2 and K4 kept the unique table in shared memory beside
    their accumulator and refused tables past ~40 k rows at 512 rows; the
    walk searches the table 2,048 rows a piece, so 50,000 rows (the pack's
    pad rows among them) run, bitwise equal to the twins."""
    rng = np.random.default_rng(50)
    n_vocab = 60_000
    corpus = make_corpus(rng, n_docs=1500, n_vocab=n_vocab, max_len=60)
    idx = build_index(corpus, n_vocab, params=BM25Params(method="lucene"))
    di = DeviceIndex.build(idx, device="cpu", block_size=512, tile=64,
                           frag=8, with_bmax=False)
    tab = np.sort(rng.choice(n_vocab, 50_000, replace=False)).astype(np.int32)
    tab[-500:] = np.iinfo(np.int32).max
    tab_t = torch.as_tensor(tab)
    w = torch.as_tensor(rng.normal(size=(50_000, 8)).astype(np.float32))
    ops2 = (di.blk_tok, di.blk_loc, di.blk_sc, tab_t, w)
    kw2 = dict(block_size=512, k=10, n_docs=idx.n_docs)
    for a, r in zip(k2.bm25_block_score_topk(*(t.to(cuda_device)
                                               for t in ops2), **kw2),
                    k2.bm25_block_score_topk(*ops2, **kw2)):
        assert torch.equal(_bits(a), _bits(r))
    gp = gather_posting_runs(idx, np.unique(tab[:-500]), acc_block=512,
                             tile=64)
    ops4 = tuple(torch.as_tensor(a) for a in (
        gp.token_ids, gp.slot_ids, gp.scores, tab, w, gp.candidates))
    for two_level in (False, True):
        kw4 = dict(acc_block=512, k=10, two_level=two_level)
        for a, r in zip(k1.bm25_gather_score_topk(*(t.to(cuda_device)
                                                    for t in ops4), **kw4),
                        k1.bm25_gather_score_topk(*ops4, **kw4)):
            assert torch.equal(_bits(a), _bits(r))


def test_k2_k4_refuse_more_than_65535_blocks(cuda_device):
    """What K2 and K4 still refuse: more than 65,535 blocks or chunks (a
    CTA row each in the grid's y dimension); the twins take any count."""
    n = 65_536
    tok = torch.full((n, 1), -1, dtype=torch.int32, device=cuda_device)
    loc = torch.zeros((n, 1), dtype=torch.int32, device=cuda_device)
    sc = torch.zeros((n, 1), device=cuda_device)
    tab = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    w = torch.zeros((1, 4), device=cuda_device)
    cand = torch.full((n, 16), -1, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="65535"):
        k2.bm25_block_score_topk(tok, loc, sc, tab, w, block_size=16, k=1,
                                 n_docs=16 * n)
    with pytest.raises(ValueError, match="65535"):
        k1.bm25_gather_score_topk(tok, loc, sc, tab, w, cand, acc_block=16,
                                  k=1)


@pytest.mark.parametrize("two_level", [False, True])
@pytest.mark.parametrize("k", [1, 7, 32, 100, 200, 600])
def test_k4_bitwise_equal_twin_wide_boards(cuda_device, k, two_level):
    """K4 at ``acc_block`` as ``DeviceRetriever`` sizes it,
    ``bucket_pow2(k, floor=512)``: 512 rows (one window; k = 200 selects
    in two passes) for k <= 512 and 1,024 (two windows, the board in
    device memory) for k = 600; robertson's
    negative IDF, and chunks with fewer real candidates than k (the last
    chunk, and a batch of 3 rare-token queries whose one chunk is mostly
    padding: winners of id -1), against the CPU twin bit for bit."""
    acc = 1024 if k > 512 else 512
    rng = np.random.default_rng(600 + k)
    corpus = make_corpus(rng, n_docs=3000, n_vocab=300, max_len=25)
    idx = build_index(corpus, 300, params=BM25Params(method="robertson"))
    for b, q_len in ((40, 6), (3, 2)):
        qs = [rng.integers(0, 300, size=rng.integers(1, q_len))
              .astype(np.int32) for _ in range(b)]
        toks, wts, uniq = pad_queries(qs, 8, return_uniq=True)
        tab, w = pack_query_batch(toks, wts, 8 * b, uniq=uniq)
        gp = gather_posting_runs(idx, uniq, acc_block=acc, tile=16)
        assert int((gp.candidates[-1] < 0).sum()) > 0    # padding slots
        ops = tuple(torch.as_tensor(a) for a in (
            gp.token_ids, gp.slot_ids, gp.scores, tab, w, gp.candidates))
        kw = dict(acc_block=acc, k=k, two_level=two_level)
        n0 = k1.LAUNCHES_GATHER.n
        ref = k1.bm25_gather_score_topk(*ops, **kw)
        got = k1.bm25_gather_score_topk(*(t.to(cuda_device) for t in ops),
                                        **kw)
        torch.cuda.synchronize()
        assert k1.LAUNCHES_GATHER.n == n0 + 1
        for a, r in zip(got, ref):
            assert torch.equal(_bits(a), _bits(r))


def _k5_rows(rng, kind, r, n):
    if kind == "normal":
        return rng.normal(size=(r, n)).astype(np.float32)
    if kind == "ties":
        return rng.integers(-2, 3, size=(r, n)).astype(np.float32)
    if kind == "signed_zeros":              # +0.0 and -0.0 rank as equal
        x = np.where(rng.random((r, n)) < 0.5, 0.0, -0.0).astype(np.float32)
        x[:, ::97] = 1.0
        return x
    if kind == "denormals":
        return (rng.integers(-5, 6, size=(r, n))
                * np.float32(1e-45)).astype(np.float32)
    if kind == "kth_ties":                  # a few winners, then one value
        x = np.full((r, n), 2.5, np.float32)
        x[:, ::301] = rng.normal(5.0, 1.0, size=x[:, ::301].shape)
        x[:, 7::11] = -1.0
        return x
    fill = {"zeros": 0.0, "neg_inf": -np.inf,
            "flt_min": np.finfo(np.float32).min}[kind]
    x = np.full((r, n), fill, np.float32)
    x[-1, ::13] = 1.0
    return x


@pytest.mark.parametrize("kind", ["normal", "ties", "zeros", "neg_inf",
                                  "flt_min", "signed_zeros", "denormals",
                                  "kth_ties"])
@pytest.mark.parametrize("n,block,k", [(2048, 512, 1), (2048, 512, 7),
                                       (4096, 4096, 100), (1500, 512, 512),
                                       (4100, 4096, 4096), (9000, 4096, 100),
                                       (700, 512, 300)])
def test_k5_bitwise_equal_twin(cuda_device, kind, n, block, k):
    from repro_torch.kernels import blockwise_topk as k5
    x = torch.as_tensor(_k5_rows(np.random.default_rng(n + k), kind, 3, n))
    n0 = k5.LAUNCHES.n
    ref = k5.blockwise_topk(x, k=k, block=block)
    got = k5.blockwise_topk(x.to(cuda_device), k=k, block=block)
    assert k5.LAUNCHES.n == n0 + 1
    for a, b in zip(got, ref):
        assert torch.equal(_bits(a), _bits(b))
    pos = got[1].cpu()
    real = torch.where(pos >= 0, pos, -2 - torch.arange(k))   # pads apart
    assert bool((torch.sort(real, 1).values.diff(dim=1) != 0).all())


def test_topk_and_retriever_on_cuda_equal_cpu(cuda_device):
    from repro_torch.core import BM25Retriever
    from repro_torch.kernels import blockwise_topk as k5
    from repro_torch.kernels import ops
    x = torch.as_tensor(_k5_rows(np.random.default_rng(1), "ties", 4, 9000))
    on_gpu = ops.topk(x.to(cuda_device), 300)
    on_cpu = ops.topk(x, 300)
    for a, b in zip(on_gpu, on_cpu):
        assert torch.equal(_bits(a), _bits(b))
    rng = np.random.default_rng(2)
    words = [" ".join(f"w{int(t)}x" for t in rng.zipf(1.3, size=8) % 400)
             for _ in range(5000)]
    words += words[:2000]                  # exact ties: repeated documents
    queries = [" ".join(f"w{int(t)}x" for t in rng.zipf(1.3, size=3) % 400)
               for _ in range(6)]
    r_gpu = BM25Retriever(method="robertson").index(words)
    r_cpu = BM25Retriever(method="robertson", device="cpu").index(words)
    assert r_gpu.device.type == "cuda"
    n0 = k5.LAUNCHES.n
    ids, vals = r_gpu.retrieve(queries, k=25)
    assert k5.LAUNCHES.n == n0 + 1
    cids, cvals = r_cpu.retrieve(queries, k=25)
    # score_batch sums in one fixed order on every device: the boards are
    # the CPU's bit for bit, ids of exact ties included (8 words over 400
    # distinct ones: many documents score the same)
    assert torch.equal(ids.cpu(), cids)
    assert torch.equal(_bits(vals), _bits(cvals))
    assert int((vals[:, 1:] == vals[:, :-1]).sum()) > 0      # ties exist
    oracle = ScipyBM25(r_cpu.bm25_index)
    for i, q in enumerate(r_cpu.tokenizer.tokenize_queries(queries)):
        np.testing.assert_allclose(oracle.score(q)[ids[i].cpu().numpy()],
                                   vals[i].cpu().numpy(), atol=1e-4)


@pytest.mark.parametrize("method", ["robertson", "lucene", "bm25+"])
def test_score_batch_on_card_is_fixed_order(cuda_device, method):
    """Two runs on the card bitwise equal, and equal to the CPU, with a
    budget that truncates and one that does not."""
    from repro_torch.core import DeviceIndex as ScoringIndex
    from repro_torch.core import score_batch
    rng = np.random.default_rng(3)
    corpus = make_corpus(rng, n_docs=3000, n_vocab=80, max_len=40)
    idx = build_index(corpus, 80, params=BM25Params(method=method))
    qs = [rng.integers(0, 80, size=rng.integers(1, 7)).astype(np.int32)
          for _ in range(40)]
    toks, wts = pad_queries(qs, 8)
    cpu = ScoringIndex.from_host(idx, device="cpu")
    gpu = ScoringIndex.from_host(idx, device=cuda_device)
    for p_max in (1024, 200_000):
        a = score_batch(gpu, toks, wts, p_max=p_max)
        b = score_batch(gpu, toks, wts, p_max=p_max)
        c = score_batch(cpu, toks, wts, p_max=p_max)
        assert torch.equal(_bits(a), _bits(b))
        assert torch.equal(_bits(a), _bits(c))


def _k7_inputs(rng, nb, p, d, s, dtype, sort):
    vals = rng.normal(size=(nb, p, d)).astype(dtype)
    ids = rng.integers(0, s, size=(nb, p)).astype(np.int32)
    if sort:                               # runs of a segment, as in a graph
        ids.sort(axis=1)                   # blocked by destination
    ids[:, ::7] = -1                       # dropped
    ids[:, 3::11] = s                      # dropped
    vals[:, 5::13] = -0.0                  # rows of zeros are skipped
    vals[:, 6::17, ::2] = 0.0              # rows with some zeros are not
    ids[:, -64:] = 0                       # padding postings: id 0, value 0
    vals[:, -64:] = 0
    return torch.as_tensor(vals), torch.as_tensor(ids)


# one D-tile of 64 (the ogb_products shape's), four D-tiles of 64 with a
# partial last one, four of 16 (S = 3,000 narrows the tile), a P that
# ends mid-chunk, and S = 10,000 and 50,000 (8 columns, S cut into 2 and 8
# ranges); ids in random order and in sorted runs
@pytest.mark.parametrize("sort", [False, True])
@pytest.mark.parametrize("dtype", [np.float32, np.float16])
@pytest.mark.parametrize("nb,p,d,s,tile_p", [
    (3, 1024, 64, 512, 512), (2, 768, 200, 64, 256), (2, 512, 64, 3000, 512),
    (5, 96, 20, 40, 32), (2, 512, 64, 10_000, 512),
    (2, 256, 20, 50_000, 256)])
def test_k7_bitwise_equal_twin(cuda_device, dtype, nb, p, d, s, tile_p,
                               sort):
    from repro_torch.kernels import block_segment_sum as k7
    vals, ids = _k7_inputs(np.random.default_rng(p + d), nb, p, d, s, dtype,
                           sort)
    n0 = k7.LAUNCHES.n
    ref = k7.block_segment_sum(vals, ids, num_segments=s, tile_p=tile_p)
    got = k7.block_segment_sum(vals.to(cuda_device), ids.to(cuda_device),
                               num_segments=s, tile_p=tile_p)
    assert k7.LAUNCHES.n == n0 + 1
    assert got.dtype == vals.dtype and got.shape == (nb, s, d)
    assert torch.equal(got.cpu().view(torch.int16 if dtype == np.float16
                                      else torch.int32),
                       ref.view(torch.int16 if dtype == np.float16
                                else torch.int32))


@pytest.mark.parametrize("v,d,b,f", [(5000, 602, 300, 15), (700, 37, 129, 10),
                                     (64, 1, 9, 3), (90, 128, 40, 0)])
def test_k8_bitwise_equal_twin(cuda_device, v, d, b, f):
    from repro_torch.kernels import ops
    from repro_torch.kernels.embedding_bag import LAUNCHES
    from repro_torch.kernels.embedding_bag import embedding_bag as k8
    from repro_torch.kernels.embedding_bag import embedding_bag_plain
    rng = np.random.default_rng(v + d)
    table = torch.as_tensor(rng.normal(size=(v, d)).astype(np.float32))
    idx = torch.as_tensor(rng.integers(-1, v, size=(b, f)).astype(np.int32))
    if f:
        idx[0] = -1                                 # an all-pad bag
    w = torch.as_tensor(rng.normal(size=(b, f)).astype(np.float32))
    n0 = LAUNCHES.n
    ref = k8(table, idx, w)
    got = k8(table.to(cuda_device), idx.to(cuda_device), w.to(cuda_device))
    assert LAUNCHES.n == n0 + 1
    assert torch.equal(_bits(got), _bits(ref))
    # the twin on the card: the same elementwise arithmetic, no atomics
    on_card = embedding_bag_plain(table.to(cuda_device), idx.to(cuda_device),
                                  w.to(cuda_device))
    assert torch.equal(_bits(on_card), _bits(ref))
    ones = ops.embedding_bag(table.to(cuda_device), idx.to(cuda_device))
    assert torch.equal(_bits(ones), _bits(k8(table, idx, torch.ones_like(w))))
    assert LAUNCHES.n == n0 + 2


def test_k8_table_past_2_31_elements(cuda_device):
    """A table of more than 2^31 elements, allocated empty with only the
    indexed rows written: row offsets are 64-bit. The twin runs on a
    compact copy of those rows (the same sums in the same order)."""
    from repro_torch.kernels.embedding_bag import embedding_bag as k8
    d = 128
    v = 2 ** 31 // d + 4097                     # 2,147,483,648 + 524,416
    rng = np.random.default_rng(31)
    rows = np.unique(np.concatenate([
        rng.integers(v - 5000, v, size=40), rng.integers(0, 1000, size=8),
        [v - 1]]))
    compact = torch.as_tensor(rng.normal(size=(rows.size, d)).astype(
        np.float32))
    table = torch.empty((v, d), dtype=torch.float32, device=cuda_device)
    table[torch.as_tensor(rows, device=cuda_device)] = compact.to(
        cuda_device)
    local = rng.integers(-1, rows.size, size=(64, 6)).astype(np.int32)
    glob = np.where(local >= 0, rows[np.maximum(local, 0)], -1).astype(
        np.int32)
    w = torch.as_tensor(rng.normal(size=(64, 6)).astype(np.float32))
    got = k8(table, torch.as_tensor(glob, device=cuda_device),
             w.to(cuda_device))
    ref = k8(compact, torch.as_tensor(local), w)
    assert torch.equal(_bits(got), _bits(ref))
    del table
    torch.cuda.empty_cache()


def _k7_bitwise(cuda_device, vals, ids, s, ring, on_card=None):
    """K7 on the card (on ``on_card``, default a copy of ``vals``) against
    its CPU twin, bit for bit, through the route the plan gives
    (``ring``: the TMA ring, else the staged path)."""
    from repro_torch.kernels import block_segment_sum as k7
    if on_card is None:
        on_card = vals.to(cuda_device)
    nb, p, d = vals.shape
    stages = k7.ring_stages(on_card.data_ptr(), p, d, s, vals.element_size())
    assert (stages > 0) == ring
    n0 = k7.LAUNCHES.n
    got = k7.block_segment_sum(on_card, ids.to(cuda_device), num_segments=s,
                               tile_p=1)
    assert k7.LAUNCHES.n == n0 + 1
    ref = k7.block_segment_sum(vals, ids, num_segments=s, tile_p=1)
    nan = torch.isnan(ref)
    assert torch.equal(torch.isnan(got.cpu()), nan)
    bits = torch.int16 if vals.dtype == torch.float16 else torch.int32
    assert torch.equal(got.cpu().view(bits)[~nan], ref.view(bits)[~nan])


# the ring's stage edges at the ogb_products tile (64 postings a stage,
# 5 stages): a P of one posting, a stage +- 1, two, three and the whole
# ring +- 1, and past two laps; 5 blocks on the card's persistent CTAs
@pytest.mark.parametrize("sort", [False, True])
@pytest.mark.parametrize("p", [1, 63, 64, 65, 127, 128, 129, 191, 192, 193,
                               "ring-1", "ring+1", "2ring+1"])
def test_k7_ring_bitwise_at_stage_edges(cuda_device, p, sort):
    from repro_torch.kernels import block_segment_sum as k7
    st = k7.ring_stages(0, 64, 64, 512, 4)
    p = {"ring-1": 64 * st - 1, "ring+1": 64 * st + 1,
         "2ring+1": 128 * st + 1}.get(p, p)
    vals, ids = _k7_inputs(np.random.default_rng(p), 5, p + 64, 64, 512,
                           np.float32, sort)
    vals, ids = vals[:, :p].contiguous(), ids[:, :p].contiguous()  # no pad
    _k7_bitwise(cuda_device, vals, ids, 512, ring=True)


def test_k7_ring_all_padding_and_more_blocks_than_ctas(cuda_device):
    """A block that is all padding, and ogb_products' layout (edges sorted
    by destination, each block's tail padded with id 0, value 0) over 2 x
    132 + 7 blocks, so each persistent CTA changes blocks at least twice
    with its ring running on into the next block."""
    rng = np.random.default_rng(271)
    vals, ids = _k7_inputs(rng, 3, 200, 64, 512, np.float32, True)
    vals[1] = 0.0
    ids[1] = 0
    _k7_bitwise(cuda_device, vals, ids, 512, ring=True)
    nb, p = 2 * 132 + 7, 320
    counts = rng.integers(0, p + 1, size=nb)
    counts[[0, 5]] = (0, p)
    vals = np.zeros((nb, p, 64), np.float32)
    ids = np.zeros((nb, p), np.int32)
    for b, c in enumerate(counts):
        vals[b, :c] = rng.normal(size=(c, 64))
        ids[b, :c] = np.sort(rng.integers(0, 512, size=c))
    _k7_bitwise(cuda_device, torch.as_tensor(vals), torch.as_tensor(ids), 512,
                ring=True)


@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_k7_signed_zeros_infs_and_nans(cuda_device, dtype):
    """Rows of -0.0 (skipped), +-inf rows and a segment that sums inf and
    -inf (NaN), bitwise; NaN rows give NaN in the same places (NaN bits
    differ between the CPU and the card, so they are not compared)."""
    rng = np.random.default_rng(7)
    vals, ids = _k7_inputs(rng, 3, 200, 64, 512, dtype, True)
    vals[0, 10] = -0.0
    vals[0, 20] = np.inf
    vals[0, 21, ::3] = -np.inf
    vals[1, 30] = -np.inf
    vals[2, 40, 3] = np.nan
    vals[2, 41] = np.nan
    ids[0, 10] = ids[0, 20] = ids[0, 21] = 5
    ids[1, 30] = 7
    _k7_bitwise(cuda_device, vals, ids, 512, ring=True)


def test_k7_odd_f16_and_unaligned_views_take_the_staged_path(cuda_device):
    """f16 with P * D odd and a view whose first value is not 16-byte
    aligned fail the bulk copy's alignment: the plan sends them to the
    staged path, which runs them bit for bit."""
    rng = np.random.default_rng(33)
    _k7_bitwise(cuda_device, *_k7_inputs(rng, 3, 33, 3, 16, np.float16,
                                         False), 16, ring=False)
    vals, ids = _k7_inputs(rng, 3, 128, 64, 512, np.float32, True)
    for off in (1, 2):
        buf = torch.zeros(vals.numel() + off, device=cuda_device)
        buf[off:] = vals.reshape(-1).to(cuda_device)
        view = buf[off:].view(vals.shape)
        assert view.data_ptr() % 16 == 4 * off
        _k7_bitwise(cuda_device, vals, ids, 512, ring=False, on_card=view)


# one case of every column_tile plan and route: the ring at d_tile 64,
# 32, 16 and 8 (2 stages beside the widest accumulator), D = 1; the staged
# path at d_tile 16 < D, D > 64 and S cut into ranges
@pytest.mark.parametrize("nb,p,d,s,ring", [
    (3, 256, 64, 512, True), (3, 96, 20, 40, True), (3, 128, 16, 2048, True),
    (3, 64, 8, 7056, True), (3, 64, 1, 16, True),
    (2, 512, 64, 3000, False), (2, 256, 200, 64, False),
    (2, 512, 64, 10_000, False), (2, 256, 20, 50_000, False)])
def test_k7_every_column_tile_plan(cuda_device, nb, p, d, s, ring):
    vals, ids = _k7_inputs(np.random.default_rng(s + d), nb, p, d, s,
                           np.float32, True)
    _k7_bitwise(cuda_device, vals, ids, s, ring=ring)


def _k8_bitwise(cuda_device, table, idx, w, width=None):
    from repro_torch.kernels.embedding_bag import (LAUNCHES, embedding_bag,
                                                   load_width)
    n0 = LAUNCHES.n
    got = embedding_bag(table, idx.to(cuda_device), w.to(cuda_device))
    assert LAUNCHES.n == n0 + 1
    if width is not None:
        assert load_width(table.data_ptr(), got.data_ptr(),
                          table.shape[1]) == width
    ref = embedding_bag(table.cpu(), idx, w)
    assert torch.equal(_bits(got), _bits(ref))


@pytest.mark.parametrize("f", [0, 1, 15, 32, 33, 100])
@pytest.mark.parametrize("d,width", [(1, 1), (2, 2), (3, 1), (601, 1),
                                     (602, 2), (1024, 4)])
def test_k8_bitwise_any_width_and_fanout(cuda_device, d, width, f):
    """Each load width (4-, 8- and 16-byte) and fanouts below, at and past
    one ballot of 32 slots; bags that repeat an index and an all-pad bag."""
    rng = np.random.default_rng(d * 101 + f)
    table = torch.as_tensor(rng.normal(size=(300, d)).astype(np.float32))
    idx = torch.as_tensor(rng.integers(-1, 300, size=(37, f)).astype(
        np.int32))
    if f:
        idx[0] = -1                             # an all-pad bag
        idx[1] = 17                             # one row, every slot
        idx[2, ::2] = 5                         # a row repeated
    w = torch.as_tensor(rng.normal(size=(37, f)).astype(np.float32))
    _k8_bitwise(cuda_device, table.to(cuda_device), idx, w, width)


def test_k8_table_view_only_4_byte_aligned(cuda_device):
    """A table view whose first row starts 4 bytes past an aligned base:
    the wrapper takes 4-byte loads (at D = 602 and D = 1,024); an 8-byte
    offset allows 8-byte loads at 1,024."""
    rng = np.random.default_rng(4)
    idx = torch.as_tensor(rng.integers(-1, 200, size=(50, 15)).astype(
        np.int32))
    w = torch.as_tensor(rng.normal(size=(50, 15)).astype(np.float32))
    for d, off, width in ((602, 1, 1), (1024, 1, 1), (1024, 2, 2)):
        buf = torch.as_tensor(rng.normal(size=(200 * d + off,)).astype(
            np.float32)).to(cuda_device)
        table = buf[off:].view(200, d)
        assert table.data_ptr() % 16 == 4 * off
        _k8_bitwise(cuda_device, table, idx, w, width)


@pytest.mark.parametrize("b", [1, 7, 1024, 15_360])
def test_k8_bitwise_any_batch(cuda_device, b):
    """Reddit's width (602) and hop-1's fanout at B from one bag to
    hop-2's 15,360."""
    rng = np.random.default_rng(b)
    table = torch.as_tensor(rng.normal(size=(5000, 602)).astype(np.float32))
    idx = torch.as_tensor(rng.integers(-1, 5000, size=(b, 15)).astype(
        np.int32))
    w = torch.as_tensor(rng.normal(size=(b, 15)).astype(np.float32))
    _k8_bitwise(cuda_device, table.to(cuda_device), idx, w, 2)
