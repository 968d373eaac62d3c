"""The pruned regime in the port: block-max tables, masks, K3's twin, boards.

* **host layer** — ``build_block_max`` (f32, u8, auto), ``block_upper_bounds``,
  ``estimate_prune_survivors``, ``select_seed_blocks`` and
  ``prune_fragment_plan`` equal ``repro.sparse.block_csr``'s byte for byte
  (the port builds u8 codes from the runs alone, never the dense f32
  table); ``convert.block_max_from_reference`` carries a reference table
  across.
* **device half** — ``block_bounds_device`` (float64 product) agrees with
  the reference's jnp one within 1e-6 (the f32 and f64 products round
  apart); ``seed_fragment_mask``, ``prune_fragment_mask`` and
  ``compact_fragment_table`` equal the jnp ones exactly on the same bounds.
* **K3 twin** — equal to K1's twin on the same compacted table in every
  real column, and on a late-saturating corpus it skips more than half the
  fragments mid-walk.
* **serve** — pruned boards equal the gathered boards bit for bit for all
  five variants, under both planners and both bound dtypes, and are exact
  against ``ScipyBM25``; the reference's edge cases (compaction fires,
  ``auto`` picks pruned at k = 1, all non-seed fragments pruned, k ≥
  n_docs, k > block_size) hold.

The reference's K3 Pallas kernel does not run under the installed jax
(ROADMAP R1), so no test here calls it or ``repro``'s pruned retriever.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from conftest import make_corpus  # noqa: E402
from repro.core import index as ref_index  # noqa: E402
from repro.core.retrieval import PRUNE_DISCOUNT as REF_PRUNE  # noqa: E402
from repro.core.variants import BM25Params as RefParams  # noqa: E402
from repro.sparse import block_csr as ref_csr  # noqa: E402
from repro.sparse import fragment_device as ref_fd  # noqa: E402

from repro_torch.convert import block_max_from_reference  # noqa: E402
from repro_torch.core import (BM25Params, ScipyBM25, build_index,  # noqa: E402
                              plan_retrieval, topk_numpy)
from repro_torch.core.retrieval import PRUNE_DISCOUNT  # noqa: E402
from repro_torch.core.scoring import pad_queries  # noqa: E402
from repro_torch.kernels import bm25_gather_score as k1  # noqa: E402
from repro_torch.serve import DeviceRetriever, ResidencyError  # noqa: E402
from repro_torch.sparse import block_csr as port_csr  # noqa: E402
from repro_torch.sparse import fragment_device as port_fd  # noqa: E402
from repro_torch.sparse.block_csr import (TRANSFERS, DeviceIndex,  # noqa: E402
                                          fragment_plan,
                                          reset_transfer_stats)

ALL_VARIANTS = ["robertson", "atire", "lucene", "bm25l", "bm25+"]
SMALL = dict(block_size=16, tile=16, frag=8, q_max=8, device="cpu")


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert a.tobytes() == b.tobytes()


def _bits_equal(a, b):
    _same(np.asarray(a).view(np.int32), np.asarray(b).view(np.int32))


def make_skewed_corpus(rng, n_docs=300, n_vocab=60):
    """Query token 0 has healthy IDF and a few spiky-tf documents — the
    score distribution block-max pruning exists for."""
    corpus = []
    for d in range(n_docs):
        base = rng.integers(1, n_vocab, size=10).astype(np.int32)
        if d % 3 == 0:
            tf0 = 20 if d % 90 == 0 else 1
            base = np.concatenate([np.zeros(tf0, np.int32), base])
        corpus.append(base)
    return corpus


def _both(corpus, n_vocab, method="lucene"):
    ref = ref_index.build_index(corpus, n_vocab,
                                params=RefParams(method=method))
    port = build_index(corpus, n_vocab, params=BM25Params(method=method))
    return ref, port


def _packed(rng, n_vocab, b=6):
    qs = [rng.integers(0, n_vocab, size=rng.integers(1, 5)).astype(np.int32)
          for _ in range(b - 1)] + [np.zeros(0, np.int32)]
    toks, wts, uniq = pad_queries(qs, 8, return_uniq=True)
    tab, w = port_csr.pack_query_batch(toks, wts, 16, uniq=uniq)
    return qs, uniq, tab, w


def _oracle(idx):
    return DeviceRetriever(idx, regime="gathered", **SMALL)


# -- host layer: byte-equal to the reference ---------------------------------

@pytest.mark.parametrize("method", ALL_VARIANTS)
@pytest.mark.parametrize("dtype", ["f32", "u8", "auto"])
def test_block_max_identical(method, dtype, rng):
    ref, port = _both(make_corpus(rng, n_docs=150, n_vocab=50, max_len=25),
                      50, method)
    a = ref_csr.build_block_max(ref, block_size=16, dtype=dtype)
    b = port_csr.build_block_max(port, block_size=16, dtype=dtype,
                                 device="cpu")
    _same(b.host, a.host)
    _same(b.scale, a.scale)
    assert (b.quantized, b.block_size, b.n_blocks, b.nb_pad,
            b.over_budget, b.nbytes) == \
        (a.quantized, a.block_size, a.n_blocks, a.nb_pad, a.over_budget,
         a.nbytes)
    _same(b.device.numpy(), np.asarray(a.device))
    _same(b.scale_dev.numpy(), np.asarray(a.scale_dev))


@pytest.mark.parametrize("method", ALL_VARIANTS)
def test_bounds_estimate_and_seed_helpers_identical(method, rng):
    ref, port = _both(make_skewed_corpus(rng), 60, method)
    qs, uniq, tab, w = _packed(rng, 60)
    for dtype in ("f32", "u8"):
        a = ref_csr.build_block_max(ref, block_size=16, dtype=dtype)
        b = port_csr.build_block_max(port, block_size=16, dtype=dtype)
        _same(port_csr.block_upper_bounds(b, tab, w),
              ref_csr.block_upper_bounds(a, tab, w))
        for k, b_true in ((1, 6), (5, 4), (40, None)):
            fa, ua = ref_csr.estimate_prune_survivors(a, tab, w, k=k,
                                                      b_true=b_true)
            fb, ub = port_csr.estimate_prune_survivors(b, tab, w, k=k,
                                                       b_true=b_true)
            assert fa == fb
            _same(ub, ua)
            fp = fragment_plan(port, uniq, block_size=16, frag=8)
            seed_a = ref_csr.select_seed_blocks(ua, fp.vis_blocks, k=k,
                                                block_size=16)
            seed_b = port_csr.select_seed_blocks(ub, fp.vis_blocks, k=k,
                                                 block_size=16)
            _same(seed_b, seed_a)
            assert port_csr.seed_block_budget(k) == \
                ref_csr.seed_block_budget(k)
            rfp = ref_csr.fragment_plan(ref, uniq, block_size=16, frag=8)
            pa = ref_csr.prune_fragment_plan(rfp, seed_a)
            pb = port_csr.prune_fragment_plan(fp, seed_b)
            _same(pb.desc, pa.desc)
            _same(pb.vis_blocks, pa.vis_blocks)
            assert (pb.n_frags, pb.sum_df) == (pa.n_frags, pa.sum_df)


def test_block_max_from_reference_serves_the_same_boards(rng):
    ref, port = _both(make_skewed_corpus(rng), 60, "bm25+")
    a = ref_csr.build_block_max(ref, block_size=16, dtype="u8")
    got = block_max_from_reference(a, device="cpu")
    own = port_csr.build_block_max(port, block_size=16, dtype="u8")
    _same(got.host, own.host)
    _same(got.scale, own.scale)
    _same(got.device.numpy(), own.host)
    assert (got.quantized, got.n_blocks, got.nb_pad, got.over_budget) == \
        (own.quantized, own.n_blocks, own.nb_pad, own.over_budget)
    qs = [np.array([0], np.int32), np.array([0, 3, 7], np.int32)]
    dr = DeviceRetriever(port, regime="pruned", **SMALL)
    before = dr.retrieve_batch(qs, 3)
    dr.dindex.bmax = got
    after = dr.retrieve_batch(qs, 3)
    _same(after.ids, before.ids)
    _bits_equal(after.scores, before.scores)


# -- device half: equal to the reference's jnp -------------------------------

@pytest.mark.parametrize("dtype", ["f32", "u8"])
def test_device_masks_and_compaction_equal_jnp(dtype, rng):
    ref, port = _both(make_skewed_corpus(rng), 60, "lucene")
    qs, uniq, tab, w = _packed(rng, 60)
    bm = port_csr.build_block_max(port, block_size=16, dtype=dtype,
                                  device="cpu")
    ub_t = port_fd.block_bounds_device(
        bm.device, bm.scale_dev, torch.as_tensor(tab), torch.as_tensor(w),
        quantized=bm.quantized)
    ub_j = np.asarray(ref_fd.block_bounds_device(
        jnp.asarray(bm.host), jnp.asarray(bm.scale), jnp.asarray(tab),
        jnp.asarray(w), quantized=bm.quantized))
    np.testing.assert_allclose(ub_t.numpy(), ub_j, rtol=0, atol=1e-6)
    # the float64 product is the host's: equal to block_upper_bounds
    _same(ub_t.numpy(), port_csr.block_upper_bounds(bm, tab, w))
    ub = ub_t.clone()
    ub[:, 5:] = -torch.inf                   # a padding column
    fp = fragment_plan(port, uniq, block_size=16, frag=8)
    desc = torch.as_tensor(fp.desc)
    for n_seed in (1, 2, 5):
        _same(port_fd.seed_fragment_mask(desc, ub, n_seed=n_seed).numpy(),
              np.asarray(ref_fd.seed_fragment_mask(
                  jnp.asarray(fp.desc), jnp.asarray(ub.numpy()),
                  n_seed=n_seed)))
    # a threshold only the best visited blocks of one column reach (+inf:
    # no block reaches it)
    tau = torch.full((ub.shape[1],), torch.inf)
    col = int(torch.argmax(ub[torch.as_tensor(fp.vis_blocks), :5].std(0)))
    tau[col] = ub[torch.as_tensor(fp.vis_blocks), col].max()
    keep = port_fd.prune_fragment_mask(desc, ub, tau)
    keep_j = np.asarray(ref_fd.prune_fragment_mask(
        jnp.asarray(fp.desc), jnp.asarray(ub.numpy()),
        jnp.asarray(tau.numpy())))
    _same(keep.numpy(), keep_j)
    got, n = port_fd.compact_fragment_table(desc, keep)
    ref_desc, ref_n = ref_fd.compact_fragment_table(jnp.asarray(fp.desc),
                                                    jnp.asarray(keep_j))
    assert n == int(ref_n) and 0 < n < fp.n_frags
    _same(got.numpy(), np.asarray(ref_desc))


def test_compaction_matches_host_prune_plan(rng):
    corpus = make_corpus(rng, n_docs=100, n_vocab=30, max_len=20)
    idx = build_index(corpus, 30, params=BM25Params())
    uniq = np.unique(rng.integers(0, 30, size=6)).astype(np.int64)
    fp = fragment_plan(idx, uniq, block_size=16, frag=8)
    blocks = np.unique(fp.desc[3, :fp.n_frags])
    keep_blocks = np.zeros(int(blocks.max()) + 1, dtype=bool)
    keep_blocks[blocks[1::2]] = True
    host = port_csr.prune_fragment_plan(fp, keep_blocks)
    mask = np.zeros(fp.nf_pad, dtype=bool)
    mask[:fp.n_frags] = keep_blocks[fp.desc[3, :fp.n_frags]]
    dev, n = port_fd.compact_fragment_table(torch.as_tensor(fp.desc),
                                            torch.as_tensor(mask))
    assert n == host.n_frags
    _same(dev.numpy()[:, :n], host.desc[:, :n])
    assert (dev.numpy()[:, n:] == 0).all()


# -- K3's twin ----------------------------------------------------------------

def _late_saturating_corpus(rng):
    """Two LOOSE decoy blocks (each token's champion a different document,
    so the block bound doubles what any one document scores) win the
    seeding and leave a weak threshold; the TIGHT winner (one document
    holding both tokens) folds early in block order, and the board then
    beats every later block's bound."""
    def filler():
        return rng.integers(5, 40, size=8).astype(np.int32)

    docs = [filler() for _ in range(23 * 16)]

    def setdoc(i, tf0=0, tf1=0):
        docs[i] = np.concatenate([np.zeros(tf0, np.int32),
                                  np.ones(tf1, np.int32), filler()])

    for b in (0, 1):                                 # loose decoy blocks
        setdoc(b * 16, tf0=25)
        setdoc(b * 16 + 1, tf1=25)
    setdoc(2 * 16, tf0=15, tf1=15)                   # tight winner, block 2
    for b in range(3, 23):                           # victim blocks
        setdoc(b * 16, tf0=4)
        setdoc(b * 16 + 1, tf1=4)
    return build_index(docs, 40, params=BM25Params())


@pytest.mark.parametrize("plan", ["host", "device"])
def test_inkernel_skip_fires_on_late_saturating_threshold(plan, rng):
    idx = _late_saturating_corpus(rng)
    q = [np.array([0, 1], np.int32)]
    i0, v0 = _oracle(idx).retrieve_batch(q, 1)
    pruned = DeviceRetriever(idx, regime="pruned", plan=plan, **SMALL)
    i1, v1 = pruned.retrieve_batch(q, 1)
    _same(i1, i0)
    _bits_equal(v1, v0)
    p = pruned.last_plan
    assert p.frags_skipped > p.frags_planned // 2, vars(p)
    assert i1[0, 0] == 2 * 16                        # the tight winner won


@pytest.mark.parametrize("method", ["robertson", "lucene", "bm25l"])
@pytest.mark.parametrize("k", [1, 7, 16])
def test_k3_twin_equals_k1_twin_in_real_columns(method, k, rng):
    """K3's twin on a table and its bounds equals K1's twin on the same
    table in every real column, and counts only real fragments."""
    idx = build_index(make_skewed_corpus(rng), 60,
                      params=BM25Params(method=method))
    di = DeviceIndex.build(idx, device="cpu", block_size=16, tile=16,
                           frag=8, with_blocked=False)
    qs, uniq, tab, w = _packed(rng, 60, b=8)
    fp = fragment_plan(idx, uniq, block_size=16, frag=8)
    ub = port_csr.block_upper_bounds(di.bmax, tab, w)
    ub[:, 6:] = -np.inf                              # two padding columns
    ops = (torch.as_tensor(fp.desc), torch.as_tensor(w), di.csc_doc_ids,
           di.csc_scores)
    kw = dict(block_size=16, k=k, n_docs=idx.n_docs)
    ref_v, ref_i = k1.bm25_resident_score_topk(*ops, frag=8, **kw)
    n0 = (k1.LAUNCHES.n, k1.LAUNCHES_PRUNED.n)
    v, i, skipped = k1.bm25_resident_score_topk_pruned(
        ops[0], ops[1], torch.as_tensor(ub), *ops[2:], frag=8,
        **kw)
    assert (k1.LAUNCHES.n, k1.LAUNCHES_PRUNED.n) == n0   # twins don't count
    _bits_equal(v[:, :6].numpy(), ref_v[:, :6].numpy())
    _same(i[:, :6].numpy(), ref_i[:, :6].numpy())
    assert 0 <= int(skipped) <= fp.n_frags


def test_k3_wrapper_rejects_bad_bounds(rng):
    idx = build_index(make_corpus(rng, n_docs=40, n_vocab=20), 20)
    di = DeviceIndex.build(idx, device="cpu", block_size=16, tile=16,
                           frag=8)
    fp = fragment_plan(idx, np.arange(5), block_size=16, frag=8)
    w = torch.ones((8, 4))
    nb = int(fp.desc[3].max()) + 1
    for bad in (torch.zeros((nb, 3)),                 # wrong column count
                torch.zeros((nb, 4), dtype=torch.float64),
                torch.zeros(nb * 4),                  # not [nb, B]
                torch.zeros((nb - 1, 4))):            # a block without a row
        with pytest.raises(ValueError, match="bounds"):
            k1.bm25_resident_score_topk_pruned(
                torch.as_tensor(fp.desc), w, bad, di.csc_doc_ids,
                di.csc_scores, block_size=16, frag=8, k=3,
                n_docs=idx.n_docs)


# -- serve: pruned boards == gathered boards ----------------------------------

@pytest.mark.parametrize("method", ALL_VARIANTS)
@pytest.mark.parametrize("bmax_dtype", ["f32", "u8"])
@pytest.mark.parametrize("plan", ["host", "device"])
def test_pruned_bitwise_equals_gathered(method, bmax_dtype, plan, rng):
    corpus = make_skewed_corpus(rng)
    idx = build_index(corpus, 60, params=BM25Params(method=method))
    oracle = _oracle(idx)
    pruned = DeviceRetriever(idx, regime="pruned", plan=plan,
                             bmax_dtype=bmax_dtype, **SMALL)
    assert pruned.dindex.bmax.quantized == (bmax_dtype == "u8")
    queries = [np.array([0], np.int32),
               rng.integers(0, 60, size=4).astype(np.int32),
               np.zeros(0, np.int32)]               # empty query in-batch
    for k in (1, 3, 9):
        i0, v0 = oracle.retrieve_batch(queries, k)
        i1, v1 = pruned.retrieve_batch(queries, k)
        _bits_equal(v1, v0)
        _same(i1, i0)
    sc = ScipyBM25(idx)
    for i, q in enumerate(queries):
        oracle_scores = sc.score(q)
        _, ref_v = topk_numpy(oracle_scores[None], 9)
        np.testing.assert_allclose(v1[i], ref_v[0], atol=1e-4)
        np.testing.assert_allclose(oracle_scores[i1[i]], v1[i], atol=1e-4)


@pytest.mark.parametrize("plan", ["host", "device"])
def test_prelaunch_compaction_fires_and_auto_picks_pruned(plan, rng):
    """The regime must PRUNE, not just match: at k=1 the seed threshold
    beats most blocks before launch, and the cost model routes the batch
    to the pruned regime on its own."""
    idx = build_index(make_skewed_corpus(rng), 60, params=BM25Params())
    q = [np.array([0], np.int32)]
    i0, v0 = _oracle(idx).retrieve_batch(q, 1)
    pruned = DeviceRetriever(idx, regime="pruned", plan=plan, **SMALL)
    i1, v1 = pruned.retrieve_batch(q, 1)
    _same(i1, i0)
    _bits_equal(v1, v0)
    p1 = pruned.last_plan
    assert p1.regime == "pruned" and p1.frags_planned > 0
    assert p1.frags_pruned > p1.frags_planned // 2
    auto = DeviceRetriever(idx, regime="auto", plan=plan, **SMALL)
    r = auto.retrieve_batch(q, 1)
    assert r.plan.regime == "pruned" and r.plan.plan == plan
    assert r.plan.survivor_frac < PRUNE_DISCOUNT
    _same(r.ids, i0)


def test_pruned_edge_cases_exact(rng):
    """Empty batch entries, df-0 tail tokens, k ≥ n_docs, and k past the
    block size (the exact unpruned resident path under the pruned
    label)."""
    corpus = make_corpus(rng, n_docs=30, n_vocab=50)
    for method in ("lucene", "robertson"):
        idx = build_index(corpus, 50, params=BM25Params(method=method))
        oracle = _oracle(idx)
        for plan in ("host", "device"):
            pruned = DeviceRetriever(idx, regime="pruned", plan=plan,
                                     **SMALL)
            for qs in ([np.zeros(0, np.int32)],
                       [np.array([48, 49], np.int32)],
                       [np.zeros(0, np.int32), np.array([1, 2], np.int32)]):
                for k in (3, 30, 64):                # 30 = n_docs, 64 > BS
                    i0, v0 = oracle.retrieve_batch(qs, k)
                    r = pruned.retrieve_batch(qs, k)
                    _bits_equal(r.scores, v0)
                    _same(r.ids, i0)
                    assert r.plan.regime == "pruned"


def test_all_nonseed_fragments_pruned(rng):
    """One block owns every winner: everything outside the seed blocks is
    compacted away and the answer still matches exactly."""
    rng_ = np.random.default_rng(5)
    corpus = []
    for d in range(200):
        base = rng_.integers(1, 40, size=8).astype(np.int32)
        if d < 4:                                    # all spikes in block 0
            base = np.concatenate([np.zeros(25, np.int32), base])
        elif d % 5 == 0:
            base = np.concatenate([np.zeros(1, np.int32), base])
        corpus.append(base)
    idx = build_index(corpus, 40, params=BM25Params())
    q = [np.array([0], np.int32)]
    i0, v0 = _oracle(idx).retrieve_batch(q, 1)
    fp = fragment_plan(idx, np.array([0], np.int64), block_size=16, frag=8)
    per_block = np.bincount(fp.desc[3, :fp.n_frags])
    for plan in ("host", "device"):
        pruned = DeviceRetriever(idx, regime="pruned", plan=plan, **SMALL)
        i1, v1 = pruned.retrieve_batch(q, 1)
        _same(i1, i0)
        _bits_equal(v1, v0)
        p = pruned.last_plan
        surv = p.frags_planned - p.frags_pruned
        assert 0 < surv <= int(np.sort(per_block)[-2:].sum())


def test_pruned_steady_state_transfers(rng):
    idx = build_index(make_skewed_corpus(rng), 60, params=BM25Params())
    qs = [np.array([0], np.int32), np.array([3, 7], np.int32)]
    host = DeviceRetriever(idx, regime="pruned", plan="host", **SMALL)
    host.retrieve_batch(qs, 3)
    reset_transfer_stats()
    host.retrieve_batch(qs, 3)
    assert TRANSFERS.posting_bytes == 0              # bounds ship as
    assert TRANSFERS.descriptor_bytes > 0            # descriptors only
    dev = DeviceRetriever(idx, regime="pruned", plan="device", **SMALL)
    dev.retrieve_batch(qs, 3)
    reset_transfer_stats()
    dev.retrieve_batch(qs, 3)
    assert TRANSFERS.posting_bytes == 0              # device plan: nothing
    assert TRANSFERS.descriptor_bytes == 0


def test_pruned_needs_its_layouts(rng):
    idx = build_index(make_corpus(rng, n_docs=30, n_vocab=20), 20)
    dr = DeviceRetriever(idx, regime="gathered", **SMALL)
    assert dr.dindex.bmax is None                    # gathered-only build
    with pytest.raises(ResidencyError):
        dr.retrieve_batch([np.array([1, 2], np.int32)], 3, regime="pruned")
    auto = DeviceRetriever(idx, regime="auto", **SMALL)
    assert auto.dindex.bmax is not None


# -- sparse: bound validity and structure -------------------------------------

@pytest.mark.parametrize("method", ["robertson", "bm25l"])
@pytest.mark.parametrize("dtype", ["f32", "u8"])
def test_block_max_bounds_dominate_scores(method, dtype, rng):
    """Σ_t w_t·bmax[t, b] really bounds every doc's raw score in b."""
    corpus = make_corpus(rng, n_docs=80, n_vocab=30, max_len=25)
    idx = build_index(corpus, 30, params=BM25Params(method=method))
    bm = port_csr.build_block_max(idx, block_size=16, dtype=dtype)
    weights = rng.random((30, 4)).astype(np.float32)
    ub = port_csr.block_upper_bounds(bm, np.arange(30), weights)
    for q in range(4):
        scores = np.zeros(idx.doc_lens.size, np.float64)
        for t in range(30):
            lo, hi = idx.indptr[t], idx.indptr[t + 1]
            scores[idx.doc_ids[lo:hi]] += weights[t, q] * idx.scores[lo:hi]
        for b in range(bm.n_blocks):
            blk_scores = scores[b * 16:(b + 1) * 16]
            if blk_scores.size:
                assert blk_scores.max() <= ub[b, q] + 1e-6


def test_planner_prices_pruned_regime():
    assert PRUNE_DISCOUNT == REF_PRUNE
    assert plan_retrieval(100, 1000).regime == "gathered"
    assert plan_retrieval(100, 150).regime == "blocked"
    p = plan_retrieval(100, 1000, survivor_frac=0.1)
    assert p.regime == "pruned" and p.survivor_frac == 0.1
    assert plan_retrieval(100, 1000,
                          survivor_frac=PRUNE_DISCOUNT).regime == "gathered"
    assert plan_retrieval(100, 20, survivor_frac=0.5).regime == "blocked"
    assert plan_retrieval(100, 20, survivor_frac=0.01).regime == "pruned"
    p = plan_retrieval(100, 1000, regime="pruned")
    assert p.regime == "pruned" and p.forced
    with pytest.raises(ValueError):
        plan_retrieval(1, 1, regime="wand")
