"""The port's recsys models against the reference's, on the CPU.

The same inputs, made from numpy seeds, go through ``repro.models`` (JAX
on the CPU, as ``tests/test_models_smoke.py`` runs it) and
``repro_torch.models``; the reference's params (``init_params`` at
``PRNGKey(0)``) come across through
``convert.recsys_params_from_reference``.

* ``models/common``: ``rms_norm`` (plain and ``plus_one``),
  ``rope_freqs``, ``apply_rope``, ``causal_window_mask``,
  ``count_params`` and ``cast_tree`` within rtol 1e-6, atol 1e-6; the
  initializers' shapes, spread, seeding and ``meta`` shapes.
* Each of the four archs at ``SMOKE``: ``forward``, ``loss_fn``'s value
  and ``retrieval_scores`` over 64 candidates within rtol 1e-5, atol
  1e-5, on histories with left pads and an all-pad row.
* Lookups: ``take_rows`` / ``lookup_fields`` and the models' item
  lookups give ``jnp.take``'s rows on out-of-range ids (NaN rows, and
  negative ids that wrap).
* The ``retrieval_cand`` cell's ``fn`` at ``SMOKE`` with 8,192
  candidates, k = 100, through K5's twin: tie-aware equal to the
  reference's cell ``fn`` (its ``blockwise_topk``, ``lax.top_k``),
  AutoInt's candidates massively tied.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as ref_get_smoke
from repro.configs.common import recsys_retrieval_cell as ref_retrieval_cell
from repro.models import common as ref_common
from repro.models import recsys as ref_recsys
from repro_torch.configs import get_smoke
from repro_torch.configs.common import recsys_retrieval_cell
from repro_torch.convert import recsys_params_from_reference
from repro_torch.kernels import ops
from repro_torch.models import common, recsys

ARCHS = ["dlrm-mlperf", "autoint", "sasrec", "mind"]
TOL = dict(rtol=1e-5, atol=1e-5)
TOL_COMMON = dict(rtol=1e-6, atol=1e-6)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _n(t):
    return t.detach().cpu().numpy()


# -- models/common ------------------------------------------------------------

@pytest.mark.parametrize("plus_one", [False, True])
def test_rms_norm_matches_reference(plus_one):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 16)).astype(np.float32)
    w = rng.normal(size=(16,)).astype(np.float32)
    ref = ref_common.rms_norm(jnp.asarray(x), jnp.asarray(w),
                              plus_one=plus_one)
    got = common.rms_norm(_t(x), _t(w), plus_one=plus_one)
    np.testing.assert_allclose(_n(got), np.asarray(ref), **TOL_COMMON)
    assert got.dtype == torch.float32


def test_rope_matches_reference():
    np.testing.assert_array_equal(common.rope_freqs(16, 10_000.0),
                                  ref_common.rope_freqs(16, 10_000.0))
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 7, 3, 16)).astype(np.float32)
    pos = np.tile(np.arange(7, dtype=np.int32) * 13, (2, 1))
    ref = ref_common.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                theta=10_000.0)
    got = common.apply_rope(_t(x), _t(pos), theta=10_000.0)
    np.testing.assert_allclose(_n(got), np.asarray(ref), **TOL_COMMON)


@pytest.mark.parametrize("window", [0, 1, 3, np.int32(4)])
def test_causal_window_mask_matches_reference(window):
    q = np.arange(5, 11, dtype=np.int32)
    k = np.arange(0, 11, dtype=np.int32)
    ref = ref_common.causal_window_mask(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(window))
    got = common.causal_window_mask(_t(q), _t(k), _t(window))
    np.testing.assert_array_equal(_n(got), np.asarray(ref))
    got_int = common.causal_window_mask(_t(q), _t(k), int(window))
    np.testing.assert_array_equal(_n(got_int), np.asarray(ref))


@pytest.mark.parametrize("arch", ARCHS)
def test_count_params_and_cast_tree_match_reference(arch):
    cfg = ref_get_smoke(arch)
    ref_p = jax.device_get(ref_recsys.init_params(jax.random.PRNGKey(0),
                                                  cfg))
    p = recsys_params_from_reference(ref_p, device="cpu")
    assert common.count_params(p) == ref_common.count_params(ref_p)
    # the port's own init gives the reference's shapes
    own = recsys.init_params(torch.Generator().manual_seed(0),
                             get_smoke(arch), device="cpu")
    assert common.count_params(own) == ref_common.count_params(ref_p)
    half = common.cast_tree(p, torch.float16)
    ref_half = ref_common.cast_tree(ref_p, jnp.float16)
    for a, b in zip(common.tree_leaves(half), jax.tree.leaves(ref_half)):
        assert a.dtype == torch.float16
        np.testing.assert_allclose(_n(a).astype(np.float32),
                                   np.asarray(b, np.float32), **TOL_COMMON)
    ints = common.cast_tree({"i": torch.arange(3)}, torch.float16)
    assert ints["i"].dtype == torch.int64


def test_initializers_draw_from_their_generator():
    g = torch.Generator().manual_seed(3)
    a = common.normal_init(g, (4000,), 0.5)
    b = common.normal_init(torch.Generator().manual_seed(3), (4000,), 0.5)
    assert torch.equal(a, b) and a.dtype == torch.float32
    assert abs(float(a.std()) - 0.5) < 0.05
    u = common.uniform_init(torch.Generator().manual_seed(4), (4000,), 0.25)
    assert float(u.min()) >= -0.25 and float(u.max()) <= 0.25
    assert float(u.max()) > 0.2 and float(u.min()) < -0.2
    ks = common.split_keys(torch.Generator().manual_seed(5), 3)
    ks2 = common.split_keys(torch.Generator().manual_seed(5), 3)
    draws = [common.normal_init(k, (8,), 1.0) for k in ks]
    assert all(torch.equal(d, common.normal_init(k, (8,), 1.0))
               for d, k in zip(draws, ks2))
    assert not torch.equal(draws[0], draws[1])
    m = common.normal_init(torch.Generator(), (3, 5), 1.0, device="meta")
    assert m.device.type == "meta" and m.shape == (3, 5)
    m = common.uniform_init(torch.Generator(), (2,), 1.0, device="meta")
    assert m.device.type == "meta" and m.shape == (2,)


def test_init_params_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    from repro_torch.serve.errors import ResidencyError
    with pytest.raises(ResidencyError):
        recsys.init_params(torch.Generator(), get_smoke("mind"))
    with pytest.raises(ResidencyError):
        recsys_params_from_reference({"w": np.zeros(2, np.float32)})


# -- the four archs at SMOKE ---------------------------------------------------

def _history(rng, b, l, v):
    """Item ids in [1, v) with left pads on some rows, and one all-pad
    row (the last)."""
    h = rng.integers(1, v, size=(b, l)).astype(np.int32)
    for r in range(0, b - 1, 3):
        h[r, :rng.integers(1, l)] = 0
    h[-1] = 0
    return h


def make_batch(cfg, rng, b, *, labels=True):
    if cfg.model in ("dlrm", "autoint"):
        batch = {"sparse": np.stack(
            [rng.integers(0, v, size=b) for v in cfg.vocab_sizes],
            axis=1).astype(np.int32)}
        if cfg.n_dense:
            batch["dense"] = rng.normal(size=(b, cfg.n_dense)).astype(
                np.float32)
        if labels:
            batch["labels"] = rng.integers(0, 2, size=b).astype(np.int32)
        return batch
    v = cfg.vocab_sizes[0]
    shape = (b, cfg.seq_len) if cfg.model == "sasrec" else (b,)
    pos = rng.integers(1, v, size=shape).astype(np.int32)
    if cfg.model == "sasrec":
        pos[0, :2] = 0                    # pads among the targets
    return {"history": _history(rng, b, cfg.seq_len, v), "pos_items": pos,
            "neg_items": rng.integers(1, v, size=shape).astype(np.int32)}


@pytest.fixture(scope="module", params=ARCHS)
def arch_case(request):
    arch = request.param
    cfg, ref_cfg = get_smoke(arch), ref_get_smoke(arch)
    ref_p = ref_recsys.init_params(jax.random.PRNGKey(0), ref_cfg)
    p = recsys_params_from_reference(jax.device_get(ref_p), device="cpu")
    return arch, cfg, ref_cfg, ref_p, p


def test_params_carry_across(arch_case):
    _, _, _, ref_p, p = arch_case
    ref_leaves = jax.tree.leaves(ref_p)
    leaves = common.tree_leaves(p)
    assert len(leaves) == len(ref_leaves)
    for a, b in zip(leaves, ref_leaves):
        assert a.dtype == torch.float32 and a.device.type == "cpu"
        np.testing.assert_array_equal(_n(a), np.asarray(b))
    assert jax.tree.structure(ref_p) == jax.tree.structure(
        common.tree_map(lambda x: 0, p))


def test_forward_and_loss_match_reference(arch_case):
    arch, cfg, ref_cfg, ref_p, p = arch_case
    rng = np.random.default_rng(11)
    batch = make_batch(cfg, rng, 9)
    ref_logits = ref_recsys.forward(ref_cfg, ref_p,
                                    jax.tree.map(jnp.asarray, batch))
    tb = {k: _t(v) for k, v in batch.items()}
    logits = recsys.forward(cfg, p, tb)
    assert tuple(logits.shape) == ref_logits.shape
    assert bool(torch.isfinite(logits).all())
    np.testing.assert_allclose(_n(logits), np.asarray(ref_logits), **TOL)
    ref_loss, ref_aux = ref_recsys.loss_fn(ref_cfg, ref_p,
                                           jax.tree.map(jnp.asarray, batch))
    loss, aux = recsys.loss_fn(cfg, p, tb)
    assert loss.shape == () and set(aux) == set(ref_aux) == {"loss"}
    np.testing.assert_allclose(float(loss), float(ref_loss), **TOL)


def test_retrieval_scores_match_reference(arch_case):
    arch, cfg, ref_cfg, ref_p, p = arch_case
    rng = np.random.default_rng(12)
    batch = make_batch(cfg, rng, 2, labels=False)
    one = {k: v[:1] for k, v in batch.items()}
    cands = np.arange(1, 65, dtype=np.int32)
    ref = ref_recsys.retrieval_scores(
        ref_cfg, ref_p, jax.tree.map(jnp.asarray, one), jnp.asarray(cands))
    got = recsys.retrieval_scores(cfg, p, {k: _t(v) for k, v in one.items()},
                                  _t(cands))
    assert tuple(got.shape) == ref.shape == (1, 64)
    np.testing.assert_allclose(_n(got), np.asarray(ref), **TOL)
    # two users at once: the CTR broadcast and the sequence models' rows
    ref2 = ref_recsys.retrieval_scores(
        ref_cfg, ref_p, jax.tree.map(jnp.asarray, batch), jnp.asarray(cands))
    got2 = recsys.retrieval_scores(
        cfg, p, {k: _t(v) for k, v in batch.items()}, _t(cands))
    np.testing.assert_allclose(_n(got2), np.asarray(ref2), **TOL)
    # the caller's batch is not written (the CTR path sets field 0 on a copy)
    if "sparse" in one:
        sp = _t(one["sparse"]).clone()
        recsys.retrieval_scores(cfg, p, {**{k: _t(v) for k, v in one.items()},
                                         "sparse": sp}, _t(cands))
        assert torch.equal(sp, _t(one["sparse"]))


def test_all_pad_history_is_uniform_not_nan():
    """SASRec's -1e30 masks: an all-pad row gives the reference's finite
    hidden state (a uniform softmax), not NaN."""
    cfg, ref_cfg = get_smoke("sasrec"), ref_get_smoke("sasrec")
    ref_p = ref_recsys.init_params(jax.random.PRNGKey(0), ref_cfg)
    p = recsys_params_from_reference(jax.device_get(ref_p), device="cpu")
    hist = np.zeros((2, cfg.seq_len), np.int32)
    hist[1, -3:] = [5, 6, 7]
    ref = ref_recsys.sasrec_hidden(ref_cfg, ref_p, jnp.asarray(hist))
    got = recsys.sasrec_hidden(cfg, p, _t(hist))
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(_n(got), np.asarray(ref), **TOL)


# -- jnp.take's out-of-range rule ----------------------------------------------

def test_take_rows_matches_jnp_take():
    table = np.arange(8, dtype=np.float32).reshape(4, 2) + 1.0
    ids = np.array([5, -1, -7, -4, 4, 0, 3, -5], np.int32)
    ref = np.asarray(jnp.take(jnp.asarray(table), jnp.asarray(ids), axis=0))
    got = _n(recsys.take_rows(_t(table), _t(ids)))
    np.testing.assert_array_equal(got, ref)         # NaN rows where ref has
    assert np.isnan(got[[0, 2, 4, 7]]).all()
    np.testing.assert_array_equal(got[1], table[3])  # -1 wraps
    np.testing.assert_array_equal(got[3], table[0])  # -4 wraps
    ids2 = ids.reshape(2, 4)
    np.testing.assert_array_equal(
        _n(recsys.take_rows(_t(table), _t(ids2))),
        np.asarray(jnp.take(jnp.asarray(table), jnp.asarray(ids2), axis=0)))


def test_lookup_fields_matches_reference_out_of_range():
    table = np.arange(20, dtype=np.float32).reshape(10, 2)
    offsets = np.array([0, 4, 7], np.int32)
    idx = np.array([[0, 0, 0], [3, -5, 2], [-1, 2, 3], [-11, 9, 1]],
                   np.int32)
    ref = ref_recsys.lookup_fields(jnp.asarray(table), jnp.asarray(offsets),
                                   jnp.asarray(idx))
    got = recsys.lookup_fields(_t(table), _t(offsets), _t(idx))
    np.testing.assert_array_equal(_n(got), np.asarray(ref))


@pytest.mark.parametrize("arch", ARCHS)
def test_out_of_range_ids_give_the_reference_rows(arch):
    """Whole models on ids past their tables and below zero: the same
    NaN entries and the same wrapped rows as the reference."""
    cfg, ref_cfg = get_smoke(arch), ref_get_smoke(arch)
    ref_p = ref_recsys.init_params(jax.random.PRNGKey(0), ref_cfg)
    p = recsys_params_from_reference(jax.device_get(ref_p), device="cpu")
    rng = np.random.default_rng(13)
    batch = make_batch(cfg, rng, 4, labels=False)
    if "sparse" in batch:
        rows = p["table"].shape[0]
        batch["sparse"][0, 0] = rows + 5          # past the table: NaN
        batch["sparse"][1, 1] = -1 - cfg.field_offsets()[1]   # wraps
        batch["sparse"][2, 2] = -rows - 3 - cfg.field_offsets()[2]
    else:
        rows = p["item_emb"].shape[0]
        batch["history"][0, -1] = rows + 1
        batch["history"][1, -2] = -1
        batch["pos_items"][(2,) if cfg.model == "mind" else (2, 0)] = -rows
        batch["neg_items"][(3,) if cfg.model == "mind" else (3, 1)] = -rows - 1
    ref = ref_recsys.forward(ref_cfg, ref_p, jax.tree.map(jnp.asarray, batch))
    got = recsys.forward(cfg, p, {k: _t(v) for k, v in batch.items()})
    ref = np.asarray(ref)
    assert np.isnan(ref).any() and not np.isnan(ref).all()
    np.testing.assert_array_equal(np.isnan(_n(got)), np.isnan(ref))
    np.testing.assert_allclose(_n(got), ref, equal_nan=True, **TOL)


# -- the retrieval cell through K5's twin --------------------------------------

def _candidates(cfg, rng, n):
    """Uniform in field 0's vocabulary (CTR models: AutoInt's 64 values
    tie massively) or in the item ids [1, v] (with repeats: ties)."""
    if cfg.model in ("dlrm", "autoint"):
        return rng.integers(0, cfg.vocab_sizes[0], size=n).astype(np.int32)
    return rng.integers(1, cfg.vocab_sizes[0] + 1, size=n).astype(np.int32)


def _tie_aware(ids, vals, ref_ids, ref_vals, scores, ref_scores):
    """Values position by position, and every id carrying its own score
    on both sides (tied candidates may come in either order)."""
    np.testing.assert_allclose(vals, ref_vals, **TOL)
    np.testing.assert_allclose(ref_scores[ids], vals, **TOL)
    np.testing.assert_allclose(scores[ref_ids], ref_vals, **TOL)
    assert len(set(ids.tolist())) == len(ids)


@pytest.mark.parametrize("arch", ARCHS)
def test_retrieval_cell_matches_reference(arch, monkeypatch):
    n_cand, k = 8192, 100
    cfg, ref_cfg = get_smoke(arch), ref_get_smoke(arch)
    ref_p = ref_recsys.init_params(jax.random.PRNGKey(0), ref_cfg)
    p = recsys_params_from_reference(jax.device_get(ref_p), device="cpu")
    rng = np.random.default_rng(14)
    one = make_batch(cfg, rng, 1, labels=False)
    cands = _candidates(cfg, rng, n_cand)

    calls = []
    k5 = ops.blockwise_topk

    def spy(*a, **kw):
        calls.append(a[0].shape)
        return k5(*a, **kw)
    monkeypatch.setattr(ops, "blockwise_topk", spy)

    cell = recsys_retrieval_cell(arch, cfg, n_candidates=n_cand, k=k)
    fn, (params_s, batch_s, cand_s) = cell.build(None)
    assert tuple(cand_s.shape) == (n_cand,)
    assert {key: tuple(v.shape) for key, v in batch_s.items()} == {
        key: v.shape for key, v in one.items()}
    tb = {key: _t(v) for key, v in one.items()}
    idx, vals = fn(p, tb, _t(cands))
    assert calls == [(1, n_cand)]                    # K5's twin, once
    assert idx.dtype == torch.int32 and tuple(idx.shape) == (1, k)

    ref_cell = ref_retrieval_cell(arch, ref_cfg, n_candidates=n_cand, k=k)
    ref_fn, _ = ref_cell.build(None)
    ref_idx, ref_vals = ref_fn(ref_p, jax.tree.map(jnp.asarray, one),
                               jnp.asarray(cands))
    scores = _n(recsys.retrieval_scores(cfg, p, tb, _t(cands)))[0]
    ref_scores = np.asarray(ref_recsys.retrieval_scores(
        ref_cfg, ref_p, jax.tree.map(jnp.asarray, one),
        jnp.asarray(cands)))[0]
    _tie_aware(_n(idx)[0], _n(vals)[0], np.asarray(ref_idx)[0],
               np.asarray(ref_vals)[0], scores, ref_scores)
    # the port's board is its scores' (value desc, index asc) order
    order = np.lexsort((np.arange(n_cand), -scores))[:k]
    np.testing.assert_array_equal(_n(idx)[0], order)
    if arch == "autoint":
        assert len(np.unique(scores)) < n_cand // 16          # 64 values
        assert len(np.unique(_n(vals)[0])) < k // 10          # heavy ties
