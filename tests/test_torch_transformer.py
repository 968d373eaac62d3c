"""The port's LM transformer against the reference's, on the CPU.

The same inputs, made from numpy seeds, go through ``repro.models.
transformer`` (JAX on the CPU, as ``tests/test_models_smoke.py`` runs it;
``decode_step`` jitted once a config) and ``repro_torch.models.
transformer``; the reference's params (``init_params`` at
``PRNGKey(0)``) come across through ``convert.lm_params_from_reference``.

* Each of the five LM archs at ``SMOKE`` (f32), within rtol 1e-5, atol
  1e-5: ``forward`` (hidden and aux) and ``loss_fn``'s value (two loss
  and attention chunks, an ignored label); ``prefill`` (logits, the
  layer-stacked K and V, ``pos``); six ``decode_step``s from the cells'
  ``pos = S`` over a 20-position cache, so the 16-token windows' rings and
  the global layers' wrap, with ``kv_quant`` off and on (int8 values
  within one step, scales within the tolerance).
* The same at ``SMOKE`` with ``dtype=bfloat16`` (bf16 params, bf16
  cache; mixtral-8x22b's SMOKE is mixtral-8x7b's but for its name, so
  four archs), each tensor within ``BF16_REL`` = 2^-5 of its largest entry
  (8 bf16 ulps there): the two packages round bf16 products and
  elementwise ops at different points (XLA's CPU dots and fusions,
  torch's f32 opmath), one ulp (2^-8 relative) at a time, and the layers
  carry those roundings on. The largest seen is 0.0138 (the hidden
  states), 2.3× inside. The int8 caches of the bf16 runs are compared
  dequantized, the same way.
* ``chunked_attention`` with no window, windows of 1, 5 and 7 (a numpy
  int) and a ``seq_chunk`` that must halve (24 queries, chunk 16 → 8).
* ``moe_block`` with a capacity factor small enough that tokens are
  dropped and a router whose experts tie in pairs (``lax.top_k`` takes the
  lower index), and ``moe_route``'s drops against a count in numpy.
* ``_kv_quantize`` / ``_kv_dequant`` bitwise, exact halves (round half to
  even) and all-zero rows included.
* The embedding gather on ids 5, -1, -7, -4, 0 and 3 of a 4-row table,
  against the reference's plain index (negative ids wrap, then clamp),
  alone and through ``forward``.
* ``init_params`` on ``meta``: the reference's shapes and dtypes; the
  decode cache's shapes, dtypes and ``pos``; ``reduced``.
"""

import functools
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
from repro.models import transformer as rt
from repro_torch import configs
from repro_torch.convert import lm_params_from_reference
from repro_torch.models import transformer as pt

ARCHS = ["gemma3-1b", "h2o-danube3-4b", "qwen3-8b", "mixtral-8x7b",
         "mixtral-8x22b"]
# mixtral-8x22b's SMOKE is mixtral-8x7b's but for its name
# (test_reduced_and_layer_tables_equal_the_reference), so the bf16 runs
# take the four distinct ones
BF16_ARCHS = ARCHS[:4]
CASES = [(a, False) for a in ARCHS] + [(a, True) for a in BF16_ARCHS]
IDS = [f"{a}-{'bf16' if b else 'f32'}" for a, b in CASES]
TOL = dict(rtol=1e-5, atol=1e-5)
BF16_REL = 2.0 ** -5                   # see the module docstring
B, S, CACHE, STEPS = 2, 32, 20, 6


def _n(t):
    return t.detach().float().cpu().numpy() if torch.is_tensor(t) \
        else np.asarray(jnp.asarray(t, jnp.float32))


def _close(got, want, bf16=False, what=""):
    """Within ``TOL`` (f32), or within ``BF16_REL`` of the largest entry
    of ``want`` (bf16)."""
    if not bf16:
        np.testing.assert_allclose(_n(got), _n(want), err_msg=what, **TOL)
        return
    g, w = _n(got), _n(want)
    assert g.shape == w.shape, what
    err, top = np.abs(g - w).max(initial=0.0), np.abs(w).max(initial=0.0)
    assert err <= BF16_REL * top + 1e-6, (what, err, top)


@functools.lru_cache(maxsize=None)
def _cfgs(arch, bf16=False):
    ref, port = ref_configs.get_smoke(arch), configs.get_smoke(arch)
    if bf16:
        ref, port = (replace(ref, dtype=jnp.bfloat16),
                     replace(port, dtype=torch.bfloat16))
    return ref, port


@functools.lru_cache(maxsize=None)
def _ref_params(cfg):
    return jax.device_get(rt.init_params(jax.random.PRNGKey(0), cfg))


@functools.lru_cache(maxsize=None)
def _params(arch, bf16=False):
    """The reference's f32 params (cast to bf16 for ``bf16``) and the
    port's copy. Drawn once a config: the two Mixtral SMOKEs differ only
    in their names, which ``init_params`` does not read."""
    ref = _ref_params(replace(_cfgs(arch)[0], name="smoke"))
    if bf16:
        ref = jax.tree.map(lambda x: np.asarray(x).astype(jnp.bfloat16), ref)
    return ref, lm_params_from_reference(ref, device="cpu")


@functools.lru_cache(maxsize=None)
def _ref_decode(cfg):
    return jax.jit(functools.partial(rt.decode_step, cfg))


def _tokens(cfg, seed, shape):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=shape).astype(np.int32)


# -- whole model, f32 and bf16 ------------------------------------------------

@pytest.mark.parametrize("arch,bf16", CASES, ids=IDS)
def test_forward_and_loss_match_reference(arch, bf16):
    ref_cfg, cfg = _cfgs(arch, bf16)
    ref_p, p = _params(arch, bf16)
    toks = _tokens(cfg, 1, (B, S))
    labels = np.roll(toks, -1, axis=1)
    labels[0, 5] = -1                                   # ignored
    hid, aux = rt.forward(ref_cfg, ref_p, jnp.asarray(toks))
    got_hid, got_aux = pt.forward(cfg, p, torch.as_tensor(toks))
    assert got_hid.dtype == cfg.dtype and tuple(got_hid.shape) == hid.shape
    _close(got_hid, hid, bf16, "hidden")
    _close(got_aux, aux, bf16, "aux")
    batch = {"tokens": toks, "labels": labels}
    loss, m = rt.loss_fn(ref_cfg, ref_p, {k: jnp.asarray(v)
                                          for k, v in batch.items()})
    got, gm = pt.loss_fn(cfg, p, {k: torch.as_tensor(v)
                                  for k, v in batch.items()})
    _close(got, loss, bf16, "loss")
    for key in ("ce", "aux", "n_tokens"):
        _close(gm[key], m[key], bf16, key)
    assert float(gm["n_tokens"]) == B * S - 1


@pytest.mark.parametrize("arch,bf16", CASES, ids=IDS)
def test_prefill_matches_reference(arch, bf16):
    ref_cfg, cfg = _cfgs(arch, bf16)
    ref_p, p = _params(arch, bf16)
    toks = _tokens(cfg, 2, (B, S))
    logits, cache = rt.prefill(ref_cfg, ref_p, jnp.asarray(toks))
    got, gc = pt.prefill(cfg, p, torch.as_tensor(toks))
    assert got.dtype == torch.float32
    _close(got, logits, bf16, "logits")
    for key in ("k", "v"):
        assert tuple(gc[key].shape) == cache[key].shape == (
            cfg.n_layers, B, S, cfg.n_kv_heads, cfg.hd)
        assert gc[key].dtype == cfg.dtype
        _close(gc[key], cache[key], bf16, key)
    assert int(gc["pos"]) == int(cache["pos"]) == S


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf", "int8"])
@pytest.mark.parametrize("arch,bf16", CASES, ids=IDS)
def test_decode_steps_match_reference(arch, bf16, kv_quant):
    ref_cfg, cfg = _cfgs(arch, bf16)
    ref_cfg = replace(ref_cfg, kv_quant=kv_quant)
    cfg = replace(cfg, kv_quant=kv_quant)
    ref_p, p = _params(arch, bf16)
    step = _ref_decode(ref_cfg)
    ref_cache = rt.init_decode_cache(ref_cfg, B, CACHE)
    cache = pt.init_decode_cache(cfg, B, CACHE, device="cpu")
    tensors = cache["k"] + cache["v"]
    toks = _tokens(cfg, 3, (STEPS, B))
    for t in range(STEPS):
        logits, ref_cache = step(ref_p, ref_cache, jnp.asarray(toks[t]))
        got, cache = pt.decode_step(cfg, p, cache, torch.as_tensor(toks[t]))
        _close(got, logits, bf16, f"logits at step {t}")
    # updated in place: the same tensors come back
    assert all(a is b for a, b in zip(cache["k"] + cache["v"], tensors))
    assert int(cache["pos"]) == int(ref_cache["pos"]) == CACHE + STEPS
    keys = ("k", "v", "k_scale", "v_scale") if kv_quant else ("k", "v")
    for key in keys:
        for i, (a, b) in enumerate(zip(cache[key], ref_cache[key])):
            assert tuple(a.shape) == b.shape, (key, i)
            if a.dtype == torch.int8:
                assert b.dtype == jnp.int8
                if bf16:
                    sk = key[0] + "_scale"
                    _close(pt._kv_dequant(a, cache[sk][i]),
                           rt._kv_dequant(b, ref_cache[sk][i]), bf16,
                           f"{key}[{i}]")
                    continue
                # a rounding boundary may fall either side of 1e-6
                diff = np.abs(_n(a) - np.asarray(b, np.float32))
                assert diff.max() <= 1, (key, i)
            else:
                _close(a, b, bf16, f"{key}[{i}]")


# -- attention ---------------------------------------------------------------

@pytest.mark.parametrize("window", [0, 1, 5, np.int32(7)])
def test_chunked_attention_matches_reference(window):
    rng = np.random.default_rng(4)
    q = rng.normal(size=(2, 24, 4, 8)).astype(np.float32)
    k = rng.normal(size=(2, 24, 2, 8)).astype(np.float32)
    v = rng.normal(size=(2, 24, 2, 8)).astype(np.float32)
    pos = np.arange(24, dtype=np.int32) + 3
    ref = rt.chunked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               jnp.asarray(pos), jnp.asarray(pos),
                               jnp.asarray(window), seq_chunk=16)
    t = torch.as_tensor
    got = pt.chunked_attention(t(q), t(k), t(v), t(pos), t(pos), window,
                               seq_chunk=16)
    _close(got, ref)
    got_t = pt.chunked_attention(t(q), t(k), t(v), t(pos), t(pos),
                                 torch.tensor(int(window)), seq_chunk=16)
    _close(got_t, ref)


def test_rope_dyn_matches_reference():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 7, 3, 16)).astype(np.float32)
    pos = np.arange(7, dtype=np.int32) * 11
    for theta in (10_000.0, 1_000_000.0):
        ref = rt._rope_dyn(jnp.asarray(x), jnp.asarray(pos),
                           jnp.asarray(theta, jnp.float32))
        _close(pt._rope_dyn(torch.as_tensor(x), torch.as_tensor(pos), theta),
               ref)


# -- MoE ---------------------------------------------------------------------

def _moe_case(tie: bool, capacity_factor: float):
    ref_cfg, cfg = _cfgs("mixtral-8x7b")
    ref_cfg = replace(ref_cfg, capacity_factor=capacity_factor)
    cfg = replace(cfg, capacity_factor=capacity_factor)
    ref_p, _ = _params("mixtral-8x7b")
    lp = {k: np.array(v[0]) for k, v in ref_p["layers"].items()}
    if tie:
        # experts tie in pairs: 0 with 1, 2 with 3
        lp["router"][:, 1] = lp["router"][:, 0]
        lp["router"][:, 3] = lp["router"][:, 2]
    x = np.random.default_rng(6).normal(
        size=(2, 32, cfg.d_model)).astype(np.float32)
    return ref_cfg, cfg, lp, x


@pytest.mark.parametrize("tie", [False, True], ids=["plain", "ties"])
@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_moe_block_matches_reference_with_drops_and_ties(tie,
                                                         capacity_factor):
    ref_cfg, cfg, lp, x = _moe_case(tie, capacity_factor)
    y, aux = rt.moe_block(ref_cfg, {k: jnp.asarray(v) for k, v in lp.items()},
                          jnp.asarray(x))
    got, got_aux = pt.moe_block(cfg, {k: torch.as_tensor(v)
                                      for k, v in lp.items()},
                                torch.as_tensor(x))
    _close(got, y)
    _close(got_aux, aux)
    # the route, against a count in numpy: lower index first on ties,
    # ranks in (token, choice) order, the sentinel for every drop
    g_seq = cfg.moe_group_seq
    xg = torch.as_tensor(x).reshape(-1, g_seq, cfg.d_model)
    logits = (xg @ torch.as_tensor(lp["router"])).float()
    cap = pt.moe_capacity(cfg, g_seq)
    probs, _, idx, keep, slot = pt.moe_route(cfg, logits, cap)
    e = cfg.n_experts
    for g in range(xg.shape[0]):
        order = np.argsort(-probs[g].numpy(), axis=-1, kind="stable")
        np.testing.assert_array_equal(idx[g].numpy(), order[:, :2])
        seen = np.zeros(e, int)
        for a, ex in enumerate(order[:, :2].reshape(-1)):
            assert bool(keep[g, a]) == (seen[ex] < cap)
            assert int(slot[g, a]) == (ex * cap + seen[ex] if seen[ex] < cap
                                       else e * cap)
            seen[ex] += 1
    if capacity_factor < 1:
        assert not bool(keep.all())                     # tokens were dropped
    if tie:
        assert bool((idx[..., 0] % 2 == 0).all())       # the lower of a pair


# -- int8 KV -----------------------------------------------------------------

def test_kv_quantize_bitwise_with_halves():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(3, 1, 2, 16)).astype(np.float32) * 3
    # a row whose scale is 1.0: x / scale lands on exact halves
    x[0, 0, 0] = [127.0, 2.5, -3.5, 0.5, -0.5, 1.5, -2.5, 126.5,
                  -126.5, 4.5, 0.0, -0.0, 5.5, -5.5, 6.5, 7.5]
    x[1, 0, 1] = 0.0                                    # the 1e-8 floor
    q, s = rt._kv_quantize(jnp.asarray(x))
    got_q, got_s = pt._kv_quantize(torch.as_tensor(x))
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(q))
    np.testing.assert_array_equal(got_s.numpy().view(np.uint32),
                                  np.asarray(s).view(np.uint32))
    assert got_q[0, 0, 0, :10].tolist() == [127, 2, -4, 0, 0, 2, -2, 126,
                                            -126, 4]
    dq = rt._kv_dequant(q, s)
    got_dq = pt._kv_dequant(got_q, got_s)
    np.testing.assert_array_equal(got_dq.numpy().view(np.uint32),
                                  np.asarray(dq).view(np.uint32))


# -- the embedding gather ----------------------------------------------------

def test_embedding_gather_wraps_then_clamps_as_the_reference():
    table = np.arange(12, dtype=np.float32).reshape(4, 3)
    ids = np.array([[5, -1, -7, -4, 0, 3]], np.int32)
    ref = jnp.asarray(table).astype(jnp.float32)[jnp.asarray(ids)]
    cfg = replace(configs.get_smoke("qwen3-8b"), d_model=3)
    got = pt._embed(cfg, {"embed": torch.as_tensor(table)},
                    torch.as_tensor(ids))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert got[0, :, 0].tolist() == [9.0, 9.0, 0.0, 0.0, 0.0, 9.0]
    # through the model: out-of-range ids at both ends
    ref_cfg, cfg = _cfgs("gemma3-1b")
    ref_p, p = _params("gemma3-1b")
    toks = np.array([[cfg.vocab_size + 3, -1, -cfg.vocab_size - 5, 7]],
                    np.int32)
    # jnp params: a numpy table would index as numpy does, and raise
    hid, _ = rt.forward(ref_cfg, jax.tree.map(jnp.asarray, ref_p),
                        jnp.asarray(toks))
    got_hid, _ = pt.forward(cfg, p, torch.as_tensor(toks))
    _close(got_hid, hid)


# -- shapes ------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_and_cache_shapes_match_reference(arch):
    ref_cfg = ref_configs.get_config(arch)
    cfg = configs.get_config(arch)
    ref = jax.eval_shape(functools.partial(rt.init_params, cfg=ref_cfg),
                         jax.random.PRNGKey(0))
    got = pt.init_params(torch.Generator(), cfg, device="meta")
    want = {jax.tree_util.keystr(k): x
            for k, x in jax.tree_util.tree_leaves_with_path(ref)}
    have = {f"['{k}']": v for k, v in got.items() if k != "layers"}
    have.update({f"['layers']['{k}']": v for k, v in got["layers"].items()})
    assert set(have) == set(want)
    for key, x in have.items():
        assert x.device.type == "meta"
        assert tuple(x.shape) == want[key].shape, key
        assert x.dtype == torch.float32 and want[key].dtype == jnp.float32
    assert pt.decode_cache_shapes(cfg, 3, 5000) == \
        rt.decode_cache_shapes(ref_cfg, 3, 5000)
    for kvq in (False, True):
        c = pt.init_decode_cache(replace(cfg, kv_quant=kvq), 2, 64,
                                 device="meta")
        r = jax.eval_shape(lambda: rt.init_decode_cache(
            replace(ref_cfg, kv_quant=kvq), 2, 64))
        assert set(c) == set(r)
        for key in set(c) - {"pos"}:
            assert [tuple(a.shape) for a in c[key]] == [a.shape
                                                        for a in r[key]]
            assert {str(a.dtype).split(".")[-1] for a in c[key]} == \
                {str(a.dtype) for a in r[key]}
    assert int(pt.init_decode_cache(cfg, 1, 64, device="cpu")["pos"]) == 64


def test_reduced_and_layer_tables_equal_the_reference():
    for arch in ARCHS:
        cfg, ref = configs.get_config(arch), ref_configs.get_config(arch)
        np.testing.assert_array_equal(cfg.layer_windows(),
                                      ref.layer_windows())
        np.testing.assert_array_equal(cfg.layer_thetas(), ref.layer_thetas())
        assert (cfg.hd, cfg.is_moe) == (ref.hd, ref.is_moe)
        small = pt.reduced(cfg, n_layers=1)
        assert small.n_layers == 1 and small.dtype == torch.float32
    g = configs.get_config("gemma3-1b")
    assert list(np.flatnonzero(g.layer_windows() == 0)) == [5, 11, 17, 23]
    assert replace(configs.get_smoke("mixtral-8x22b"), name="x") == \
        replace(configs.get_smoke("mixtral-8x7b"), name="x")


def test_entry_points_default_to_cuda():
    """Without a GPU the entry points that make tensors raise
    ``ResidencyError`` instead of running on the host."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    from repro_torch.serve.errors import ResidencyError
    cfg = configs.get_smoke("gemma3-1b")
    with pytest.raises(ResidencyError):
        pt.init_params(torch.Generator(), cfg)
    with pytest.raises(ResidencyError):
        pt.init_decode_cache(cfg, 1, 8)
    with pytest.raises(ResidencyError):
        lm_params_from_reference({"embed": np.zeros((2, 2), np.float32)})
