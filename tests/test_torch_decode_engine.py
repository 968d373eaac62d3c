"""The port's LM decode engine against the reference's, on the CPU.

* ``decode_step_ragged`` at mixed positions (one past the 16-token window,
  so its ring wraps) and an active mask, over a cache filled with noise,
  so an inactive row must write back what it held: logits and every
  layer's k and v within rtol/atol 1e-5, updated in place.
* ``DecodeEngine`` on the reference's two scenarios
  (``tests/test_serving.py``: continuous batching of five requests
  through two slots, and one request against a greedy lockstep decode):
  the port's ``finished`` dict equals the reference's, id for id, with
  the reference's params carried across.
* R3 (ROADMAP §3): the port's engine and ragged step refuse a
  ``kv_quant`` config with ``ValueError``; over one, the reference's
  ragged step (its engine's step) disagrees with its own lockstep int8
  decode of the same prompt by more than the int8 decode differs from the
  unquantized one, and drops the scales from the cache it returns.
* ``DecodeEngine`` defaults to cuda and raises ``ResidencyError``
  without one; ``repro_torch.serve`` exports it.
"""

import functools
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as rt
from repro.serve.decode_engine import DecodeEngine as RefEngine
from repro.serve.decode_engine import decode_step_ragged as ref_ragged
from repro_torch.convert import lm_params_from_reference
from repro_torch.models import transformer as pt
from repro_torch.models.transformer import LMConfig
from repro_torch.serve import DecodeEngine
from repro_torch.serve.decode_engine import decode_step_ragged

TOL = dict(rtol=1e-5, atol=1e-5)
# the reference's scenarios (tests/test_serving.py)
CFG = dict(name="t", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
           d_ff=64, vocab_size=61, head_dim=8, seq_chunk=8, loss_chunk=8)


def _cfgs(**kw):
    return (rt.LMConfig(**CFG, dtype=jnp.float32, **kw),
            LMConfig(**CFG, dtype=torch.float32, **kw))


def _params(ref_cfg, seed):
    ref = jax.device_get(rt.init_params(jax.random.PRNGKey(seed), ref_cfg))
    return ref, lm_params_from_reference(ref, device="cpu")


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_decode_step_ragged_matches_reference(moe):
    extra = dict(sliding_window=16, global_every=2)
    if moe:
        extra.update(n_experts=4, moe_group_seq=1)
    ref_cfg, cfg = _cfgs(**extra)
    ref_p, p = _params(ref_cfg, 2)
    b, max_seq = 4, 24
    rng = np.random.default_rng(0)
    ref_cache = jax.device_get(rt.init_decode_cache(ref_cfg, b, max_seq))
    for key in ("k", "v"):
        ref_cache[key] = [rng.normal(size=a.shape).astype(np.float32)
                          for a in ref_cache[key]]
    cache = {"k": [torch.tensor(a) for a in ref_cache["k"]],
             "v": [torch.tensor(a) for a in ref_cache["v"]],
             "pos": torch.tensor(int(ref_cache["pos"]))}
    held = [t.clone() for t in cache["k"] + cache["v"]]
    tensors = cache["k"] + cache["v"]
    pos = np.array([0, 5, 17, 23], np.int32)       # 17, 23: the ring wraps
    active = np.array([True, False, True, True])
    toks = np.array([3, 9, 60, 41], np.int32)
    logits, out = jax.jit(functools.partial(ref_ragged, ref_cfg))(
        ref_p, jax.tree.map(jnp.asarray, ref_cache), jnp.asarray(toks),
        jnp.asarray(pos), jnp.asarray(active))
    got, gout = decode_step_ragged(cfg, p, cache, torch.as_tensor(toks),
                                   torch.as_tensor(pos),
                                   torch.as_tensor(active))
    np.testing.assert_allclose(got.numpy(), np.asarray(logits), **TOL)
    assert all(a is b for a, b in zip(gout["k"] + gout["v"], tensors))
    assert int(gout["pos"]) == int(out["pos"]) == max_seq
    for key in ("k", "v"):
        for a, r in zip(gout[key], out[key]):
            np.testing.assert_allclose(a.numpy(), np.asarray(r), **TOL)
    # the inactive row and every slot not written hold what they held
    for t, h in zip(tensors, held):
        s_i = t.shape[1]
        changed = (t != h).any(dim=-1).any(dim=-1)      # [B, S]
        written = torch.zeros_like(changed)
        for r in np.flatnonzero(active):
            written[r, pos[r] % s_i] = True
        assert not bool((changed & ~written).any())


def test_engine_continuous_batching_matches_reference():
    ref_cfg, cfg = _cfgs(sliding_window=16)
    ref_p, p = _params(ref_cfg, 0)
    ref_eng = RefEngine(ref_cfg, ref_p, n_slots=2, max_seq=32)
    eng = DecodeEngine(cfg, p, n_slots=2, max_seq=32, device="cpu")
    reqs = [([1 + i, 2 + i], 3 + i) for i in range(5)]
    rids = [eng.submit(pr, max_new=m) for pr, m in reqs]
    ref_rids = [ref_eng.submit(pr, max_new=m) for pr, m in reqs]
    out = eng.run_until_done()
    ref_out = ref_eng.run_until_done()
    assert rids == ref_rids and set(out) == set(rids)
    for i, rid in enumerate(rids):
        assert len(out[rid]) == 3 + i
    assert out == ref_out


def test_engine_matches_reference_and_lockstep():
    ref_cfg, cfg = _cfgs()
    ref_p, p = _params(ref_cfg, 1)
    prompt = [5, 9, 11]
    ref_eng = RefEngine(ref_cfg, ref_p, n_slots=1, max_seq=32)
    eng = DecodeEngine(cfg, p, n_slots=1, max_seq=32, device="cpu")
    ref_rid = ref_eng.submit(prompt, max_new=5)
    want = ref_eng.run_until_done()[ref_rid]
    rid = eng.submit(prompt, max_new=5)
    got = eng.run_until_done()[rid]
    assert got == want
    # the port's own lockstep decode gives the same ids
    cache = pt.init_decode_cache(cfg, 1, 32, device="cpu")
    cache["pos"] = torch.tensor(0, dtype=torch.int32)
    toks, ref = list(prompt), []
    for t in range(len(prompt) + 4):
        tok = torch.tensor([toks[t]], dtype=torch.int32)
        logits, cache = pt.decode_step(cfg, p, cache, tok)
        if t >= len(prompt) - 1:
            ref.append(int(torch.argmax(logits[0])))
            if t + 1 >= len(toks):
                toks.append(ref[-1])
    assert got == ref


def test_kv_quant_is_refused_r3():
    _, cfg = _cfgs(kv_quant=True)
    p = pt.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    with pytest.raises(ValueError, match="R3"):
        DecodeEngine(cfg, p, n_slots=1, max_seq=8, device="cpu")
    cache = pt.init_decode_cache(cfg, 1, 8, device="cpu")
    with pytest.raises(ValueError, match="R3"):
        decode_step_ragged(cfg, p, cache, torch.tensor([1]),
                           torch.tensor([0]), torch.tensor([True]))


def test_reference_engine_over_kv_quant_decodes_garbage_r3():
    """R3 shown, not only asserted: the reference's ragged step casts the
    unquantized k and v to int8 and reads them back without scales, so
    its engine disagrees with its own lockstep int8 decode of the same
    request, and the cache it returns has lost its scales."""
    ref_cfg, _ = _cfgs(kv_quant=True)
    ref_p = rt.init_params(jax.random.PRNGKey(1), ref_cfg)
    prompt = [5, 9, 11]
    cache = rt.init_decode_cache(ref_cfg, 1, 32)
    cache["pos"] = jnp.asarray(0, jnp.int32)
    lock_logits = []
    step = jax.jit(functools.partial(rt.decode_step, ref_cfg))
    for t in prompt:
        logits, cache = step(ref_p, cache, jnp.asarray([t], jnp.int32))
        lock_logits.append(np.asarray(logits[0]))
    rcache = rt.init_decode_cache(ref_cfg, 1, 32)
    rag_logits = []
    ragged = jax.jit(functools.partial(ref_ragged, ref_cfg))
    for i, t in enumerate(prompt):
        logits, rcache = ragged(ref_p, rcache, jnp.asarray([t], jnp.int32),
                                jnp.asarray([i], jnp.int32),
                                jnp.asarray([True]))
        rag_logits.append(np.asarray(logits[0]))
        assert "k_scale" not in rcache and "v_scale" not in rcache
    diff = max(np.abs(a - b).max() for a, b in zip(rag_logits, lock_logits))
    assert diff > 0.1, diff
    # the lockstep int8 decode itself is close to the unquantized one
    plain_cfg = replace(ref_cfg, kv_quant=False)
    cache = rt.init_decode_cache(plain_cfg, 1, 32)
    cache["pos"] = jnp.asarray(0, jnp.int32)
    step = jax.jit(functools.partial(rt.decode_step, plain_cfg))
    for t, q in zip(prompt, lock_logits):
        logits, cache = step(ref_p, cache, jnp.asarray([t], jnp.int32))
        assert np.abs(np.asarray(logits[0]) - q).max() < diff
    eng = RefEngine(ref_cfg, ref_p, n_slots=1, max_seq=32)
    rid = eng.submit(prompt, max_new=4)
    got = eng.run_until_done()[rid]
    assert len(got) == 4


def test_engine_defaults_to_cuda_and_is_exported():
    import repro_torch.serve as serve
    assert serve.DecodeEngine is DecodeEngine and "DecodeEngine" in \
        serve.__all__
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    from repro_torch.serve.errors import ResidencyError
    _, cfg = _cfgs()
    with pytest.raises(ResidencyError):
        DecodeEngine(cfg, {}, n_slots=1, max_seq=8)
