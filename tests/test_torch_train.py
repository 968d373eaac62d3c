"""The port's training stack against ``repro.train``, on the CPU.

The same inputs, made from numpy seeds, go through the reference (JAX on
the CPU) and the port (torch on the CPU):

* the seven tests of ``tests/test_train_stack.py`` (AdamW on a quadratic,
  the cosine schedule, clipping, microbatches = the full batch, int8
  compression tracking f32 on a tiny LM, the checkpoint round trip with
  its truncation fallback, the loop's resume and retry), each also
  against the reference's run on the same inputs where it has one;
* ``AdamW.update`` (clipping on and off, a schedule and a constant lr,
  weight decay), ``clip_by_global_norm``, ``global_norm``,
  ``cosine_schedule`` and ``compress_grads`` on the same grads within
  rtol 1e-6 / atol 1e-7 (f32), ``quantize_int8``'s codes equal (round
  half to even on exact halves);
* a step that raises midway (in a microbatch's loss, in the optimizer)
  leaves the params and the optimizer state bitwise as they were, and a
  step never writes into what it was given;
* checkpoints cross between the packages: one written by the reference
  for an LM smoke's ``(params, opt_state)`` loads in the port (through
  ``convert`` where the layouts differ), and the port's next step
  matches the reference's; one written by the port passes the
  reference's ``latest_complete_step`` and loads there bit for bit.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.train as rtrain
from repro.data.lm import lm_batches
from repro.models import transformer as rt
from repro.train import checkpoint as rckpt
from repro.train import grad_compress as rgc
from repro.train import optimizer as ropt
from repro.train.loop import LoopConfig as RLoopConfig
from repro.train.loop import run_training as r_run_training
from repro_torch.convert import (lm_params_from_reference,
                                 train_state_from_reference)
from repro_torch.models import transformer as pt
from repro_torch.models.common import tree_map, tree_paths
from repro_torch.train import (AdamW, cosine_schedule, init_train_state,
                               make_train_step)
from repro_torch.train import grad_compress as gc
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.checkpoint import (_is_complete,
                                          latest_complete_step,
                                          load_checkpoint, save_checkpoint)
from repro_torch.train.loop import LoopConfig, run_training

TOL = dict(rtol=1e-6, atol=1e-7)


def _n(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _t(tree):
    return tree_map(lambda a: torch.as_tensor(np.array(a)), tree)


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _close_trees(got, want, **tol):
    g, w = tree_paths(got), tree_paths(jax.device_get(want))
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        np.testing.assert_allclose(_n(a), np.asarray(b), err_msg=str(path),
                                   **(tol or TOL))


def _bits_equal(a, b) -> bool:
    pa, pb = tree_paths(a), tree_paths(b)
    return [p for p, _ in pa] == [p for p, _ in pb] and all(
        x.dtype == y.dtype and torch.equal(x, y)
        for (_, x), (_, y) in zip(pa, pb))


def _clone(tree):
    return tree_map(lambda x: x.clone(), tree)


def _quadratic_loss(params, batch):
    err = params["w"] - batch["target"]
    return torch.sum(err * err), {}


def _r_quadratic_loss(params, batch):
    err = params["w"] - batch["target"]
    return jnp.sum(err * err), {}


# -- tests/test_train_stack.py's seven, each beside the reference ------------

def test_adamw_minimizes_quadratic():
    params = {"w": torch.ones((8,)) * 5.0}
    opt = AdamW(lr=0.2, weight_decay=0.0)
    step = make_train_step(_quadratic_loss, opt)
    state = init_train_state(params, opt)
    batch = {"target": torch.zeros((8,))}
    ropt_ = rtrain.AdamW(lr=0.2, weight_decay=0.0)
    rstep = jax.jit(rtrain.make_train_step(_r_quadratic_loss, ropt_))
    rp = {"w": jnp.ones((8,)) * 5.0}
    rs = rtrain.init_train_state(rp, ropt_)
    for _ in range(100):
        params, state, m = step(params, state, batch)
        rp, rs, rm = rstep(rp, rs, {"target": jnp.zeros((8,))})
    assert float(params["w"].abs().max()) < 0.1
    _close_trees(params, rp, rtol=1e-4, atol=1e-6)
    assert int(state["step"]) == int(rs["step"]) == 100
    assert state["step"].dtype == torch.int32 and state["step"].dim() == 0


def test_cosine_schedule_shape():
    lr = cosine_schedule(peak_lr=1.0, warmup_steps=10, total_steps=100)
    assert float(lr(torch.tensor(0))) < 0.2
    assert float(lr(torch.tensor(10))) == pytest.approx(1.0, abs=0.1)
    assert float(lr(torch.tensor(100))) == pytest.approx(0.1, abs=0.02)


def test_grad_clipping_bounds_update():
    params = {"w": torch.zeros((4,))}
    opt = AdamW(lr=1.0, clip_norm=1e-3, weight_decay=0.0)
    step = make_train_step(_quadratic_loss, opt)
    state = init_train_state(params, opt)
    _, _, m = step(params, state, {"target": torch.ones((4,)) * 1e6})
    assert float(m["grad_norm"]) > 1.0   # pre-clip norm reported
    ropt_ = rtrain.AdamW(lr=1.0, clip_norm=1e-3, weight_decay=0.0)
    rstep = rtrain.make_train_step(_r_quadratic_loss, ropt_)
    rp = {"w": jnp.zeros((4,))}
    _, _, rm = rstep(rp, rtrain.init_train_state(rp, ropt_),
                     {"target": jnp.ones((4,)) * 1e6})
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(_n(m[k]), np.asarray(rm[k]), **TOL)


def _linear_loss(params, batch):
    pred = batch["x"] @ params["w"]
    return torch.mean((pred - batch["y"]) ** 2), {}


def test_microbatch_equals_full_batch():
    """Grad accumulation over M microbatches == one big batch (linear
    loss), and each M equals the reference's step with the same M."""
    def r_loss(params, batch):
        pred = batch["x"] @ params["w"]
        return jnp.mean((pred - batch["y"]) ** 2), {}

    rng = np.random.default_rng(0)
    w = rng.normal(size=(4,)).astype(np.float32)
    x = rng.normal(size=(16, 4)).astype(np.float32)
    y = rng.normal(size=(16,)).astype(np.float32)
    opt = AdamW(lr=0.01, weight_decay=0.0, clip_norm=None)
    ropt_ = rtrain.AdamW(lr=0.01, weight_decay=0.0, clip_norm=None)
    outs = {}
    for m in (1, 4):
        params = {"w": torch.as_tensor(w)}
        step = make_train_step(_linear_loss, opt, n_microbatches=m)
        p, _, met = step(params, init_train_state(params, opt),
                         {"x": torch.as_tensor(x), "y": torch.as_tensor(y)})
        outs[m] = _n(p["w"])
        rp = {"w": jnp.asarray(w)}
        rstep = jax.jit(rtrain.make_train_step(r_loss, ropt_,
                                               n_microbatches=m))
        rp2, _, rm = rstep(rp, rtrain.init_train_state(rp, ropt_),
                           {"x": jnp.asarray(x), "y": jnp.asarray(y)})
        np.testing.assert_allclose(outs[m], np.asarray(rp2["w"]), **TOL)
        np.testing.assert_allclose(_n(met["loss"]), np.asarray(rm["loss"]),
                                   **TOL)
    # microbatch mean-of-means == full mean for equal-size microbatches
    np.testing.assert_allclose(outs[1], outs[4], rtol=1e-5, atol=1e-6)


TINY_LM = dict(name="t", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
               d_ff=64, vocab_size=64, head_dim=8, seq_chunk=16,
               loss_chunk=16)


def test_int8_compression_tracks_fp32():
    """Compressed training converges to the same loss region on a tiny LM,
    and follows the reference's compressed run."""
    cfg = pt.LMConfig(**TINY_LM, dtype=torch.float32)
    rcfg = rt.LMConfig(**TINY_LM, dtype=jnp.float32)
    ref_p0 = rt.init_params(jax.random.PRNGKey(0), rcfg)
    params0 = lm_params_from_reference(jax.device_get(ref_p0), device="cpu")
    opt = AdamW(lr=1e-2)
    gen = lm_batches(vocab_size=64, batch=8, seq_len=16, seed=0)
    batches = [next(gen) for _ in range(25)]
    finals = {}
    for compress in (False, True):
        step = make_train_step(functools.partial(pt.loss_fn, cfg), opt,
                               compress=compress)
        params = _clone(params0)
        state = init_train_state(params, opt, compress=compress)
        losses = []
        for b in batches:
            params, state, m = step(params, state, _t(b))
            losses.append(float(m["loss"]))
        finals[compress] = losses
    assert finals[True][-1] < 0.8 * finals[True][0]          # it learns
    assert abs(finals[True][-1] - finals[False][-1]) < \
        0.15 * finals[False][-1]                             # tracks fp32
    # the reference's compressed run on the same params and batches
    ropt_ = rtrain.AdamW(lr=1e-2)
    rstep = jax.jit(rtrain.make_train_step(
        functools.partial(rt.loss_fn, rcfg), ropt_, compress=True))
    rp, rs = ref_p0, rtrain.init_train_state(ref_p0, ropt_, compress=True)
    rlosses = []
    for b in batches[:5]:
        rp, rs, rm = rstep(rp, rs, _j(b))
        rlosses.append(float(rm["loss"]))
    np.testing.assert_allclose(finals[True][:5], rlosses, rtol=1e-4)


def test_checkpoint_roundtrip_and_corruption_fallback(tmp_path):
    state = ({"w": torch.arange(4.0)}, {"m": torch.ones((2, 2))})
    d = str(tmp_path)
    save_checkpoint(d, 10, state)
    save_checkpoint(d, 20, state)
    assert latest_complete_step(d) == 20
    # corrupt newest: truncate the data file
    f = os.path.join(d, "step_000020", "host_000.npz")
    with open(f, "r+b") as fh:
        fh.truncate(10)
    assert latest_complete_step(d) == 10                     # falls back
    assert rckpt.latest_complete_step(d) == 10               # so does repro's
    assert not _is_complete(os.path.join(d, "step_000020"))
    restored = load_checkpoint(d, 10, state)
    np.testing.assert_array_equal(_n(restored[0]["w"]), np.arange(4.0))
    assert restored[1]["m"].dtype == torch.float32
    # a .tmp directory (a write cut before its rename) is never a step
    os.makedirs(os.path.join(d, "step_000030.tmp"))
    assert latest_complete_step(d) == 10
    assert latest_complete_step(str(tmp_path / "absent")) is None


def test_loop_auto_resume_and_fault_retry(tmp_path):
    params = {"w": torch.ones((4,)) * 3.0}
    opt = AdamW(lr=0.1, weight_decay=0.0)
    step = make_train_step(_quadratic_loss, opt)
    batches = iter(lambda: {"target": torch.zeros((4,))}, None)

    faults = {"n": 0}

    def fault_hook(s):
        if s == 7 and faults["n"] < 1:       # one transient failure at step 7
            faults["n"] += 1
            raise RuntimeError("injected preemption")

    seen = []
    cfg = LoopConfig(total_steps=10, ckpt_every=4, ckpt_dir=str(tmp_path),
                     metrics_cb=lambda s, m: seen.append(s),
                     fault_hook=fault_hook, log_every=1)
    state = init_train_state(params, opt)
    p1, s1 = run_training(step, (params, state), batches, cfg)
    assert faults["n"] == 1                  # fault happened and was retried
    assert latest_complete_step(str(tmp_path)) == 10
    assert sorted(os.listdir(tmp_path)) == ["step_000004", "step_000008",
                                            "step_000010"]
    # resume: raising total_steps continues from step 10, not 0
    cfg2 = LoopConfig(total_steps=12, ckpt_every=4, ckpt_dir=str(tmp_path),
                      metrics_cb=lambda s, m: seen.append(s), log_every=1)
    run_training(step, (params, state), batches, cfg2)
    assert min(s for s in seen if s > 10) == 11   # continued, didn't restart
    # the reference's loop on the same problem ends at the same params
    ropt_ = rtrain.AdamW(lr=0.1, weight_decay=0.0)
    rstep = jax.jit(rtrain.make_train_step(_r_quadratic_loss, ropt_))
    rp = {"w": jnp.ones((4,)) * 3.0}
    rbatches = iter(lambda: {"target": jnp.zeros((4,))}, None)
    rp1, _ = r_run_training(rstep, (rp, rtrain.init_train_state(rp, ropt_)),
                            rbatches, RLoopConfig(total_steps=10))
    _close_trees(p1, rp1, rtol=1e-5, atol=1e-6)


def test_loop_gives_up_after_its_retries(tmp_path):
    params = {"w": torch.ones((4,))}
    opt = AdamW(lr=0.1)
    calls = []

    def hook(s):
        calls.append(s)
        raise RuntimeError("down")

    cfg = LoopConfig(total_steps=3, fault_hook=hook, max_step_retries=2)
    with pytest.raises(RuntimeError, match="down"):
        run_training(make_train_step(_quadratic_loss, opt),
                     (params, init_train_state(params, opt)),
                     iter(lambda: {"target": torch.zeros(4)}, None), cfg)
    assert calls == [0, 0, 0]


# -- a step that raises leaves its inputs as they were ----------------------

@pytest.mark.parametrize("where", ["loss", "optimizer", "compress"])
@pytest.mark.parametrize("m", [1, 2])
def test_a_step_that_raises_midway_changes_nothing(where, m):
    cfg = pt.LMConfig(**TINY_LM, dtype=torch.float32)
    gen = torch.Generator().manual_seed(3)
    params = pt.init_params(gen, cfg, device="cpu")
    batch = _t(next(lm_batches(vocab_size=64, batch=4, seq_len=16, seed=1)))
    opt = AdamW(lr=cosine_schedule(peak_lr=1e-2, warmup_steps=2,
                                   total_steps=10))
    step = make_train_step(functools.partial(pt.loss_fn, cfg), opt,
                           n_microbatches=m, compress=True)
    state = init_train_state(params, opt, compress=True)
    # one good step first, so the moments, step and residual are not zero
    params, state, _ = step(params, state, batch)
    before = (_clone(params), _clone(state), _clone(batch))
    calls = {"n": 0}

    def loss_fn(p, b):
        calls["n"] += 1
        if where == "loss" and calls["n"] == m:    # the last microbatch
            raise RuntimeError("fault in the loss")
        return pt.loss_fn(cfg, p, b)

    class BadOpt(AdamW):
        def update(self, grads, st, p):
            out = super().update(grads, st, p)
            raise RuntimeError("fault in the optimizer")
            return out                              # noqa

    bad = make_train_step(loss_fn, BadOpt(lr=opt.lr) if where == "optimizer"
                          else opt, n_microbatches=m, compress=True)
    if where == "compress":
        state["ef"]["embed"] = torch.zeros(3, 5)   # a shape that fails
        before[1]["ef"]["embed"] = state["ef"]["embed"]
    with pytest.raises(RuntimeError):
        bad(params, state, batch)
    assert _bits_equal(params, before[0])
    assert _bits_equal(state, before[1])
    assert _bits_equal(batch, before[2])
    # and a step that succeeds writes into nothing either
    if where == "loss":
        step(params, state, batch)
        assert _bits_equal(params, before[0])
        assert _bits_equal(state, before[1])


# -- optimizer and compression against the reference -------------------------

def _grad_tree(rng, scale=1.0):
    return {"a": (rng.normal(size=(5, 3)) * scale).astype(np.float32),
            "b": [rng.normal(size=(7,)).astype(np.float32) * scale,
                  {"c": rng.normal(size=(2, 2, 2)).astype(np.float32)}],
            "z": np.zeros((3,), np.float32)}


@pytest.mark.parametrize("clip", [None, 1.0, 1e-3])
@pytest.mark.parametrize("sched", [False, True])
def test_adamw_update_matches_reference(clip, sched):
    rng = np.random.default_rng(7)
    params = _grad_tree(rng)
    lr = (dict(peak_lr=0.05, warmup_steps=3, total_steps=20) if sched
          else 0.05)
    opt = AdamW(lr=cosine_schedule(**lr) if sched else lr, clip_norm=clip,
                weight_decay=0.1)
    ropt_ = rtrain.AdamW(lr=ropt.cosine_schedule(**lr) if sched else lr,
                         clip_norm=clip, weight_decay=0.1)
    p, rp = _t(params), _j(params)
    st, rst = opt.init(p), ropt_.init(rp)
    for i in range(6):
        g = _grad_tree(rng, scale=10.0 ** (i % 3 - 1))
        p, st, m = opt.update(_t(g), st, p)
        rp, rst, rm = jax.jit(ropt_.update)(_j(g), rst, rp)
        _close_trees(p, rp)
        _close_trees(st["m"], rst["m"])
        _close_trees(st["v"], rst["v"])
        assert int(st["step"]) == int(rst["step"]) == i + 1
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(_n(m[k]), np.asarray(rm[k]), **TOL)


def test_clip_global_norm_and_schedule_match_reference():
    rng = np.random.default_rng(8)
    g = _grad_tree(rng, scale=3.0)
    for max_norm in (1e-3, 1.0, 1e6):
        got, n = opt_mod.clip_by_global_norm(_t(g), max_norm)
        want, rn = ropt.clip_by_global_norm(_j(g), max_norm)
        _close_trees(got, want)
        np.testing.assert_allclose(_n(n), np.asarray(rn), **TOL)
    np.testing.assert_allclose(_n(opt_mod.global_norm(_t(g))),
                               np.asarray(ropt.global_norm(_j(g))), **TOL)
    for kw in (dict(peak_lr=3e-4, warmup_steps=100, total_steps=10_000),
               dict(peak_lr=1.0, warmup_steps=0, total_steps=50,
                    min_ratio=0.0)):
        lr, rlr = cosine_schedule(**kw), ropt.cosine_schedule(**kw)
        steps = np.array([0, 1, 5, 99, 100, 101, 5_000, 10_000, 20_000],
                         np.int32)
        np.testing.assert_allclose(_n(lr(torch.as_tensor(steps))),
                                   np.asarray(rlr(jnp.asarray(steps))),
                                   **TOL)


def test_compress_grads_and_int8_codes_match_reference():
    rng = np.random.default_rng(9)
    g = _grad_tree(rng)
    ef = _t(jax.device_get(rgc.init_error_feedback(_j(g))))
    ref_ef = rgc.init_error_feedback(_j(g))
    for i in range(4):
        g = _grad_tree(rng, scale=10.0 ** (i - 2))
        deq, ef = gc.compress_grads(_t(g), ef)
        rdeq, ref_ef = rgc.compress_grads(_j(g), ref_ef)
        _close_trees(deq, rdeq)
        _close_trees(ef, ref_ef)
    # the codes, exact halves among them (round half to even)
    x = np.array([0.5, 1.5, 2.5, -0.5, -2.5, 127.0, -127.0, 63.5, 0.0],
                 np.float32)
    for arr in (x, rng.normal(size=1000).astype(np.float32),
                np.zeros(4, np.float32)):
        q, s = gc.quantize_int8(torch.as_tensor(arr))
        rq, rs = rgc.quantize_int8(jnp.asarray(arr))
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(_n(q), np.asarray(rq))
        assert _n(s) == np.asarray(rs)
        np.testing.assert_array_equal(
            _n(gc.dequantize_int8(q, s)),
            np.asarray(rgc.dequantize_int8(rq, rs)))


# -- checkpoints cross between the packages -----------------------------------

SMOKE_LM = "gemma3-1b"


def _smoke_lm():
    import repro.configs as ref_configs
    from repro_torch import configs
    return configs.get_smoke(SMOKE_LM), ref_configs.get_smoke(SMOKE_LM)


def test_reference_checkpoint_loads_and_steps_in_the_port(tmp_path):
    cfg, rcfg = _smoke_lm()
    rp = rt.init_params(jax.random.PRNGKey(0), rcfg)
    ropt_ = rtrain.AdamW(lr=1e-2)
    rstep = jax.jit(rtrain.make_train_step(functools.partial(rt.loss_fn,
                                                             rcfg), ropt_))
    gen = lm_batches(vocab_size=rcfg.vocab_size, batch=2, seq_len=16, seed=4)
    b0, b1 = next(gen), next(gen)
    rs = rtrain.init_train_state(rp, ropt_)
    rp, rs, _ = rstep(rp, rs, _j(b0))                 # moments not zero
    d = str(tmp_path)
    rckpt.save_checkpoint(d, 1, (rp, rs))
    assert latest_complete_step(d) == 1
    like = (lm_params_from_reference(jax.device_get(rp), device="cpu"),
            train_state_from_reference(jax.device_get(rs), device="cpu"))
    params, state = load_checkpoint(d, 1, like)
    assert _bits_equal(params, like[0]) and _bits_equal(state, like[1])
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 1
    step = make_train_step(functools.partial(pt.loss_fn, cfg),
                           AdamW(lr=1e-2))
    p2, s2, m = step(params, state, _t(b1))
    rp2, rs2, rm = rstep(rp, rs, _j(b1))
    np.testing.assert_allclose(_n(m["loss"]), np.asarray(rm["loss"]),
                               rtol=1e-5)
    _close_trees(p2, rp2, rtol=0, atol=1e-5)
    _close_trees(s2["m"], rs2["m"], rtol=1e-4, atol=1e-7)


def test_port_checkpoint_passes_the_reference(tmp_path):
    cfg, rcfg = _smoke_lm()
    params = pt.init_params(torch.Generator().manual_seed(1), cfg,
                            device="cpu")
    opt = AdamW(lr=1e-2)
    state = init_train_state(params, opt, compress=True)
    step = make_train_step(functools.partial(pt.loss_fn, cfg), opt,
                           compress=True)
    b = _t(next(lm_batches(vocab_size=cfg.vocab_size, batch=2, seq_len=16)))
    params, state, _ = step(params, state, b)
    d = str(tmp_path)
    save_checkpoint(d, 7, (params, state))
    assert rckpt.latest_complete_step(d) == 7
    ref_like = (rt.init_params(jax.random.PRNGKey(0), rcfg),
                rtrain.init_train_state(
                    rt.init_params(jax.random.PRNGKey(0), rcfg),
                    rtrain.AdamW(), compress=True))
    got = rckpt.load_checkpoint(d, 7, ref_like)
    _close_trees(params, got[0], rtol=0, atol=0)
    _close_trees(state, got[1], rtol=0, atol=0)
    assert np.asarray(got[1]["step"]).dtype == np.int32
