"""Shared parity checks of a family's training path against the reference.

Imported by ``test_torch_train_lm.py``, ``test_torch_train_recsys.py``
and ``test_torch_egnn.py``.

At f32 ``reduced`` configs on the CPU: the LM family at gemma3-1b's and
mixtral-8x7b's smokes (local and global attention, and the MoE dispatch
with dropped tokens), the four recsys archs, and EGNN with node and graph
readouts over edge lists with padding edges. The reference's params come
across through ``convert``; the batches are made from numpy seeds.

* ``jax.value_and_grad`` of the reference's ``loss_fn`` against the
  port's ``train.step.value_and_grad``: the loss within rtol 1e-5, every
  grad leaf within rtol 1e-4 and atol 1e-6 · max |g| of the leaf.
* One whole ``make_train_step`` (M = 1 and 2, ``compress`` off and on)
  against the reference's step: the loss within rtol 1e-5, the first
  moments within the grads' tolerance, and the params within atol 1e-5
  wherever the step's grad is held to a sign (see ``check_step``).
* The port's step leaves the params it is given unchanged.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro.configs as ref_configs
import repro.train as rtrain
from repro.data.graphs import batched_molecules, random_graph
from repro.models import egnn as re
from repro.models import recsys as rr
from repro.models import transformer as rt
from repro_torch import configs
from repro_torch.convert import (egnn_params_from_reference,
                                 lm_params_from_reference,
                                 recsys_params_from_reference)
from repro_torch.models import egnn as pe
from repro_torch.models import recsys as pr
from repro_torch.models import transformer as pt
from repro_torch.models.common import tree_map, tree_paths
from repro_torch.train import AdamW, init_train_state, make_train_step
from repro_torch.train.step import value_and_grad

LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL_REL = 1e-4, 1e-6
PARAM_ATOL = 1e-5
STEP_LR = 1e-3                 # the recsys and GNN cells' AdamW

ALL_CASES = ["lm:gemma3-1b", "lm:mixtral-8x7b", "recsys:dlrm-mlperf",
         "recsys:autoint", "recsys:sasrec", "recsys:mind", "egnn:node",
         "egnn:graph"]


def _egnn_batch(rng, readout):
    """A graph with 10 padding edges appended (node readout: some labels
    -1), or 6 molecules with padding edges (graph readout)."""
    if readout == "graph":
        b = batched_molecules(6, n_nodes=10, n_edges=16, seed=3)
        b.pop("n_graphs")
    else:
        g = random_graph(40, 4, d_feat=8, n_classes=3, seed=2)
        labels = g.labels.astype(np.int32)
        labels[::4] = -1
        b = {"node_feat": g.node_feat, "coords": g.coords,
             "edges": g.edges.astype(np.int32), "labels": labels}
    b["edges"] = np.concatenate(
        [b["edges"], np.full((10, 2), -1, np.int32)])
    return b


def _recsys_batch(cfg, rng, b=12):
    if cfg.model in ("dlrm", "autoint"):
        out = {"sparse": np.stack(
            [rng.integers(0, v, size=b) for v in cfg.vocab_sizes],
            axis=1).astype(np.int32),
            "labels": rng.integers(0, 2, size=b).astype(np.int32)}
        if cfg.n_dense:
            out["dense"] = rng.normal(size=(b, cfg.n_dense)).astype(
                np.float32)
        return out
    v = cfg.vocab_sizes[0]
    hist = rng.integers(1, v, size=(b, cfg.seq_len)).astype(np.int32)
    hist[0, :3] = 0                        # a left pad
    hist[1, :] = rng.integers(1, 4, size=cfg.seq_len)  # repeated items
    shape = (b, cfg.seq_len) if cfg.model == "sasrec" else (b,)
    pos = rng.integers(1, v, size=shape).astype(np.int32)
    if cfg.model == "sasrec":
        pos[0, :2] = 0
    return {"history": hist, "pos_items": pos,
            "neg_items": rng.integers(1, v, size=shape).astype(np.int32)}


@functools.lru_cache(maxsize=None)
def _case(case):
    """(port loss_fn, reference loss_fn, port params, reference params,
    numpy batch, static extras) of one case."""
    fam, name = case.split(":")
    rng = np.random.default_rng(len(case))
    if fam == "lm":
        cfg, rcfg = configs.get_smoke(name), ref_configs.get_smoke(name)
        rp = rt.init_params(jax.random.PRNGKey(0), rcfg)
        p = lm_params_from_reference(jax.device_get(rp), device="cpu")
        toks = rng.integers(0, cfg.vocab_size, size=(4, 32)).astype(np.int32)
        labels = np.roll(toks, -1, 1)
        labels[:, -1] = -1
        labels[1, :5] = -1
        batch = {"tokens": toks, "labels": labels}
        return (functools.partial(pt.loss_fn, cfg),
                functools.partial(rt.loss_fn, rcfg), p, rp, batch, {})
    if fam == "recsys":
        cfg, rcfg = configs.get_smoke(name), ref_configs.get_smoke(name)
        rp = rr.init_params(jax.random.PRNGKey(0), rcfg)
        p = recsys_params_from_reference(jax.device_get(rp), device="cpu")
        return (functools.partial(pr.loss_fn, cfg),
                functools.partial(rr.loss_fn, rcfg), p, rp,
                _recsys_batch(cfg, rng), {})
    graph = name == "graph"
    kw = dict(n_layers=2, d_hidden=16, d_feat=11 if graph else 8,
              n_out=1 if graph else 3, readout=name)
    cfg = pe.EGNNConfig(name="e", **kw)
    rcfg = re.EGNNConfig(name="e", **kw)
    rp = re.init_params(jax.random.PRNGKey(0), rcfg)
    p = egnn_params_from_reference(jax.device_get(rp), device="cpu")
    extra = {"n_graphs": 6} if graph else {}
    return (functools.partial(pe.loss_fn, cfg),
            functools.partial(re.loss_fn, rcfg), p, rp,
            _egnn_batch(rng, name), extra)


def _t(batch, extra):
    return dict({k: torch.as_tensor(v) for k, v in batch.items()}, **extra)


def _j(batch, extra):
    return dict({k: jnp.asarray(v) for k, v in batch.items()}, **extra)


def _pairs(got, want):
    g, w = tree_paths(got), tree_paths(jax.device_get(want))
    assert [p for p, _ in g] == [p for p, _ in w]
    return [(p, a.detach().numpy(), np.asarray(b))
            for (p, a), (_, b) in zip(g, w)]


def check_grads(case):
    """The loss within ``LOSS_RTOL``, every grad leaf within
    ``GRAD_RTOL`` and ``GRAD_ATOL_REL`` · max |g| of the reference's."""
    loss_fn, r_loss_fn, p, rp, batch, extra = _case(case)
    (loss, _), grads = value_and_grad(loss_fn, p, _t(batch, extra))
    (rloss, _), rgrads = jax.value_and_grad(
        lambda q: r_loss_fn(q, _j(batch, extra)), has_aux=True)(rp)
    np.testing.assert_allclose(loss.numpy(), np.asarray(rloss),
                               rtol=LOSS_RTOL)
    pairs = _pairs(grads, rgrads)
    nonzero = 0
    for path, g, w in pairs:
        top = float(np.abs(w).max(initial=0.0))
        np.testing.assert_allclose(g, w, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL_REL * top,
                                   err_msg=f"{case} {path}")
        nonzero += top > 0
    assert nonzero >= len(pairs) // 2, case


def _adam_dir(g):
    """AdamW's first-step direction g / (|g| + eps) (f64)."""
    g = g.astype(np.float64)
    return g / (np.abs(g) + 1e-8)


def check_step(case, m, compress):
    """One ``make_train_step`` against the reference's.

    AdamW's first step moves a param by lr · u(g), u(g) = g / (|g| +
    eps), plus its weight decay: u is set by the grad alone, and a grad
    near zero (or near eps) turns it far on a small change. So each param
    is held within ``PARAM_ATOL`` plus lr times the spread of u over the
    grads the grad tolerance admits, g ± (``GRAD_RTOL`` · |g| +
    ``GRAD_ATOL_REL`` · max |g|), g the reference's (its first moment over
    1 - b1): that spread is ~0 where the sign of g is held, and up to 2
    where it is not (at lr 1e-3 one of mixtral-8x7b's 8,192 ``wo``
    weights has grads 7.99e-9 and 4.64e-9 and moved 1.4e-5 apart).
    Under ``compress`` an element whose x / scale lies within the
    tolerance of a half may take either int8 code: its first moment is
    held within one code instead (at most 1 % of a leaf), and its spread
    of u over g ± one code."""
    loss_fn, r_loss_fn, p, rp, batch, extra = _case(case)
    opt = AdamW(lr=STEP_LR)
    ropt = rtrain.AdamW(lr=STEP_LR)
    step = make_train_step(loss_fn, opt, n_microbatches=m,
                           compress=compress)
    rstep = jax.jit(rtrain.make_train_step(
        lambda q, b: r_loss_fn(q, dict(b, **extra)), ropt,
        n_microbatches=m, compress=compress))
    before = tree_map(lambda x: x.clone(), p)
    state = init_train_state(p, opt, compress=compress)
    rstate = rtrain.init_train_state(rp, ropt, compress=compress)
    p1, s1, met = step(p, state, _t(batch, extra))
    rp1, rs1, rmet = rstep(rp, rstate, _j(batch, {}))
    np.testing.assert_allclose(met["loss"].numpy(), np.asarray(rmet["loss"]),
                               rtol=LOSS_RTOL)
    moments = {path: (a, b) for path, a, b in _pairs(s1["m"], rs1["m"])}
    held = total = 0
    for path, a, b in _pairs(p1, rp1):
        ma, mb = moments[path]
        top = float(np.abs(mb).max(initial=0.0))
        g = mb / (1 - ropt.b1)
        tol = GRAD_RTOL * np.abs(g) + GRAD_ATOL_REL * np.abs(g).max(
            initial=0.0)
        if compress:
            # the int8 code of an x/scale within the tolerance of a half
            # may round either way: one code (max |g| / 127) apart, on
            # at most 1 % of the elements
            code = np.abs(g).max(initial=0.0) / 127.0
            flip = np.abs(ma - mb) > (1 - ropt.b1) * tol
            assert flip.mean() <= 0.01, (case, path, flip.mean())
            assert (np.abs(ma - mb)[flip] <= (1 - ropt.b1) * code
                    * (1 + GRAD_RTOL)).all(), (case, path)
            tol = tol + flip * code * (1 + GRAD_RTOL)
        else:
            np.testing.assert_allclose(ma, mb, rtol=GRAD_RTOL,
                                       atol=GRAD_ATOL_REL * top,
                                       err_msg=f"{case} m {path}")
        slack = STEP_LR * (_adam_dir(g + tol) - _adam_dir(g - tol))
        err = np.abs(a - b)
        assert (err <= PARAM_ATOL + slack).all(), (
            case, path, float((err - slack).max()))
        held += int((slack[g != 0] <= PARAM_ATOL).sum())
        total += int((g != 0).sum())
    assert held >= total // 2, (case, held, total)   # most signs are held
    assert all(torch.equal(x, y) for (_, x), (_, y)
               in zip(tree_paths(p), tree_paths(before)))
