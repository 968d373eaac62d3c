"""EGNN on the port: the reference's properties, and parity with it.

* ``tests/test_egnn.py``'s five: E(n) equivariance (hypothesis, through
  the conftest shim), permutation equivariance, inert padding edges,
  static neighbour-sampler shapes, and the molecule loss falling;
  ``tests/test_models_smoke.py::test_egnn_smoke_all_shapes``.
* The forward (predictions and coordinates) against
  ``repro.models.egnn.forward`` on the same params (``convert``) within
  rtol/atol 1e-5, node and graph readouts, padding edges included; the
  loss and every grad leaf, and one ``make_train_step`` (``compress`` off
  and on), through ``torch_train_parity``.
* ``init_params`` on ``meta``: the reference's shapes; the layer runs
  under ``torch.utils.checkpoint``.
"""

import functools
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import given, settings, st

from repro.models import egnn as re
from repro_torch.configs import get_smoke
from repro_torch.convert import egnn_params_from_reference
from repro_torch.data.graphs import (batched_molecules, neighbor_sample,
                                     random_graph)
from repro_torch.models import egnn
from repro_torch.models.common import tree_paths
from repro_torch.train import AdamW, init_train_state, make_train_step
from torch_train_parity import check_grads, check_step


def _setup(seed, n_out=3, readout="node"):
    cfg = egnn.EGNNConfig(name="e", n_layers=2, d_hidden=16, d_feat=8,
                          n_out=n_out, readout=readout)
    params = egnn.init_params(torch.Generator().manual_seed(seed), cfg,
                              device="cpu")
    rng = np.random.default_rng(seed)
    n, e = 20, 50
    batch = {
        "node_feat": torch.as_tensor(rng.normal(size=(n, 8)).astype(
            np.float32)),
        "coords": torch.as_tensor(rng.normal(size=(n, 3)).astype(
            np.float32)),
        "edges": torch.as_tensor(rng.integers(0, n, size=(e, 2)).astype(
            np.int32)),
    }
    return cfg, params, batch, rng


def _rotation(rng):
    a = rng.normal(size=(3, 3))
    q, _ = np.linalg.qr(a)
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1
    return torch.as_tensor(q.astype(np.float32))


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 10_000))
def test_property_en_equivariance(seed):
    """h invariant, x equivariant under any rotation + translation."""
    cfg, params, batch, rng = _setup(seed % 7)
    rng = np.random.default_rng(seed)
    r = _rotation(rng)
    t = torch.as_tensor(rng.normal(size=3).astype(np.float32))
    pred1, x1 = egnn.forward(cfg, params, batch)
    b2 = dict(batch)
    b2["coords"] = batch["coords"] @ r.T + t
    pred2, x2 = egnn.forward(cfg, params, b2)
    np.testing.assert_allclose(pred1.numpy(), pred2.numpy(), rtol=2e-3,
                               atol=2e-3)
    np.testing.assert_allclose((x1 @ r.T + t).numpy(), x2.numpy(),
                               rtol=2e-3, atol=2e-3)


def test_permutation_equivariance():
    """Relabeling nodes permutes outputs correspondingly."""
    cfg, params, batch, rng = _setup(3)
    n = batch["node_feat"].shape[0]
    perm = torch.as_tensor(rng.permutation(n))
    inv = torch.argsort(perm)
    pred1, _ = egnn.forward(cfg, params, batch)
    b2 = {
        "node_feat": batch["node_feat"][perm],
        "coords": batch["coords"][perm],
        "edges": inv.to(torch.int32)[batch["edges"].long().clamp_min(0)],
    }
    pred2, _ = egnn.forward(cfg, params, b2)
    np.testing.assert_allclose(pred1[perm].detach().numpy(),
                               pred2.detach().numpy(), rtol=1e-3, atol=1e-3)


def test_padding_edges_are_inert():
    cfg, params, batch, _ = _setup(5)
    pred1, x1 = egnn.forward(cfg, params, batch)
    pad = torch.full((10, 2), -1, dtype=torch.int32)
    b2 = dict(batch)
    b2["edges"] = torch.cat([batch["edges"], pad])
    pred2, x2 = egnn.forward(cfg, params, b2)
    np.testing.assert_allclose(pred1.numpy(), pred2.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(x1.numpy(), x2.numpy(), rtol=1e-5, atol=1e-5)


def test_neighbor_sampler_shapes_static():
    g = random_graph(200, 6, d_feat=8, n_classes=3, seed=0)
    rng = np.random.default_rng(0)
    # seeds with nonzero in-degree so the subgraph is non-trivial
    seeds = np.unique(g.edges[:, 1])[:16]
    b1 = neighbor_sample(g, seeds[:8], (4, 3), rng=rng)
    b2 = neighbor_sample(g, seeds[8:16], (4, 3), rng=rng)
    for k in ("node_feat", "coords", "edges", "labels"):
        assert b1[k].shape == b2[k].shape       # static shapes
    assert (b1["labels"][:8] >= 0).all() and (b1["labels"][8:] == -1).all()
    # every edge's endpoints are within the sampled node set
    e = b1["edges"][b1["edges"][:, 0] >= 0]
    assert e.size > 0 and e.max() < b1["node_feat"].shape[0]
    # and the sample trains: one step on it, finite and moving
    cfg = egnn.EGNNConfig(name="s", n_layers=2, d_hidden=16, d_feat=8,
                          n_out=3)
    params = egnn.init_params(torch.Generator().manual_seed(0), cfg,
                              device="cpu")
    opt = AdamW(lr=1e-3)
    step = make_train_step(functools.partial(egnn.loss_fn, cfg), opt)
    p1, _, m = step(params, init_train_state(params, opt),
                    {k: torch.as_tensor(v) for k, v in b1.items()})
    assert np.isfinite(float(m["loss"]))
    assert not torch.equal(p1["proj_in"]["w"], params["proj_in"]["w"])


def test_egnn_molecule_training_reduces_loss():
    cfg = egnn.EGNNConfig(name="m", n_layers=2, d_hidden=16, d_feat=11,
                          n_out=1, readout="graph")
    params = egnn.init_params(torch.Generator().manual_seed(0), cfg,
                              device="cpu")
    opt = AdamW(lr=3e-3)
    base = make_train_step(functools.partial(egnn.loss_fn, cfg), opt)
    n_graphs = 16

    def step(p, s, b):
        return base(p, s, dict(b, n_graphs=n_graphs))

    state = init_train_state(params, opt)
    batch = batched_molecules(n_graphs, n_nodes=10, n_edges=16)
    batch.pop("n_graphs")
    batch = {k: torch.as_tensor(v) for k, v in batch.items()}
    losses = []
    for _ in range(30):
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < 0.5 * losses[0], losses[::10]


def test_egnn_smoke_all_shapes():
    cfg = get_smoke("egnn")
    # node classification
    g = random_graph(50, 4, d_feat=cfg.d_feat, n_classes=cfg.n_out)
    params = egnn.init_params(torch.Generator().manual_seed(0), cfg,
                              device="cpu")
    batch = {"node_feat": torch.as_tensor(g.node_feat),
             "coords": torch.as_tensor(g.coords),
             "edges": torch.as_tensor(g.edges.astype(np.int32)),
             "labels": torch.as_tensor(g.labels.astype(np.int32))}
    loss, m = egnn.loss_fn(cfg, params, batch)
    assert np.isfinite(float(loss))
    # graph regression (molecule)
    cfgg = replace(cfg, readout="graph", n_out=1, d_feat=11)
    pg = egnn.init_params(torch.Generator().manual_seed(1), cfgg,
                          device="cpu")
    mb = batched_molecules(4, n_nodes=10, n_edges=12)
    mb = {k: (torch.as_tensor(v) if not isinstance(v, int) else v)
          for k, v in mb.items()}
    loss, _ = egnn.loss_fn(cfgg, pg, mb)
    assert np.isfinite(float(loss))


# -- parity with the reference --------------------------------------------

@pytest.mark.parametrize("readout", ["node", "graph"])
def test_forward_matches_reference(readout):
    graph = readout == "graph"
    kw = dict(n_layers=3, d_hidden=16, d_feat=11 if graph else 8,
              n_out=1 if graph else 3, readout=readout)
    cfg, rcfg = egnn.EGNNConfig(name="e", **kw), re.EGNNConfig(name="e", **kw)
    rp = re.init_params(jax.random.PRNGKey(2), rcfg)
    p = egnn_params_from_reference(jax.device_get(rp), device="cpu")
    if graph:
        b = batched_molecules(5, n_nodes=9, n_edges=14, seed=1)
        b.pop("n_graphs")
        extra = {"n_graphs": 5}
    else:
        g = random_graph(30, 5, d_feat=8, n_classes=3, seed=1)
        b = {"node_feat": g.node_feat, "coords": g.coords,
             "edges": g.edges.astype(np.int32)}
        extra = {}
    b["edges"] = np.concatenate([np.full((3, 2), -1, np.int32), b["edges"],
                                 np.full((7, 2), -1, np.int32)])
    pred, x = egnn.forward(cfg, p, dict(
        {k: torch.as_tensor(v) for k, v in b.items()}, **extra))
    rpred, rx = re.forward(rcfg, rp, dict(
        {k: jnp.asarray(v) for k, v in b.items()}, **extra))
    np.testing.assert_allclose(pred.numpy(), np.asarray(rpred), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(x.numpy(), np.asarray(rx), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("readout", ["node", "graph"])
def test_loss_and_grads_match_reference(readout):
    check_grads(f"egnn:{readout}")


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("readout", ["node", "graph"])
def test_train_step_matches_reference(readout, compress):
    check_step(f"egnn:{readout}", 1, compress)


def test_meta_params_match_the_reference_shapes():
    cfg = get_smoke("egnn")
    import repro.configs as ref_configs
    rp = jax.eval_shape(lambda k: re.init_params(k, ref_configs.get_smoke(
        "egnn")), jax.random.PRNGKey(0))
    p = egnn.init_params(torch.Generator(), cfg, device="meta")
    got = [(path, tuple(x.shape)) for path, x in tree_paths(p)]
    want = [(tuple(getattr(k, "key", getattr(k, "idx", None)) for k in kp),
             tuple(x.shape))
            for kp, x in jax.tree_util.tree_leaves_with_path(rp)]
    assert got == want
    assert all(x.device.type == "meta" for _, x in tree_paths(p))


def test_layers_are_checkpointed(monkeypatch):
    """Each layer runs under ``torch.utils.checkpoint`` (non-reentrant)."""
    cfg, params, batch, _ = _setup(1)
    seen = []
    real = egnn.checkpoint

    def spy(fn, *args, **kw):
        seen.append(kw.get("use_reentrant"))
        return real(fn, *args, **kw)

    monkeypatch.setattr(egnn, "checkpoint", spy)
    egnn.forward(cfg, params, batch)
    assert seen == [False] * cfg.n_layers
