"""EGNN — E(n)-equivariant graph network (Satorras et al., arXiv:2102.09844).

The port's counterpart of ``repro.models.egnn``: edge-list message
passing on the shared sparse substrate (``sparse/segment_ops.py``).
Message construction is a gather over ``(src, dst)`` index arrays
(:func:`~repro_torch.sparse.segment_ops.gather_rows`), aggregation a
segment sum; both sum in a fixed order, in the forward and in the
backward, so a training step gives the same bits run to run.

Per layer l (m_ij over directed edges):
    m_ij      = φ_e(h_i, h_j, ‖x_i − x_j‖², a_ij)
    x_i'      = x_i + mean_j (x_i − x_j) · φ_x(m_ij)        (equivariant)
    h_i'      = φ_h(h_i, Σ_j m_ij)                           (invariant)

Graphs are static-shape: ``edges [E, 2]`` int32 with -1 padding (a
padding edge reads node 0, is masked out of every message and is summed
into the sentinel segment ``n_nodes``, which is dropped); batched small
graphs are flattened with a ``graph_ids`` vector for the readout, over a
static ``n_graphs``. Each layer runs under
``torch.utils.checkpoint`` (the reference's ``jax.checkpoint``): its
messages are recomputed in the backward. The segment plans of the
destinations and sources are made once a forward and serve every layer.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..sparse.segment_ops import (gather_rows, segment_mean, segment_plan,
                                  segment_sum)
from .common import normal_init, split_keys


@dataclass(frozen=True)
class EGNNConfig:
    name: str
    n_layers: int = 4
    d_hidden: int = 64
    d_feat: int = 64            # input node-feature dim
    d_edge: int = 0             # input edge-attribute dim (0 = none)
    n_out: int = 1              # classes (nodes) or regression dims (graph)
    readout: str = "node"       # "node" | "graph"
    coord_dim: int = 3
    dtype: Any = torch.float32


def _mlp_init(gen, dims, *, device):
    ks = split_keys(gen, len(dims) - 1)
    return [{"w": normal_init(k, (a, b), 1.0 / np.sqrt(a), device=device),
             "b": torch.zeros((b,), device=device)}
            for k, (a, b) in zip(ks, zip(dims[:-1], dims[1:]))]


def _mlp(params, x, act=F.silu, last_act=False):
    for i, lyr in enumerate(params):
        x = x @ lyr["w"] + lyr["b"]
        if i < len(params) - 1 or last_act:
            x = act(x)
    return x


def init_params(gen: torch.Generator, cfg: EGNNConfig, *,
                device=None) -> dict:
    """f32 params of ``cfg`` drawn from ``gen`` (a generator on
    ``device``), on ``device`` (default ``cuda``; ``meta`` gives the shapes
    alone, as ``jax.eval_shape`` of the reference's ``init_params``
    does)."""
    meta = device is not None and torch.device(device).type == "meta"
    dev = torch.device("meta") if meta else resolve_device(device)
    d = cfg.d_hidden
    ks = iter(split_keys(gen, 3 + 4 * cfg.n_layers))
    params = {
        "proj_in": {"w": normal_init(next(ks), (cfg.d_feat, d),
                                     1.0 / np.sqrt(cfg.d_feat), device=dev),
                    "b": torch.zeros((d,), device=dev)},
        "layers": [],
        "head": _mlp_init(next(ks), (d, d, cfg.n_out), device=dev),
    }
    edge_in = 2 * d + 1 + cfg.d_edge
    for _ in range(cfg.n_layers):
        params["layers"].append({
            "phi_e": _mlp_init(next(ks), (edge_in, d, d), device=dev),
            "phi_x": _mlp_init(next(ks), (d, d, 1), device=dev),
            "phi_h": _mlp_init(next(ks), (2 * d, d, d), device=dev),
        })
    return params


def _layer(cfg: EGNNConfig, lp: dict, h, x, src, dst, edge_attr, valid,
           n_nodes: int, plans: dict):
    """One EGNN layer over the (padded) directed edge list."""
    hi = gather_rows(h, dst, plan=plans["dst"])   # messages flow src -> dst
    hj = gather_rows(h, src, plan=plans["src"])
    xi = gather_rows(x, dst, plan=plans["dst"])
    xj = gather_rows(x, src, plan=plans["src"])
    diff = xi - xj                                # [E, 3]
    dist2 = torch.sum(diff * diff, dim=-1, keepdim=True)
    feats = [hi, hj, dist2]
    if edge_attr is not None:
        feats.append(edge_attr)
    m = _mlp(lp["phi_e"], torch.cat(feats, dim=-1), last_act=True)
    m = m * valid[:, None]

    # equivariant coordinate update (mean over incoming edges)
    coef = _mlp(lp["phi_x"], m)                   # [E, 1]
    upd = diff * coef * valid[:, None]
    seg = plans["seg"]                            # padding -> sentinel
    x = x + segment_mean(upd, seg.ids, n_nodes, plan=seg)

    # invariant feature update (sum aggregation)
    agg = segment_sum(m, seg.ids, n_nodes, plan=seg)
    h = h + _mlp(lp["phi_h"], torch.cat([h, agg], dim=-1))
    return h, x


def forward(cfg: EGNNConfig, params: dict, batch: dict
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """batch: node_feat [N,F], coords [N,3], edges [E,2] (-1 pad),
    optional edge_attr [E,De], optional graph_ids [N] and ``n_graphs``
    (an int: graph readout). Returns (predictions, final coords)."""
    nf = batch["node_feat"].to(cfg.dtype)
    x = batch["coords"].to(cfg.dtype)
    edges = batch["edges"]
    n_nodes = nf.shape[0]
    valid = (edges[:, 0] >= 0).to(cfg.dtype)
    # jnp indexing: a clamped id (a padding edge reads node 0)
    src = edges[:, 0].long().clamp(0, n_nodes - 1)
    dst = edges[:, 1].long().clamp(0, n_nodes - 1)
    edge_attr = batch.get("edge_attr")
    seg = torch.where(valid > 0, dst, n_nodes)
    plans = {"dst": segment_plan(dst, n_nodes),
             "src": segment_plan(src, n_nodes),
             "seg": segment_plan(seg, n_nodes)}

    h = nf @ params["proj_in"]["w"] + params["proj_in"]["b"]

    def layer(lp, h, x):
        return _layer(cfg, lp, h, x, src, dst, edge_attr, valid, n_nodes,
                      plans)

    for lp in params["layers"]:
        # remat: messages recomputed in backward
        h, x = checkpoint(layer, lp, h, x, use_reentrant=False)

    if cfg.readout == "graph":
        gid = batch["graph_ids"]
        n_graphs = int(batch["n_graphs"])
        pooled = segment_sum(h, gid, n_graphs)
        return _mlp(params["head"], pooled), x
    return _mlp(params["head"], h), x


def loss_fn(cfg: EGNNConfig, params: dict, batch: dict
            ) -> tuple[torch.Tensor, dict]:
    pred, _ = forward(cfg, params, batch)
    if cfg.readout == "graph":
        target = batch["targets"]                          # [G, n_out]
        loss = torch.mean((pred - target) ** 2)
        return loss, {"loss": loss, "mse": loss}
    labels = batch["labels"]                               # [N] (-1 = unlabeled)
    mask = (labels >= 0).float()
    logits = pred.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1,
                        labels.long().clamp_min(0)[:, None])[:, 0]
    ce = ((lse - gold) * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
    acc = (((torch.argmax(logits, -1) == labels) * mask).sum()
           / torch.clamp_min(mask.sum(), 1.0))
    return ce, {"loss": ce, "acc": acc}


def reduced(cfg: EGNNConfig, **overrides) -> EGNNConfig:
    small = dict(n_layers=2, d_hidden=16)
    small.update(overrides)
    return replace(cfg, **small)
