"""Cell plumbing: every (architecture × input shape) becomes a ``Cell``.

The port's counterpart of ``repro.configs.common``, for the recsys
family. A Cell knows how to build its step function and abstract
arguments lazily — ``meta`` tensors, the counterpart of
``jax.ShapeDtypeStruct``, so nothing touches a device when cells are
built — plus how to give placements for a mesh (DTensor placement lists,
one a tensor, by ``dist.sharding``'s rules) and a MODEL_FLOPS estimate for
the roofline's useful-compute ratio.

The LM and GNN cells and the recsys ``train_batch`` cell come with the
slices that port their models' stacks.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable

import torch

from ..dist.sharding import batch_pspec, param_pspecs
from ..kernels import ops
from ..models import recsys
from ..models.common import tree_map


def sds(shape, dtype=torch.float32) -> torch.Tensor:
    """An abstract argument: a ``meta`` tensor of ``shape`` and ``dtype``."""
    return torch.empty(tuple(int(x) for x in shape), dtype=dtype,
                       device="meta")


@dataclass
class Cell:
    arch: str
    shape: str
    kind: str                       # train | prefill | decode | serve | retrieval
    build: Callable                 # (mesh) -> (fn, args tree of meta tensors)
    shardings: Callable             # (mesh, args) -> placements tree
    model_flops: float              # useful FLOPs per step (global, fwd[+bwd])
    note: str = ""
    remesh: Callable | None = None  # (mesh) -> mesh: logical re-mesh of the
                                    # SAME devices (perf variants only)

    @property
    def key(self) -> str:
        return f"{self.arch}/{self.shape}"


def params_shardings(mesh, params_shapes):
    return param_pspecs(params_shapes, mesh)


def batch_shardings(mesh, batch_shapes):
    return tree_map(lambda a: batch_pspec(a.shape, mesh), batch_shapes)


def repl(mesh, tree):
    from torch.distributed.tensor import Replicate
    return tree_map(lambda a: [Replicate() for _ in mesh.mesh_dim_names],
                    tree)


def _params_sds(cfg: recsys.RecsysConfig) -> dict:
    return recsys.init_params(torch.Generator(), cfg, device="meta")


# ==========================================================================
# RecSys family
# ==========================================================================

def _recsys_batch_sds(cfg: recsys.RecsysConfig, batch: int,
                      with_labels: bool) -> dict:
    if cfg.model in ("dlrm", "autoint"):
        b = {"sparse": sds((batch, cfg.n_sparse), torch.int32)}
        if cfg.n_dense:
            b["dense"] = sds((batch, cfg.n_dense))
        if with_labels:
            b["labels"] = sds((batch,), torch.int32)
    elif cfg.model == "sasrec":
        b = {"history": sds((batch, cfg.seq_len), torch.int32),
             "pos_items": sds((batch, cfg.seq_len), torch.int32),
             "neg_items": sds((batch, cfg.seq_len), torch.int32)}
    else:  # mind
        b = {"history": sds((batch, cfg.seq_len), torch.int32),
             "pos_items": sds((batch,), torch.int32),
             "neg_items": sds((batch,), torch.int32)}
    return b


def recsys_model_flops(cfg: recsys.RecsysConfig, batch: int) -> float:
    d = cfg.embed_dim
    if cfg.model == "dlrm":
        dims = (cfg.n_dense,) + cfg.bot_mlp
        mlp = sum(2 * a * b for a, b in zip(dims[:-1], dims[1:]))
        tdims = (recsys._dlrm_top_in(cfg),) + cfg.top_mlp
        mlp += sum(2 * a * b for a, b in zip(tdims[:-1], tdims[1:]))
        inter = 2 * (cfg.n_sparse + 1) ** 2 * d
        return float(batch * (mlp + inter))
    if cfg.model == "autoint":
        f = cfg.n_sparse
        per_layer = 2 * f * (3 * d * cfg.d_attn + 2 * f * cfg.d_attn)
        return float(batch * cfg.n_attn_layers * per_layer)
    if cfg.model == "sasrec":
        l = cfg.seq_len
        per_blk = 2 * l * (4 * d * d) + 2 * l * l * d * 2
        return float(batch * cfg.n_blocks * per_blk)
    l = cfg.seq_len
    return float(batch * (2 * l * d * d
                          + cfg.capsule_iters * 4 * cfg.n_interests * l * d))


def recsys_serve_cell(arch: str, cfg: recsys.RecsysConfig, *,
                      batch: int, shape_name: str) -> Cell:
    def build(mesh):
        fn = functools.partial(recsys.forward, cfg)
        return fn, (_params_sds(cfg), _recsys_batch_sds(cfg, batch, False))

    def shardings(mesh, args):
        params_s, batch_s = args
        return (params_shardings(mesh, params_s),
                batch_shardings(mesh, batch_s))

    return Cell(arch, shape_name, "serve", build, shardings,
                recsys_model_flops(cfg, batch))


def recsys_retrieval_cell(arch: str, cfg: recsys.RecsysConfig, *,
                          n_candidates: int = 1_048_576, k: int = 100) -> Cell:
    """retrieval_cand: 1 query vs ~1M candidates + two-stage top-k.

    n_candidates is padded to 2^20 so candidate blocks divide the mesh.
    The top-k is ``kernels.ops.topk`` over segments of 4,096: K5 on the
    card, K5's twin on the CPU, in the port's tie order (value desc, then
    index asc). The reference selects here with its plain two-stage
    top-k (``lax.top_k`` twice); K5 is the port's choice, with the same
    tie rule.
    """
    def build(mesh):
        def fn(params, batch, candidates):
            scores = recsys.retrieval_scores(cfg, params, batch, candidates)
            vals, idx = ops.topk(scores, k, block=4096)
            return idx, vals

        return fn, (_params_sds(cfg), _recsys_batch_sds(cfg, 1, False),
                    sds((n_candidates,), torch.int32))

    def shardings(mesh, args):
        from torch.distributed.tensor import Shard
        params_s, batch_s, cand_s = args
        return (params_shardings(mesh, params_s), repl(mesh, batch_s),
                [Shard(0) for _ in mesh.mesh_dim_names])

    # CTR models run a full forward per candidate; seq models one dot
    if cfg.model in ("dlrm", "autoint"):
        flops = recsys_model_flops(cfg, n_candidates)
    else:
        flops = 2.0 * n_candidates * cfg.embed_dim * \
            (cfg.n_interests if cfg.model == "mind" else 1)
    return Cell(arch, "retrieval_cand", "retrieval", build, shardings, flops)


RECSYS_SHAPES = dict(train_batch=65_536, serve_p99=512, serve_bulk=262_144)


def recsys_cells(arch: str, cfg: recsys.RecsysConfig) -> list[Cell]:
    """The family's serving cells: ``serve_p99``, ``serve_bulk`` and
    ``retrieval_cand`` (``train_batch`` comes with the training slice)."""
    return [
        recsys_serve_cell(arch, cfg, batch=RECSYS_SHAPES["serve_p99"],
                          shape_name="serve_p99"),
        recsys_serve_cell(arch, cfg, batch=RECSYS_SHAPES["serve_bulk"],
                          shape_name="serve_bulk"),
        recsys_retrieval_cell(arch, cfg),
    ]
