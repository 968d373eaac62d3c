"""Cell plumbing: every (architecture × input shape) becomes a ``Cell``.

The port's counterpart of ``repro.configs.common``. A Cell knows how to
build its step function and abstract arguments lazily — ``meta`` tensors, the counterpart of
``jax.ShapeDtypeStruct``, so nothing touches a device when cells are
built — plus how to give placements for a mesh (DTensor placement lists,
one a tensor, by ``dist.sharding``'s rules) and a MODEL_FLOPS estimate for
the roofline's useful-compute ratio.

It holds the LM family's cells (``train_4k``, ``prefill_32k``,
``decode_32k``, ``long_500k``), the GNN family's train cells and the
recsys family's (``train_batch``, ``serve_p99``, ``serve_bulk``,
``retrieval_cand``). A train cell's function is
``train.make_train_step``'s step, its arguments ``(params, opt_state,
batch)``.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from ..dist.sharding import (_sizes, batch_pspec, data_axes, param_pspecs,
                             spec_placements)
from ..kernels import ops
from ..models import egnn, recsys, transformer
from ..models.common import tree_map
from ..train.optimizer import AdamW, cosine_schedule
from ..train.step import make_train_step


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
# LM family
# ==========================================================================

def lm_param_pspecs(cfg: transformer.LMConfig, params_shapes, mesh,
                    *, serving: bool = False):
    """Role-aware parameter placements.

    Megatron TP pairing: column-parallel (wq / w_gate / w_up: "model" on
    the output dim) with row-parallel (wo / w_down: "model" on the
    contraction dim), plus FSDP/ZeRO-style "data" sharding on the
    complementary dim. K/V projections are replicated over "model" (GQA
    with TP > n_kv_heads) and data-sharded for ZeRO. Embedding rows over
    "model" serve both uses (token gather; tied unembedding →
    vocab-sharded logits). Each leaf is a DTensor placement list, the
    reference's ``PartitionSpec`` through ``dist.spec_placements``.
    """
    sizes = _sizes(mesh)
    model = sizes.get("model", 1)
    data = sizes.get("data", 1)

    # Serving keeps weights RESIDENT (model-sharded, replicated over data —
    # no per-step FSDP gathers) unless they don't fit ~8 GiB/chip in bf16,
    # in which case weight-gathered inference stays on (mixtral-8x22b).
    if serving and lm_total_params(cfg) * 2 / max(model, 1) <= 8 * 2 ** 30:
        data = 1

    def P(*entries):
        return spec_placements(mesh, *entries)

    def md(n):  # dim shardable over model?
        return "model" if model > 1 and n % model == 0 else None

    def dd(n):
        return "data" if data > 1 and n % data == 0 else None

    d, f, hd = cfg.d_model, cfg.d_ff, cfg.hd
    heads_ok = cfg.n_heads % model == 0

    def kv_in(n):
        # K/V projections: output replicated over "model", so shard the
        # CONTRACTION dim over model (+data for ZeRO)
        if model > 1 and data > 1 and n % (model * data) == 0:
            return ("model", "data")
        return md(n) or dd(n)

    lay: dict = {
        "attn_norm": P(), "mlp_norm": P(),
        # column-parallel iff heads shardable; else replicate over model
        "wq": P(None, dd(d), md(cfg.n_heads * hd) if heads_ok else None),
        "wk": P(None, kv_in(d), None),
        "wv": P(None, kv_in(d), None),
        "wo": P(None, md(cfg.n_heads * hd) if heads_ok else None, dd(d)),
    }
    if cfg.qk_norm:
        lay["q_norm"] = P()
        lay["k_norm"] = P()
    if cfg.is_moe:
        lay["router"] = P()
        lay["w_gate"] = P(None, None, dd(d), md(f))
        lay["w_up"] = P(None, None, dd(d), md(f))
        lay["w_down"] = P(None, None, md(f), dd(d))
    else:
        lay["w_gate"] = P(None, dd(d), md(f))
        lay["w_up"] = P(None, dd(d), md(f))
        lay["w_down"] = P(None, md(f), dd(d))
    specs = {
        "embed": P(md(cfg.vocab_size), None),
        "layers": lay,
        "final_norm": P(),
    }
    if "lm_head" in params_shapes:
        specs["lm_head"] = P(None, md(cfg.vocab_size))
    return specs


def lm_param_shardings(cfg, params_shapes, mesh, *, serving: bool = False):
    """The placements of :func:`lm_param_pspecs` (a placement list is
    already what the reference's ``NamedSharding`` is)."""
    return lm_param_pspecs(cfg, params_shapes, mesh, serving=serving)


def lm_active_params(cfg: transformer.LMConfig) -> float:
    """Non-embedding, routing-active parameter count (6ND convention)."""
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.hd
    attn = d * hd * (cfg.n_heads * 2 + cfg.n_kv_heads * 2)
    if cfg.is_moe:
        mlp = 3 * d * f * cfg.top_k + d * cfg.n_experts
    else:
        mlp = 3 * d * f
    return float(cfg.n_layers * (attn + mlp))


def lm_total_params(cfg: transformer.LMConfig) -> float:
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.hd
    attn = d * hd * (cfg.n_heads * 2 + cfg.n_kv_heads * 2)
    mlp = 3 * d * f * (cfg.n_experts or 1)
    emb = cfg.vocab_size * d * (1 if cfg.tie_embeddings else 2)
    return float(cfg.n_layers * (attn + mlp) + emb)


def _lm_attn_flops(cfg, batch, s_q, s_kv) -> float:
    # qk^T and att@v per layer: 2 * 2 * Sq * Skv * H * hd (capped by window)
    per_layer = []
    for w in cfg.layer_windows():
        eff = min(s_kv, int(w)) if w > 0 else s_kv
        per_layer.append(4.0 * s_q * eff * cfg.n_heads * cfg.hd)
    return float(batch * sum(per_layer))


def _lm_params_sds(cfg: transformer.LMConfig) -> dict:
    """The params' specs: ``meta`` tensors cast to bf16, as the
    reference's ``eval_shape`` casts them for serving."""
    return tree_map(lambda x: x.to(torch.bfloat16),
                    transformer.init_params(torch.Generator(), cfg,
                                            device="meta"))


def lm_train_cell(arch: str, cfg: transformer.LMConfig, *,
                  global_batch: int, seq_len: int,
                  n_microbatches: int, remesh: Callable | None = None,
                  note: str = "") -> Cell:
    def build(mesh):
        opt = AdamW(lr=cosine_schedule(peak_lr=3e-4, warmup_steps=100,
                                       total_steps=10_000))
        step = make_train_step(functools.partial(transformer.loss_fn, cfg),
                               opt, n_microbatches=n_microbatches)
        params_s = transformer.init_params(torch.Generator(), cfg,
                                           device="meta")
        opt_s = opt.init(params_s)
        batch_s = {"tokens": sds((global_batch, seq_len), torch.int32),
                   "labels": sds((global_batch, seq_len), torch.int32)}
        return step, (params_s, opt_s, batch_s)

    def shardings(mesh, args):
        params_s, opt_s, batch_s = args
        ps = lm_param_shardings(cfg, params_s, mesh)
        os_ = {"m": lm_param_shardings(cfg, opt_s["m"], mesh),
               "v": lm_param_shardings(cfg, opt_s["v"], mesh),
               "step": spec_placements(mesh)}
        bs = batch_shardings(mesh, batch_s)
        return (ps, os_, bs)

    tokens = global_batch * seq_len
    flops = 6.0 * lm_active_params(cfg) * tokens \
        + 3.0 * _lm_attn_flops(cfg, global_batch, seq_len, seq_len)
    return Cell(arch, f"train_{seq_len // 1024}k", "train", build, shardings,
                flops, note=note, remesh=remesh)


def lm_prefill_cell(arch: str, cfg: transformer.LMConfig, *,
                    batch: int, seq_len: int, shape_name: str) -> Cell:
    def build(mesh):
        fn = functools.partial(transformer.prefill, cfg)
        return fn, (_lm_params_sds(cfg), sds((batch, seq_len), torch.int32))

    def shardings(mesh, args):
        params_s, tok_s = args
        return (lm_param_shardings(cfg, params_s, mesh, serving=True),
                batch_pspec(tok_s.shape, mesh))

    flops = 2.0 * lm_active_params(cfg) * batch * seq_len \
        + _lm_attn_flops(cfg, batch, seq_len, seq_len) / 2.0  # causal half
    return Cell(arch, shape_name, "prefill", build, shardings, flops)


def lm_decode_cell(arch: str, cfg: transformer.LMConfig, *,
                   batch: int, seq_len: int, shape_name: str,
                   note: str = "") -> Cell:
    def build(mesh):
        fn = functools.partial(transformer.decode_step, cfg)
        cache_s = transformer.init_decode_cache(
            cfg, batch, seq_len, dtype=torch.bfloat16, device="meta")
        return fn, (_lm_params_sds(cfg), cache_s,
                    sds((batch,), torch.int32))

    def shardings(mesh, args):
        params_s, cache_s, tok_s = args
        dp = data_axes(mesh)
        sizes = _sizes(mesh)
        n_dp = int(np.prod([sizes[a] for a in dp]))
        model = sizes.get("model", 1)
        data = sizes.get("data", 1)

        def cache_shard(a):
            # [B, S, KV, hd] (values) / [B, S, KV] (int8 scales): batch over
            # the data axes when divisible, KV sequence dim over "model"
            # (decode attention psums its softmax stats — tiny — instead of
            # holding 16x the cache)
            if a.ndim < 3:
                return spec_placements(mesh)
            s_len = a.shape[1]
            if batch % n_dp == 0 and batch >= n_dp:
                s_ax = "model" if model > 1 and s_len % model == 0 else None
                return spec_placements(mesh, dp, s_ax)
            if s_len % (data * model) == 0:
                return spec_placements(mesh, None, ("data", "model"))
            if s_len % data == 0:
                return spec_placements(mesh, None, "data")
            return spec_placements(mesh)

        cs = tree_map(cache_shard, cache_s)
        cs["pos"] = spec_placements(mesh)
        return (lm_param_shardings(cfg, params_s, mesh, serving=True), cs,
                batch_pspec(tok_s.shape, mesh))

    flops = 2.0 * lm_active_params(cfg) * batch \
        + _lm_attn_flops(cfg, batch, 1, seq_len)
    return Cell(arch, shape_name, "decode", build, shardings, flops,
                note=note)


LM_SHAPES = {
    "train_4k": dict(kind="train", seq_len=4096, global_batch=256),
    "prefill_32k": dict(kind="prefill", seq_len=32768, global_batch=32),
    "decode_32k": dict(kind="decode", seq_len=32768, global_batch=128),
    "long_500k": dict(kind="decode", seq_len=524288, global_batch=1),
}


def lm_cells(arch: str, cfg: transformer.LMConfig, *, n_microbatches: int,
             skip_long: bool = False) -> list[Cell]:
    cells = [
        lm_train_cell(arch, cfg, global_batch=256, seq_len=4096,
                      n_microbatches=n_microbatches),
        lm_prefill_cell(arch, cfg, batch=32, seq_len=32768,
                        shape_name="prefill_32k"),
        lm_decode_cell(arch, cfg, batch=128, seq_len=32768,
                       shape_name="decode_32k"),
    ]
    if not skip_long:
        cells.append(lm_decode_cell(arch, cfg, batch=1, seq_len=524288,
                                    shape_name="long_500k"))
    return cells


# ==========================================================================
# GNN family
# ==========================================================================

def gnn_train_cell(arch: str, cfg: egnn.EGNNConfig, shape_name: str, *,
                   n_nodes: int, n_edges: int, batch_labels: int | None = None,
                   n_graphs: int | None = None, note: str = "") -> Cell:
    n_edges_pad = int(-(-n_edges // 512) * 512)

    def build(mesh):
        opt = AdamW(lr=1e-3)
        base_step = make_train_step(functools.partial(egnn.loss_fn, cfg), opt)
        if cfg.readout == "graph":
            # n_graphs is static — close over it rather than passing a leaf
            def step(params, opt_state, batch):
                return base_step(params, opt_state,
                                 dict(batch, n_graphs=n_graphs))
        else:
            step = base_step
        params_s = egnn.init_params(torch.Generator(), cfg, device="meta")
        opt_s = opt.init(params_s)
        batch_s = {
            "node_feat": sds((n_nodes, cfg.d_feat)),
            "coords": sds((n_nodes, cfg.coord_dim)),
            "edges": sds((n_edges_pad, 2), torch.int32),
        }
        if cfg.readout == "graph":
            batch_s["graph_ids"] = sds((n_nodes,), torch.int32)
            batch_s["targets"] = sds((n_graphs, cfg.n_out))
        else:
            batch_s["labels"] = sds((n_nodes,), torch.int32)
        return step, (params_s, opt_s, batch_s)

    def shardings(mesh, args):
        params_s, opt_s, batch_s = args
        all_axes = tuple(mesh.mesh_dim_names)

        def bshard(key, a):
            if key == "edges":
                return spec_placements(mesh, all_axes, None)
            return spec_placements(mesh)

        bs = {k: bshard(k, v) for k, v in batch_s.items()}
        return (repl(mesh, params_s), repl(mesh, opt_s), bs)

    d = cfg.d_hidden
    # messages: phi_e (2 layers d->d) per edge; phi_h per node; x3 for bwd
    flops = 3.0 * cfg.n_layers * (
        2.0 * n_edges * (2 * d + 1 + cfg.d_edge) * d + 2.0 * n_edges * d * d
        + 4.0 * n_nodes * d * d)
    return Cell(arch, shape_name, "train", build, shardings, flops, note)


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


def recsys_train_cell(arch: str, cfg: recsys.RecsysConfig, *,
                      batch: int, n_microbatches: int = 1) -> Cell:
    def build(mesh):
        opt = AdamW(lr=1e-3)
        step = make_train_step(functools.partial(recsys.loss_fn, cfg), opt,
                               n_microbatches=n_microbatches)
        params_s = _params_sds(cfg)
        opt_s = opt.init(params_s)
        return step, (params_s, opt_s, _recsys_batch_sds(cfg, batch, True))

    def shardings(mesh, args):
        params_s, opt_s, batch_s = args
        ps = params_shardings(mesh, params_s)
        os_ = {"m": params_shardings(mesh, opt_s["m"]),
               "v": params_shardings(mesh, opt_s["v"]),
               "step": spec_placements(mesh)}
        return (ps, os_, batch_shardings(mesh, batch_s))

    return Cell(arch, "train_batch", "train", build, shardings,
                3.0 * recsys_model_flops(cfg, batch))


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


def recsys_cells(arch: str, cfg: recsys.RecsysConfig, *,
                 train_microbatches: int = 1) -> list[Cell]:
    return [
        recsys_train_cell(arch, cfg, batch=RECSYS_SHAPES["train_batch"],
                          n_microbatches=train_microbatches),
        recsys_serve_cell(arch, cfg, batch=RECSYS_SHAPES["serve_p99"],
                          shape_name="serve_p99"),
        recsys_serve_cell(arch, cfg, batch=RECSYS_SHAPES["serve_bulk"],
                          shape_name="serve_bulk"),
        recsys_retrieval_cell(arch, cfg),
    ]
