"""RecSys architectures: DLRM, AutoInt, SASRec, MIND.

The port's counterpart of ``repro.models.recsys``. All four share the
sparse embedding substrate: tables stored concatenated (``[Σ vocab_f, D]``
+ per-field row offsets) and one gather. ``retrieval_scores`` (the
``retrieval_cand`` shape) scores one user against 10⁶ candidates as a
batched dot against the item table — never a loop — and feeds the
two-stage top-k. The reference's cell selects with the plain two-stage
top-k (``lax.top_k`` twice, no Pallas kernel); the port's selects with
``kernels.ops.topk``, K5 on the card, by choice.

Params are trees of f32 tensors; model code is plain functions on
tensors, trained through ``loss_fn`` under autograd (``train/``). Every
lookup is :func:`take_rows`,
which gives ``jnp.take``'s rows for any id: an id in ``[-rows, -1]``
counts from the end and any other id outside the table gives a row of
NaN, with no host sync and no device-side assert, and whose backward
adds each row's gradients into the table in a fixed order
(``sparse.segment_ops.gather_rows``; ``index_select``'s own backward
adds with atomics on CUDA). The products are
``torch.matmul`` / ``einsum`` in f32, as the reference computes them
outside any kernel.

A partitioned step (the recsys cells on ``DTensor`` placements under
``dist.sharding.partitioned``: tables row-sharded and the other weights
split on a dim over the data axes, the batch over the data axes, or
``retrieval_cand``'s candidates over every axis) runs the model as one
rank's program on its own rows (:func:`_local_forward`): every weight but
the tables gathered over the data axes first (FSDP), a lookup gathering
the ids a rank's rows serve and reduce-scattering the rows
(:class:`_RowShards`); a CTR model scores each rank's own candidates
(:func:`retrieval_scores`). Which path runs is decided once an entry
point (``sharding.is_partitioned``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Any

import numpy as np
import torch

from ..device import resolve_device
from ..dist import sharding
from ..sparse.segment_ops import gather_rows
from .common import normal_init, split_keys


@dataclass(frozen=True)
class RecsysConfig:
    name: str
    model: str                       # dlrm | autoint | sasrec | mind
    vocab_sizes: tuple[int, ...]     # per sparse field (item vocab for seq models)
    embed_dim: int
    n_dense: int = 0
    bot_mlp: tuple[int, ...] = ()
    top_mlp: tuple[int, ...] = ()
    n_attn_layers: int = 3           # autoint
    n_heads: int = 2
    d_attn: int = 32
    n_blocks: int = 2                # sasrec
    seq_len: int = 50
    n_interests: int = 4             # mind
    capsule_iters: int = 3
    dtype: Any = torch.float32

    @property
    def n_sparse(self) -> int:
        return len(self.vocab_sizes)

    @property
    def total_rows(self) -> int:
        return int(sum(self.vocab_sizes))

    @property
    def padded_rows(self) -> int:
        """Concatenated-table rows padded so the (data, model) row/dim
        sharding always divides (4096 | rows)."""
        return -(-self.total_rows // 4096) * 4096

    def field_offsets(self) -> np.ndarray:
        return np.concatenate([[0], np.cumsum(self.vocab_sizes)[:-1]]
                              ).astype(np.int32)


def take_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``jnp.take(table, ids, axis=0)``: ``ids.shape + [D]`` rows.

    ``jnp.take``'s default ``mode="fill"``: an id in ``[-rows, -1]`` wraps
    to ``rows + id``; any other id outside ``[0, rows)`` gives a NaN row.
    Ids are clamped before the gather (so no id faults) and the rows of
    out-of-range ids are filled in place afterwards. The gather is
    :func:`gather_rows`: ``index_select``'s rows, with a backward that sums
    each table row's gradients in input order. A partitioned step's table
    (:class:`_RowShards`, or a ``DTensor``) takes the row program of
    :meth:`_RowShards.take`.
    """
    if isinstance(table, _RowShards):
        return table.take(ids)
    if sharding.is_partitioned(table) or sharding.is_partitioned(ids):
        return _partitioned_take(table, ids)
    n = table.shape[0]
    ids = torch.where(ids < 0, ids + n, ids)
    bad = (ids < 0) | (ids >= n)
    rows = gather_rows(table, ids.clamp(0, n - 1).reshape(-1))
    rows = rows.view(*ids.shape, table.shape[1])
    return rows.masked_fill_(bad[..., None], float("nan"))


def _rows_in(t: torch.Tensor, ids: torch.Tensor, off: int) -> torch.Tensor:
    """Rows ``ids`` of a table of which ``t`` holds rows ``[off, off +
    len(t))``: :func:`gather_rows`'s rows, a zero row for an id outside
    them."""
    loc = ids.reshape(-1) - off
    inside = (loc >= 0) & (loc < t.shape[0])
    rows = gather_rows(t, loc.clamp(0, t.shape[0] - 1))
    return torch.where(inside[:, None], rows, rows.new_zeros(()))


class _RowShards:
    """A rank's shard ``local`` of a table whose rows are split over mesh
    dims (placements ``tp``), looked up by ids placed ``ip`` (each split
    on dim 0 or replicated), inside one rank's program.

    :meth:`take` is the row program: over each mesh dim that splits both
    the rows and the ids, the ids are all-gathered; each rank gathers the
    rows it holds (zeros for the rest); the pieces are summed back,
    reduce-scattered over those dims (each rank keeps its own ids' rows)
    and all-reduced over the dims that split the rows alone, one nonzero
    term a row, so the rows come out exact. The NaN rule reads the global
    row count: an id outside the whole table gives one NaN row. The
    backward of each rank's gather sums the gradients of its own rows in
    a fixed order (``gather_rows``). Where no dim of more than one rank
    splits the rows, it is the plain gather."""

    def __init__(self, local, mesh, tp, ip, n_rows: int):
        if any(p.is_shard() and not p.is_shard(0) for p in [*tp, *ip]):
            raise ValueError(f"a table split on rows and ids split on dim "
                             f"0, got {tp} and {ip}")
        self.local, self.mesh = local, mesh
        self.shape, self.device = (n_rows, local.shape[1]), local.device
        split = [m for m, p in enumerate(tp)
                 if p.is_shard() and mesh.size(m) > 1]
        self.gather = [m for m in split if ip[m].is_shard()]
        self.sum_group = sharding.axes_group(mesh, tuple(
            mesh.mesh_dim_names[m] for m in split if not ip[m].is_shard()))
        part, n_part = sharding.split_index(mesh, tp, 0)
        self.off = part * -(-n_rows // n_part) if split else None

    def take(self, ids):
        n = self.shape[0]
        ids = torch.where(ids < 0, ids + n, ids)
        bad = (ids < 0) | (ids >= n)
        i = ids.clamp(0, n - 1).reshape(-1)
        if self.off is None:
            r = gather_rows(self.local, i)
        else:
            for m in self.gather:
                i = sharding.gather_over(i, (self.mesh, m))
            r = _rows_in(self.local, i, self.off)
            for m in reversed(self.gather):
                r = sharding.scatter_sum(r, (self.mesh, m))
            if self.sum_group is not None:
                (r,) = sharding.sum_over([r], self.sum_group)
        r = r.view(*ids.shape, self.shape[1])
        return r.masked_fill(bad[..., None], float("nan"))


def _row_grads(tp, ip) -> list:
    """The placements of a row-split table's gradient as a rank's program
    leaves it: its own where the rows are split, ``Partial`` where they
    are not but the ids are (each rank's ids add to every row), else
    replicated."""
    from torch.distributed.tensor import Partial

    return [t if t.is_shard() else Partial() if i.is_shard() else t
            for t, i in zip(tp, ip)]


def _partitioned_take(table, ids):
    """:func:`take_rows` on a ``DTensor`` table or ids: the row program
    (:class:`_RowShards`) under ``local_map``, the rows placed as their
    ids."""
    from torch.distributed.tensor.experimental import local_map

    mesh = (table if sharding.is_dtensor(table) else ids).device_mesh
    table, ids = (sharding.as_dtensor(t, mesh) for t in (table, ids))
    tp, ip = list(table.placements), list(ids.placements)

    def rows(t, i):
        return _RowShards(t, mesh, tp, ip, table.shape[0]).take(i)

    return local_map(rows, out_placements=ip, in_placements=(tp, ip),
                     in_grad_placements=(_row_grads(tp, ip), ip),
                     device_mesh=mesh, redistribute_inputs=True)(table, ids)


def _mlp_init(gen, dims, *, device):
    ks = split_keys(gen, len(dims) - 1)
    return [{"w": normal_init(k, (a, b), 1.0 / np.sqrt(a), device=device),
             "b": torch.zeros((b,), device=device)}
            for k, (a, b) in zip(ks, zip(dims[:-1], dims[1:]))]


def _mlp(params, x, act=torch.relu, last_act=False):
    for i, lyr in enumerate(params):
        x = x @ lyr["w"] + lyr["b"]
        if i < len(params) - 1 or last_act:
            x = act(x)
    return x


def lookup_fields(table: torch.Tensor, offsets: torch.Tensor,
                  idx: torch.Tensor) -> torch.Tensor:
    """[B, F] per-field ids -> [B, F, D] rows of the concatenated table."""
    return take_rows(table, idx + offsets[None, :])


def _offsets(cfg: RecsysConfig, device) -> torch.Tensor:
    return torch.as_tensor(cfg.field_offsets(), device=device)


# ==========================================================================
# DLRM (arXiv:1906.00091, MLPerf config)
# ==========================================================================

def dlrm_init(gen, cfg: RecsysConfig, *, device) -> dict:
    ks = iter(split_keys(gen, 4))
    return {
        "table": normal_init(next(ks), (cfg.padded_rows, cfg.embed_dim),
                             1.0 / np.sqrt(cfg.embed_dim), device=device),
        "bot": _mlp_init(next(ks), (cfg.n_dense,) + cfg.bot_mlp,
                         device=device),
        "top": _mlp_init(next(ks), (_dlrm_top_in(cfg),) + cfg.top_mlp,
                         device=device),
    }


def _dlrm_top_in(cfg: RecsysConfig) -> int:
    f = cfg.n_sparse + 1                     # embeddings + bottom-MLP output
    return cfg.embed_dim + f * (f - 1) // 2  # dense feature + pairwise dots


def dlrm_forward(cfg: RecsysConfig, params: dict, batch: dict
                 ) -> torch.Tensor:
    table = params["table"]
    dense = batch["dense"].to(cfg.dtype)                 # [B, 13]
    bot = _mlp(params["bot"], dense, last_act=True)      # [B, D]
    z = torch.cat([bot[:, None, :], lookup_fields(
        table, _offsets(cfg, table.device), batch["sparse"])],
        dim=1)                                           # [B, 27, D]
    inter = torch.einsum("bfd,bgd->bfg", z, z)           # [B, 27, 27]
    f = z.shape[1]
    iu, ju = np.triu_indices(f, k=1)
    pairs = inter[:, torch.as_tensor(iu, device=z.device),
                  torch.as_tensor(ju, device=z.device)]  # [B, 351]
    top_in = torch.cat([bot, pairs], dim=-1)
    return _mlp(params["top"], top_in)[:, 0]             # logits [B]


# ==========================================================================
# AutoInt (arXiv:1810.11921)
# ==========================================================================

def autoint_init(gen, cfg: RecsysConfig, *, device) -> dict:
    d, da = cfg.embed_dim, cfg.d_attn
    ks = iter(split_keys(gen, 3 + 4 * cfg.n_attn_layers))
    layers = []
    d_in = d
    for _ in range(cfg.n_attn_layers):
        layers.append({
            name: normal_init(next(ks), (d_in, da), 1.0 / np.sqrt(d_in),
                              device=device)
            for name in ("wq", "wk", "wv", "wres")})
        d_in = da
    return {
        "table": normal_init(next(ks), (cfg.padded_rows, d),
                             1.0 / np.sqrt(d), device=device),
        "layers": layers,
        "out": _mlp_init(next(ks), (cfg.n_sparse * d_in, 1), device=device),
    }


def autoint_forward(cfg: RecsysConfig, params: dict, batch: dict
                    ) -> torch.Tensor:
    table = params["table"]
    x = lookup_fields(table, _offsets(cfg, table.device),
                      batch["sparse"])                   # [B, F, D]
    h = cfg.n_heads
    for lp in params["layers"]:
        dh = lp["wq"].shape[-1] // h

        def split(t):
            return t.reshape(*t.shape[:-1], h, dh)
        # q and k live only for the score product and v only after the
        # softmax: at retrieval_cand's 2^20 rows each is 5.2 GB and the
        # scores [B, h, F, F] 12.8 GB
        att = torch.einsum("bfhd,bghd->bhfg", split(x @ lp["wq"]),
                           split(x @ lp["wk"]))
        att = torch.softmax(att.div_(math.sqrt(dh)), dim=-1)
        o = torch.einsum("bhfg,bghd->bfhd", att, split(x @ lp["wv"]))
        del att
        o = o.reshape(*x.shape[:-1], h * dh)
        x = torch.relu(o + x @ lp["wres"])
    flat = x.reshape(x.shape[0], -1)
    return _mlp(params["out"], flat)[:, 0]


# ==========================================================================
# SASRec (arXiv:1808.09781)
# ==========================================================================

def sasrec_init(gen, cfg: RecsysConfig, *, device) -> dict:
    d = cfg.embed_dim
    v = cfg.vocab_sizes[0]
    ks = iter(split_keys(gen, 3 + 6 * cfg.n_blocks))
    blocks = []
    for _ in range(cfg.n_blocks):
        blocks.append({
            "ln1": torch.ones((d,), device=device),
            "ln2": torch.ones((d,), device=device),
            "wq": normal_init(next(ks), (d, d), 1.0 / np.sqrt(d),
                              device=device),
            "wk": normal_init(next(ks), (d, d), 1.0 / np.sqrt(d),
                              device=device),
            "wv": normal_init(next(ks), (d, d), 1.0 / np.sqrt(d),
                              device=device),
            "ffn1": _mlp_init(next(ks), (d, d), device=device)[0],
            "ffn2": _mlp_init(next(ks), (d, d), device=device)[0],
        })
    return {
        "item_emb": normal_init(next(ks), (-(-(v + 1) // 4096) * 4096, d),
                                1.0 / np.sqrt(d), device=device),
        "pos_emb": normal_init(next(ks), (cfg.seq_len, d), 0.02,
                               device=device),
        "blocks": blocks,
        "ln_f": torch.ones((d,), device=device),
    }


def _layernorm(x, w, eps=1e-6):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * w


def sasrec_hidden(cfg: RecsysConfig, params: dict, history: torch.Tensor
                  ) -> torch.Tensor:
    """history [B, L] item ids (0 = pad) -> hidden states [B, L, D].

    A masked score is ``-1e30``, as in the reference: a row whose keys
    are all masked (an all-pad history) softmaxes to uniform, not NaN."""
    b, l = history.shape
    x = take_rows(params["item_emb"], history)
    x = x + params["pos_emb"][None, :l]
    mask = (history > 0).to(cfg.dtype)
    x = x * mask[..., None]
    causal = torch.ones((l, l), dtype=torch.bool,
                        device=history.device).tril()
    for blk in params["blocks"]:
        h = _layernorm(x, blk["ln1"])
        q, k, v = h @ blk["wq"], h @ blk["wk"], h @ blk["wv"]
        att = torch.einsum("bqd,bkd->bqk", q, k) / np.sqrt(q.shape[-1])
        att = torch.where(causal[None], att, -1e30)
        att = torch.where(mask[:, None, :] > 0, att, -1e30)
        att = torch.softmax(att, dim=-1)
        x = x + torch.einsum("bqk,bkd->bqd", att, v)
        h = _layernorm(x, blk["ln2"])
        x = x + (torch.relu(h @ blk["ffn1"]["w"] + blk["ffn1"]["b"])
                 @ blk["ffn2"]["w"] + blk["ffn2"]["b"])
        x = x * mask[..., None]
    return _layernorm(x, params["ln_f"])


def sasrec_forward(cfg: RecsysConfig, params: dict, batch: dict
                   ) -> torch.Tensor:
    """Next-item logit for (pos_items, neg_items): returns [B, L, 2] logits."""
    h = sasrec_hidden(cfg, params, batch["history"])       # [B, L, D]
    pos = take_rows(params["item_emb"], batch["pos_items"])
    neg = take_rows(params["item_emb"], batch["neg_items"])
    return torch.stack([torch.sum(h * pos, -1), torch.sum(h * neg, -1)],
                       dim=-1)


# ==========================================================================
# MIND (arXiv:1904.08030)
# ==========================================================================

def mind_init(gen, cfg: RecsysConfig, *, device) -> dict:
    d = cfg.embed_dim
    v = cfg.vocab_sizes[0]
    ks = iter(split_keys(gen, 3))
    return {
        "item_emb": normal_init(next(ks), (-(-(v + 1) // 4096) * 4096, d),
                                1.0 / np.sqrt(d), device=device),
        "bilinear": normal_init(next(ks), (d, d), 1.0 / np.sqrt(d),
                                device=device),
        # fixed (non-trained in paper) routing-logit init, one per interest
        "b_init": normal_init(next(ks), (cfg.n_interests, cfg.seq_len), 1.0,
                              device=device),
    }


def _squash(x, axis=-1, eps=1e-9):
    n2 = torch.sum(x * x, dim=axis, keepdim=True)
    return (n2 / (1.0 + n2)) * x / torch.sqrt(n2 + eps)


def mind_interests(cfg: RecsysConfig, params: dict, history: torch.Tensor
                   ) -> torch.Tensor:
    """Dynamic routing: history [B, L] -> interest capsules [B, K, D]."""
    e = take_rows(params["item_emb"], history)               # [B, L, D]
    mask = (history > 0).to(cfg.dtype)                       # [B, L]
    u_hat = e @ params["bilinear"]                           # [B, L, D]
    b = params["b_init"][None].expand(
        (history.shape[0],) + tuple(params["b_init"].shape))
    v = None
    for it in range(cfg.capsule_iters):
        w = torch.softmax(b, dim=1)                          # over K
        w = w * mask[:, None, :]
        z = torch.einsum("bkl,bld->bkd", w, u_hat)
        v = _squash(z)
        if it < cfg.capsule_iters - 1:
            # detached per the paper's routing (coefficients not trained)
            b = b + torch.einsum("bkd,bld->bkl", v.detach(), u_hat)
    return v


def mind_forward(cfg: RecsysConfig, params: dict, batch: dict
                 ) -> torch.Tensor:
    """Label-aware attention score for pos/neg targets: [B, 2] logits."""
    v = mind_interests(cfg, params, batch["history"])        # [B, K, D]

    def score(items):
        e_t = take_rows(params["item_emb"], items)           # [B, D]
        att = torch.softmax(torch.einsum("bkd,bd->bk", v, e_t) ** 2, dim=-1)
        u = torch.einsum("bk,bkd->bd", att, v)
        return torch.sum(u * e_t, dim=-1)

    return torch.stack([score(batch["pos_items"]),
                        score(batch["neg_items"])], dim=-1)


# ==========================================================================
# shared losses / serving / retrieval
# ==========================================================================

_FORWARD = {"dlrm": dlrm_forward, "autoint": autoint_forward,
            "sasrec": sasrec_forward, "mind": mind_forward}
_INIT = {"dlrm": dlrm_init, "autoint": autoint_init,
         "sasrec": sasrec_init, "mind": mind_init}


def init_params(gen: torch.Generator, cfg: RecsysConfig, *,
                device=None) -> dict:
    """Params of ``cfg`` drawn from ``gen`` (a generator on ``device``),
    on ``device`` (default ``cuda``; ``meta`` gives the shapes alone, as
    ``jax.eval_shape`` of the reference's ``init_params`` does)."""
    meta = device is not None and torch.device(device).type == "meta"
    dev = torch.device("meta") if meta else resolve_device(device)
    return _INIT[cfg.model](gen, cfg, device=dev)


_TABLES = ("table", "item_emb")


def _partitioned(params: dict, batch: dict) -> bool:
    table = next(params[k] for k in _TABLES if k in params)
    return sharding.is_partitioned(table) or any(
        sharding.is_partitioned(v) for v in batch.values())


def _local_forward(fn, cfg: RecsysConfig, params: dict, batch: dict):
    """``fn(cfg, params, batch)`` on ``DTensor`` params and batch as one
    rank's program on its own rows of the batch (every leaf split alike on
    dim 0, or replicated): every weight but the tables is gathered over
    the data axes first (FSDP; its gradient, each rank's rows' share,
    leaves ``Partial`` over the dims that split the batch and is
    reduce-scattered back), each table is a :class:`_RowShards`, and the
    result is split as the batch is."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    from .common import tree_map

    mesh = next(v for v in (*params.values(), *batch.values())
                if sharding.is_dtensor(v)).device_mesh
    bp = next((list(v.placements) for v in batch.values()
               if sharding.is_dtensor(v)), [Replicate()] * mesh.ndim)
    wgrad = [Partial() if p.is_shard() else Replicate() for p in bp]

    def weight(w):
        return sharding.gathered_over_data(sharding.as_dtensor(
            w, mesh)).to_local(grad_placements=wgrad)

    local = {}
    for k, v in params.items():
        if k in _TABLES:
            t = sharding.as_dtensor(v, mesh)
            tp = list(t.placements)
            local[k] = _RowShards(t.to_local(grad_placements=_row_grads(
                tp, bp)), mesh, tp, bp, t.shape[0])
        else:
            local[k] = tree_map(weight, v)
    out = fn(cfg, local, {k: v.to_local() if sharding.is_dtensor(v) else v
                          for k, v in batch.items()})
    return DTensor.from_local(out, mesh, bp, run_check=False)


def forward(cfg: RecsysConfig, params: dict, batch: dict) -> torch.Tensor:
    fn = _FORWARD[cfg.model]
    if _partitioned(params, batch):
        return _local_forward(fn, cfg, params, batch)
    return fn(cfg, params, batch)


def loss_fn(cfg: RecsysConfig, params: dict, batch: dict
            ) -> tuple[torch.Tensor, dict]:
    logits = forward(cfg, params, batch)
    if cfg.model in ("dlrm", "autoint"):                     # CTR: BCE w/ labels
        labels = batch["labels"].float()
        loss = torch.mean(_bce(logits.float(), labels))
    else:                                                    # pos/neg pairs
        lg = logits.float()
        pos, neg = lg[..., 0], lg[..., 1]
        mask = (batch["pos_items"] > 0).float()
        loss = ((_bce(pos, torch.ones_like(pos)) +
                 _bce(neg, torch.zeros_like(neg))) * mask).sum() \
            / torch.clamp_min(mask.sum(), 1.0)
    return loss, {"loss": loss}


def _bce(logits, labels):
    return torch.clamp_min(logits, 0) - logits * labels + \
        torch.log1p(torch.exp(-torch.abs(logits)))


def retrieval_scores(cfg: RecsysConfig, params: dict, batch: dict,
                     candidates: torch.Tensor) -> torch.Tensor:
    """Score a query-user against [Nc] candidate items (batched dot).

    On ``DTensor`` candidates each rank scores its own: a sequence model's
    dot takes the rank's candidate rows, a CTR model runs its forward on
    the rank's ``b × nc_local`` rows; the scores are split on dim 1 as the
    candidates are on dim 0."""
    if cfg.model in ("sasrec", "mind"):
        # the user tower: [B, D] (SASRec's last state) or [B, K, D]
        tower = _TOWER[cfg.model]
        if _partitioned(params, batch):
            u = _local_forward(tower, cfg, params, batch)
        else:
            u = tower(cfg, params, batch)
        cand = take_rows(params["item_emb"], candidates)          # [Nc, D]
        if cfg.model == "sasrec":
            return u @ cand.T                                     # [B, Nc]
        return torch.einsum("bkd,nd->bkn", u, cand).amax(dim=1)   # max-interest
    if sharding.is_partitioned(candidates):
        return _partitioned_ctr_scores(cfg, params, batch, candidates)
    rep = _ctr_rows(batch["sparse"], batch["dense"] if cfg.n_dense else None,
                    candidates)
    return forward(cfg, params, rep).reshape(batch["sparse"].shape[0],
                                             candidates.shape[0])


def _ctr_rows(sparse, dense, cand):
    """A CTR model's ``retrieval_scores`` batch: each of the ``b`` users'
    rows once a candidate (``b × nc`` rows, user-major), the candidate id
    in the item field (field 0 by convention, whatever that field's
    vocabulary); ``dense`` None where the model has no dense features."""
    nc = cand.shape[0]
    rows = sparse.repeat_interleave(nc, dim=0)                    # a copy
    rows[:, 0] = cand.repeat(sparse.shape[0])
    rep = {"sparse": rows}
    if dense is not None:
        rep["dense"] = dense.repeat_interleave(nc, dim=0)
    return rep


_TOWER = {
    "sasrec": lambda cfg, p, b: sasrec_hidden(cfg, p, b["history"])[:, -1],
    "mind": lambda cfg, p, b: mind_interests(cfg, p, b["history"])}


def _partitioned_ctr_scores(cfg, params, batch, candidates):
    """A CTR model's ``retrieval_scores`` on ``DTensor`` candidates: each
    rank builds the ``b × nc_local`` rows of its own candidates (the
    batch, replicated, taken whole) and runs the forward on them as a
    batch split like the candidates; its ``[b, nc_local]`` logits are its
    block of the scores' dim 1."""
    from torch.distributed.tensor import DTensor, Shard

    mesh = candidates.device_mesh
    cp = list(candidates.placements)
    local = candidates.to_local()
    b, nc = batch["sparse"].shape[0], local.shape[0]
    rep = _ctr_rows(sharding.replicated_local(batch["sparse"]),
                    sharding.replicated_local(batch["dense"])
                    if cfg.n_dense else None, local)
    rep = {key: DTensor.from_local(x, mesh, cp, run_check=False)
           for key, x in rep.items()}
    logits = forward(cfg, params, rep).to_local().reshape(b, nc)
    return DTensor.from_local(
        logits, mesh, [Shard(1) if p.is_shard() else p for p in cp],
        run_check=False, shape=(b, candidates.shape[0]),
        stride=(candidates.shape[0], 1))


def reduced(cfg: RecsysConfig, **overrides) -> RecsysConfig:
    small = dict(
        vocab_sizes=tuple(min(v, 1000) for v in cfg.vocab_sizes),
        seq_len=min(cfg.seq_len, 10),
    )
    if cfg.bot_mlp:
        small["bot_mlp"] = (32, cfg.embed_dim)
    if cfg.top_mlp:
        small["top_mlp"] = (32, 1)
    small.update(overrides)
    return replace(cfg, **small)
