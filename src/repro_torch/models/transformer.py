"""Decoder-only LM transformer family.

The port's counterpart of ``repro.models.transformer``. One configurable
implementation covers the five LM architectures:

* GQA (``n_kv_heads < n_heads``), explicit ``head_dim`` (Gemma3's 256,
  danube3's 120);
* sliding-window attention (Mistral/danube3) and Gemma3's N:1
  local:global layer pattern with per-layer RoPE theta;
* optional qk-norm (Qwen3);
* SwiGLU dense MLP or Mixtral-style top-2 MoE (token-dispatch
  formulation, static capacity);
* a loop over the layer-stacked ``[L, ...]`` params for the forward and
  prefill, unrolled layers with per-layer window-capped ring KV caches
  for decode.

Params are plain dicts of tensors (the reference's pytrees), model code
plain functions on tensors. Serving (``prefill``, ``decode_step``) runs
under ``torch.inference_mode()``; training goes through ``forward`` and
``loss_fn`` under autograd, with ``torch.utils.checkpoint`` where the
reference remats (each layer, and each loss chunk so that its ``[B, cs,
V]`` logits are recomputed in the backward). The embedding gather is
``sparse.segment_ops.gather_rows``, whose backward sums each row's
gradients in a fixed order (``table[ids]``'s backward adds in no fixed
order on the CPU, ``index_select``'s with atomics on CUDA), so a train
step gives the same bits run to run. The arithmetic is the reference's:
projections, the MLP and the MoE in ``cfg.dtype``; norms and RoPE in f32;
attention scores and the PV product as f32 einsums over f32 copies of q,
k and v. Products are ``torch.matmul`` / ``einsum`` (TF32 stays off, as
torch leaves it), since the reference computes them outside any Pallas
kernel: this path launches none of the port's CUDA kernels.

Attention never materializes the full ``[S, S]`` score matrix: queries
are processed in ``seq_chunk`` blocks, each an exact softmax over all
keys; peak live memory is one chunk's scores.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..dist import sharding
from ..sparse.segment_ops import gather_rows
from .common import causal_window_mask, normal_init, rms_norm, split_keys


@dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int | None = None
    rope_theta: float = 10_000.0
    rope_theta_global: float | None = None   # gemma3: global layers use 1e6
    qk_norm: bool = False
    sliding_window: int | None = None        # None = full attention
    global_every: int | None = None          # every Nth layer is global
    n_experts: int | None = None             # None = dense MLP
    top_k: int = 2
    capacity_factor: float = 1.25
    embed_scale: bool = False                # gemma: h *= sqrt(d_model)
    rmsnorm_plus_one: bool = False           # gemma (1 + w) convention
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    dtype: Any = torch.bfloat16
    seq_chunk: int = 512                     # attention query-chunk
    loss_chunk: int = 512                    # logits/CE sequence-chunk
    moe_group_seq: int = 4096                # MoE dispatch group (tokens)
    kv_quant: bool = False                   # int8 KV cache (decode only)

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.n_experts is not None

    def layer_windows(self) -> np.ndarray:
        """Per-layer attention window; 0 = full (global) attention."""
        w = np.zeros(self.n_layers, dtype=np.int32)
        if self.sliding_window is not None:
            w[:] = self.sliding_window
            if self.global_every is not None:
                w[self.global_every - 1:: self.global_every] = 0
        return w

    def layer_thetas(self) -> np.ndarray:
        t = np.full(self.n_layers, self.rope_theta, dtype=np.float32)
        if self.rope_theta_global is not None and self.global_every:
            t[self.global_every - 1:: self.global_every] = self.rope_theta_global
        return t


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def init_params(gen: torch.Generator, cfg: LMConfig, *, device=None) -> dict:
    """f32 params of ``cfg`` drawn from ``gen`` (a generator on
    ``device``), on ``device`` (default ``cuda``; ``meta`` gives the shapes
    alone, as ``jax.eval_shape`` of the reference's ``init_params`` does)."""
    meta = device is not None and torch.device(device).type == "meta"
    dev = torch.device("meta") if meta else resolve_device(device)
    l, d, f, v = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    ks = iter(split_keys(gen, 16))
    s_in = 1.0 / np.sqrt(d)

    def norm(*shape):
        fill = torch.zeros if cfg.rmsnorm_plus_one else torch.ones
        return fill(shape, device=dev)

    def normal(shape, std):
        return normal_init(next(ks), shape, std, device=dev)

    layers = {
        "attn_norm": norm(l, d),
        "mlp_norm": norm(l, d),
        "wq": normal((l, d, h * hd), s_in),
        "wk": normal((l, d, kv * hd), s_in),
        "wv": normal((l, d, kv * hd), s_in),
        "wo": normal((l, h * hd, d), 1.0 / np.sqrt(h * hd)),
    }
    if cfg.qk_norm:
        layers["q_norm"] = torch.ones((l, hd), device=dev)
        layers["k_norm"] = torch.ones((l, hd), device=dev)
    if cfg.is_moe:
        e = cfg.n_experts
        layers["router"] = normal((l, d, e), s_in)
        layers["w_gate"] = normal((l, e, d, f), s_in)
        layers["w_up"] = normal((l, e, d, f), s_in)
        layers["w_down"] = normal((l, e, f, d), 1.0 / np.sqrt(f))
    else:
        layers["w_gate"] = normal((l, d, f), s_in)
        layers["w_up"] = normal((l, d, f), s_in)
        layers["w_down"] = normal((l, f, d), 1.0 / np.sqrt(f))
    params = {
        "embed": normal((v, d), 1.0),
        "layers": layers,
        "final_norm": norm(d),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((d, v), s_in)
    return params


def _layer(params: dict, i: int) -> dict:
    """Layer ``i``'s params: a view of each ``[L, ...]`` leaf."""
    return {k: p[i] for k, p in params["layers"].items()}


def _embed(cfg: LMConfig, params: dict, tokens: torch.Tensor
           ) -> torch.Tensor:
    """``params["embed"].astype(dtype)[tokens]`` (times ``sqrt(d_model)``
    rounded to ``cfg.dtype`` under ``embed_scale``).

    The rows are :func:`gather_rows`'s (a fixed-order backward). The
    reference's plain index: an id in ``[-rows, -1]`` counts from the
    end, and any id still outside the table clamps to its first or last
    row (no fill, no host sync, no device assert). The rows are gathered
    before the cast, which gives the same bits as casting the whole table
    first without copying it."""
    table = params["embed"]
    n = table.shape[0]
    ids = torch.where(tokens < 0, tokens + n, tokens).clamp_(0, n - 1)
    x = gather_rows(table, ids.reshape(-1)).view(
        *ids.shape, table.shape[1]).to(cfg.dtype)
    if cfg.embed_scale:
        x = x * float(torch.tensor(np.sqrt(cfg.d_model), dtype=cfg.dtype))
    return x


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------

def _heads(x, n, hd):
    return x.reshape(*x.shape[:-1], n, hd)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      q_pos: torch.Tensor, k_pos: torch.Tensor,
                      window, *, seq_chunk: int) -> torch.Tensor:
    """Exact causal/windowed attention, one query chunk at a time.

    q: [B, Sq, H, hd]; k, v: [B, Sk, KV, hd]; positions are absolute.
    Returns [B, Sq, H, hd]. Peak memory: one chunk's [B, H, Cq, Sk]
    scores. Every key block is scored and masked afterwards, as in the
    reference (none is skipped).
    """
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    g = h // kvh
    cq = min(seq_chunk, sq)
    while sq % cq:
        cq //= 2
    nc = sq // cq
    scale = hd ** -0.5

    qg = q.reshape(b, nc, cq, kvh, g, hd)
    posc = q_pos.reshape(nc, cq)
    k32, v32 = k.float(), v.float()
    out = torch.empty((b, nc, cq, kvh, g, hd), dtype=q.dtype,
                      device=q.device)
    for c in range(nc):
        s = torch.einsum("bqkgh,bskh->bkgqs", qg[:, c].float(),
                         k32).mul_(scale)                   # [B,KV,G,Cq,Sk]
        mask = causal_window_mask(posc[c], k_pos, window)   # [Cq, Sk]
        s.masked_fill_(~mask[None, None, None], -1e30)
        p = torch.softmax(s, dim=-1)
        del s
        out[:, c] = torch.einsum("bkgqs,bskh->bqkgh", p, v32)
    return out.reshape(b, sq, h, hd)


def _qkv(cfg: LMConfig, lp: dict, x: torch.Tensor, positions: torch.Tensor,
         theta) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Roped q, k and v of ``x`` in ``cfg.dtype``."""
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dt = cfg.dtype
    q = _heads(x @ lp["wq"].to(dt), h, hd)
    k = _heads(x @ lp["wk"].to(dt), kv, hd)
    v = _heads(x @ lp["wv"].to(dt), kv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, lp["q_norm"], eps=cfg.norm_eps)
        k = rms_norm(k, lp["k_norm"], eps=cfg.norm_eps)
    return _rope_dyn(q, positions, theta), _rope_dyn(k, positions, theta), v


def attention_block(cfg: LMConfig, lp: dict, x: torch.Tensor,
                    positions: torch.Tensor, window, theta) -> torch.Tensor:
    return _attention(cfg, lp, x, positions, window, theta)[0]


def _attention(cfg: LMConfig, lp: dict, x: torch.Tensor,
               positions: torch.Tensor, window, theta):
    """``attention_block``'s output, with the layer's roped k and v."""
    b, s, _ = x.shape
    h, hd = cfg.n_heads, cfg.hd
    q, k, v = _qkv(cfg, lp, x, positions, theta)
    # Megatron-style TP: query heads over "model" (replicated if H % model
    # != 0, e.g. Gemma3's 4 heads), K/V replicated across the model axis
    # (GQA standard when TP > n_kv_heads).
    q = sharding.constrain(q, "dp", None, "model", None)
    k = sharding.constrain(k, "dp", None, None, None)
    v = sharding.constrain(v, "dp", None, None, None)
    out = chunked_attention(q, k, v, positions, positions, window,
                            seq_chunk=cfg.seq_chunk)
    out = out.reshape(b, s, h * hd) @ lp["wo"].to(cfg.dtype)
    return sharding.constrain(out, "dp", None, None), k, v


def _rope_dyn(x, positions, theta):
    """RoPE with a per-layer theta (a float, or an f32 scalar tensor): the
    frequencies are ``theta ** -exponent`` in f32, as the reference's."""
    hd = x.shape[-1]
    exponent = torch.arange(0, hd, 2, dtype=torch.float32,
                            device=x.device) / hd
    freqs = torch.pow(theta, -exponent)
    ang = positions[..., None].float() * freqs
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# MLP / MoE
# --------------------------------------------------------------------------

def mlp_block(cfg: LMConfig, lp: dict, x: torch.Tensor) -> torch.Tensor:
    dt = cfg.dtype
    gate = F.silu(x @ lp["w_gate"].to(dt))
    gate = sharding.constrain(gate, "dp", None, "model")
    up = sharding.constrain(x @ lp["w_up"].to(dt), "dp", None, "model")
    out = (gate * up) @ lp["w_down"].to(dt)
    return sharding.constrain(out, "dp", None, None)


def moe_block(cfg: LMConfig, lp: dict, x: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k token-dispatch MoE (scatter/gather, static capacity).

    Returns (output, aux_load_balance_loss). Tokens beyond an expert's
    capacity are dropped (contribute zero), standard GShard behaviour.
    Dispatch runs per GROUP (GShard's G dimension): groups are
    (batch × seq-chunks of ``moe_group_seq``); the reference's ``vmap``
    over groups is the leading group dimension of :func:`_moe_tokens`.
    """
    b, s, d = x.shape
    g_seq = min(cfg.moe_group_seq, s)
    while s % g_seq:
        g_seq //= 2
    groups = b * (s // g_seq)
    xg = sharding.constrain(x.reshape(groups, g_seq, d), "dp", None, None)
    yg, aux = _moe_tokens(cfg, lp, xg)
    yg = sharding.constrain(yg, "dp", None, None)
    return yg.reshape(b, s, d), aux.mean()


def moe_capacity(cfg: LMConfig, t: int) -> int:
    """Slots an expert has in a group of ``t`` tokens."""
    return int(np.ceil(cfg.capacity_factor * t * cfg.top_k / cfg.n_experts))


def _top_k(probs: torch.Tensor, k: int):
    """``lax.top_k``: the k largest along the last dim, ties ordered by the
    lower index (a stable descending sort; ``torch.topk`` promises no
    order among ties)."""
    w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return w[..., :k], idx[..., :k]


def moe_route(cfg: LMConfig, logits: torch.Tensor, cap: int):
    """The router's decisions for f32 router logits ``[G, T, E]``.

    Returns ``(probs, w, idx, keep, slot)``: the softmax, the top-k
    weights (renormalized) and experts ``[G, T, K]``, and for each
    assignment in flattened (token, choice) order whether it fits its
    expert's ``cap`` slots and its slot in the ``[E·cap + 1]`` dispatch
    buffer (``E·cap``, the sentinel, for a dropped one), ``[G, T·K]``.
    An assignment's rank in its expert is the cumulative one-hot count in
    that order, as in the reference, so the same tokens are dropped."""
    g, t, e = logits.shape
    k = cfg.top_k
    probs = torch.softmax(logits, dim=-1)
    w, idx = _top_k(probs, k)
    w = w / torch.clamp_min(w.sum(-1, keepdim=True), 1e-9)
    flat_e = idx.reshape(g, t * k)
    oh = F.one_hot(flat_e, e)                                   # [G, T*K, E]
    pos = (torch.cumsum(oh, dim=1) * oh).sum(-1) - 1            # rank in expert
    keep = pos < cap
    slot = torch.where(keep, flat_e * cap + pos, e * cap)       # sentinel last
    return probs, w, idx, keep, slot


def _moe_tokens(cfg: LMConfig, lp: dict, xf: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """MoE over groups of flat token blocks xf [G, T, D] -> ([G, T, D],
    aux [G])."""
    dt = cfg.dtype
    g, t, d = xf.shape
    e, k = cfg.n_experts, cfg.top_k
    cap = moe_capacity(cfg, t)

    logits = (xf @ lp["router"].to(dt)).float()                 # [G, T, E]
    probs, w, idx, keep, slot = moe_route(cfg, logits, cap)

    # GShard aux loss: E * Σ_e f_e · p_e
    f_e = F.one_hot(idx[..., 0], e).float().mean(dim=1)
    p_e = probs.mean(dim=1)
    aux = e * torch.sum(f_e * p_e, dim=-1)

    # Dispatch: each kept assignment owns its slot, so every live row of
    # the buffer is written once (a copy, no float atomics); the dropped
    # ones all write zeros to the sentinel row, which is never read.
    rows = e * cap + 1
    base = torch.arange(g, device=xf.device)[:, None] * rows
    flat_slot = (slot + base).reshape(-1)                        # [G*T*K]
    x_rep = xf.repeat_interleave(k, dim=1)                       # [G, T*K, D]
    x_rep = x_rep * keep[..., None].to(dt)
    buf = torch.zeros((g * rows, d), dtype=dt, device=xf.device)
    buf.index_copy_(0, flat_slot, x_rep.reshape(-1, d))
    del x_rep
    buf = sharding.constrain(buf, None, None)   # group-local (+dp: groups)
    xin = buf.view(g, rows, d)[:, : e * cap].reshape(g, e, cap, d)

    gate = F.silu(torch.einsum("gecd,edf->gecf", xin, lp["w_gate"].to(dt)))
    gate = sharding.constrain(gate, None, None, None, "model")
    up = sharding.constrain(
        torch.einsum("gecd,edf->gecf", xin, lp["w_up"].to(dt)),
        None, None, None, "model")
    h = torch.einsum("gecf,efd->gecd", gate * up, lp["w_down"].to(dt))
    del gate, up, xin, buf

    hflat = torch.cat([h.reshape(g, e * cap, d),
                       torch.zeros((g, 1, d), dtype=dt, device=xf.device)],
                      dim=1)
    hflat = sharding.constrain(hflat, None, None, None)
    y = hflat.reshape(g * rows, d).index_select(0, flat_slot)
    y = y.reshape(g, t, k, d)
    y = (y * (w * keep.reshape(g, t, k)).to(dt)[..., None]).sum(dim=2)
    return y, aux


# --------------------------------------------------------------------------
# full forward (a loop over the layers)
# --------------------------------------------------------------------------

def _layer_fwd(cfg: LMConfig, lp: dict, x: torch.Tensor,
               positions: torch.Tensor, window, theta
               ) -> tuple[torch.Tensor, torch.Tensor]:
    h = rms_norm(x, lp["attn_norm"], eps=cfg.norm_eps,
                 plus_one=cfg.rmsnorm_plus_one)
    x = x + attention_block(cfg, lp, h, positions, window, theta)
    h = rms_norm(x, lp["mlp_norm"], eps=cfg.norm_eps,
                 plus_one=cfg.rmsnorm_plus_one)
    if cfg.is_moe:
        y, aux = moe_block(cfg, lp, h)
    else:
        y, aux = mlp_block(cfg, lp, h), torch.zeros((), device=x.device)
    return x + y, aux


def forward(cfg: LMConfig, params: dict, tokens: torch.Tensor,
            positions: torch.Tensor | None = None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Embed + all layers. Returns (hidden [B,S,D] in cfg.dtype, aux loss).

    Each layer runs under ``torch.utils.checkpoint`` (the reference's
    ``jax.checkpoint`` of its scan body): under autograd only its input is
    kept and its activations are recomputed in the backward. The layer
    params are ``unbind`` views of the ``[L, ...]`` leaves, whose backward
    stacks the L gradients once."""
    b, s = tokens.shape
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32, device=tokens.device)
    x = sharding.constrain(_embed(cfg, params, tokens), "dp", None, None)
    layers = {k: p.unbind(0) for k, p in params["layers"].items()}
    auxes = []
    for i, (win, th) in enumerate(zip(cfg.layer_windows(),
                                      cfg.layer_thetas())):
        lp = {k: v[i] for k, v in layers.items()}
        x, aux = checkpoint(_layer_fwd, cfg, lp, x, positions, int(win),
                            float(th), use_reentrant=False)
        auxes.append(aux)
    x = rms_norm(x, params["final_norm"], eps=cfg.norm_eps,
                 plus_one=cfg.rmsnorm_plus_one)
    return x, torch.stack(auxes).mean()


def _unembed(cfg: LMConfig, params: dict) -> torch.Tensor:
    if cfg.tie_embeddings:
        return params["embed"].T.to(cfg.dtype)
    return params["lm_head"].to(cfg.dtype)


def _chunk_ce(h: torch.Tensor, lab: torch.Tensor, head: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """One loss chunk's summed CE and its count of valid labels."""
    logits = (h @ head).float()                             # [B, cs, V]
    logits = sharding.constrain(logits, "dp", None, "model")  # vocab-sharded
    lse = torch.logsumexp(logits, dim=-1)
    safe = torch.clamp_min(lab, 0).long()
    gold = torch.gather(logits, -1, safe[..., None])[..., 0]
    valid = (lab >= 0).float()
    return ((lse - gold) * valid).sum(), valid.sum()


def loss_fn(cfg: LMConfig, params: dict, batch: dict
            ) -> tuple[torch.Tensor, dict]:
    """Next-token CE, computed in sequence chunks (logits never [B,S,V]).

    batch: tokens [B, S] int32, labels [B, S] int32 (-1 = ignore). Each
    chunk runs under ``torch.utils.checkpoint``, so under autograd its
    ``[B, cs, V]`` logits are recomputed in the backward instead of being
    kept for every chunk.
    """
    tokens, labels = batch["tokens"], batch["labels"]
    b, s = tokens.shape
    hidden, aux = forward(cfg, params, tokens)
    head = _unembed(cfg, params)

    cs = min(cfg.loss_chunk, s)
    while s % cs:
        cs //= 2
    ces, cnts = [], []
    for c0 in range(0, s, cs):
        h = sharding.constrain(hidden[:, c0:c0 + cs], "dp", None, None)
        ce_c, cnt = checkpoint(_chunk_ce, h, labels[:, c0:c0 + cs], head,
                               use_reentrant=False)
        ces.append(ce_c)
        cnts.append(cnt)
    n_tok = torch.clamp_min(torch.stack(cnts).sum(), 1.0)
    ce = torch.stack(ces).sum() / n_tok
    loss = ce + 0.01 * aux
    return loss, {"loss": loss, "ce": ce, "aux": aux, "n_tokens": n_tok}


# --------------------------------------------------------------------------
# prefill + decode (serving)
# --------------------------------------------------------------------------

@torch.inference_mode()
def prefill(cfg: LMConfig, params: dict, tokens: torch.Tensor
            ) -> tuple[torch.Tensor, dict]:
    """Full-sequence forward producing last-position logits + KV cache.

    The cache is uniform ``[L, B, S, KV, hd]`` (layer-stacked, written
    layer by layer into one preallocated tensor each for k and v); decode
    uses per-layer window-capped caches (``init_decode_cache``).
    """
    b, s = tokens.shape
    positions = torch.arange(s, dtype=torch.int32, device=tokens.device)
    x = sharding.constrain(_embed(cfg, params, tokens), "dp", None, None)
    kv, hd = cfg.n_kv_heads, cfg.hd
    shape = (cfg.n_layers, b, s, kv, hd)
    ks = torch.empty(shape, dtype=cfg.dtype, device=x.device)
    vs = torch.empty(shape, dtype=cfg.dtype, device=x.device)
    for i, (win, th) in enumerate(zip(cfg.layer_windows(),
                                      cfg.layer_thetas())):
        lp = _layer(params, i)
        h = rms_norm(x, lp["attn_norm"], eps=cfg.norm_eps,
                     plus_one=cfg.rmsnorm_plus_one)
        att, ks[i], vs[i] = _attention(cfg, lp, h, positions, int(win),
                                       float(th))
        x = x + att
        h = rms_norm(x, lp["mlp_norm"], eps=cfg.norm_eps,
                     plus_one=cfg.rmsnorm_plus_one)
        if cfg.is_moe:
            y, _ = moe_block(cfg, lp, h)
        else:
            y = mlp_block(cfg, lp, h)
        x = x + y
    x = rms_norm(x, params["final_norm"], eps=cfg.norm_eps,
                 plus_one=cfg.rmsnorm_plus_one)
    logits = (x[:, -1, :] @ _unembed(cfg, params)).float()
    pos = torch.full((), s, dtype=torch.int32, device=x.device)
    return logits, {"k": ks, "v": vs, "pos": pos}


def decode_cache_shapes(cfg: LMConfig, batch: int, seq_len: int
                        ) -> list[tuple[int, int, int, int]]:
    """Per-layer decode cache shapes: [B, min(S, window_i or S), KV, hd]."""
    out = []
    for w in cfg.layer_windows():
        s_i = seq_len if w == 0 else min(seq_len, int(w))
        out.append((batch, s_i, cfg.n_kv_heads, cfg.hd))
    return out


def init_decode_cache(cfg: LMConfig, batch: int, seq_len: int,
                      dtype=None, *, device=None) -> dict:
    """KV cache on ``device`` (default ``cuda``; ``meta`` for shapes);
    with ``cfg.kv_quant`` entries are int8 + per-(pos, head) scales
    (KIVI-style per-token quantization: half the bytes of a bf16 cache)."""
    meta = device is not None and torch.device(device).type == "meta"
    dev = torch.device("meta") if meta else resolve_device(device)
    dtype = dtype or cfg.dtype
    shapes = decode_cache_shapes(cfg, batch, seq_len)
    cache = {
        # decode continues at S
        "pos": torch.full((), seq_len, dtype=torch.int32, device=dev),
    }
    if cfg.kv_quant:
        cache["k"] = [torch.zeros(s, dtype=torch.int8, device=dev)
                      for s in shapes]
        cache["v"] = [torch.zeros(s, dtype=torch.int8, device=dev)
                      for s in shapes]
        cache["k_scale"] = [torch.ones(s[:3], device=dev) for s in shapes]
        cache["v_scale"] = [torch.ones(s[:3], device=dev) for s in shapes]
    else:
        cache["k"] = [torch.zeros(s, dtype=dtype, device=dev) for s in shapes]
        cache["v"] = [torch.zeros(s, dtype=dtype, device=dev) for s in shapes]
    return cache


def _kv_quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[B, 1, KV, hd] -> int8 values + per-(B, 1, KV) scale. Rounds half to
    even, as ``jnp.round``: the same bits as the reference's."""
    x32 = x.float()
    scale = torch.amax(torch.abs(x32), dim=-1) / 127.0
    scale = torch.clamp_min(scale, 1e-8)
    q = torch.clamp(torch.round(x32 / scale[..., None]),
                    -127, 127).to(torch.int8)
    return q, scale


def _kv_dequant(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale[..., None]


def _kv_full(cfg: LMConfig, cache: dict, name: str, i: int) -> torch.Tensor:
    """Layer ``i``'s cached keys or values (``name`` "k" or "v") in f32.
    Made one at a time: at decode_32k a global layer's are 4.3 GB each."""
    c = cache[name][i]
    if cfg.kv_quant:
        return _kv_dequant(c, cache[name + "_scale"][i])
    return c.float()


@torch.inference_mode()
def decode_step(cfg: LMConfig, params: dict, cache: dict,
                tokens: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """One decode step for the whole batch (lockstep position).

    tokens: [B] int32. Layers are unrolled so each layer keeps its own
    window-capped ring cache. The cache passed in is updated IN PLACE:
    each layer's slot ``pos % S_i`` is written into its k and v (and
    scale) tensors, and the returned cache holds those same tensors with
    ``pos + 1`` (the reference builds new arrays; a copy a step would move
    the whole cache). ``pos`` stays on the device: no host sync.
    """
    b = tokens.shape[0]
    h_heads, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    g = h_heads // kv
    pos = cache["pos"]
    x = _embed(cfg, params, tokens)[:, None, :]                 # [B,1,D]
    thetas = cfg.layer_thetas()
    scale = hd ** -0.5
    posv = pos[None]

    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        ck, cv = cache["k"][i], cache["v"][i]
        s_i = ck.shape[1]
        h = rms_norm(x, lp["attn_norm"], eps=cfg.norm_eps,
                     plus_one=cfg.rmsnorm_plus_one)
        q, k, v = _qkv(cfg, lp, h, posv, float(thetas[i]))
        slot = (pos % s_i).reshape(1).long()                    # ring index
        if cfg.kv_quant:
            kq, ks_ = _kv_quantize(k)
            vq, vs_ = _kv_quantize(v)
            cks, cvs = cache["k_scale"][i], cache["v_scale"][i]
            ck.index_copy_(1, slot, kq)
            cv.index_copy_(1, slot, vq)
            cks.index_copy_(1, slot, ks_)
            cvs.index_copy_(1, slot, vs_)
        else:
            ck.index_copy_(1, slot, k.to(ck.dtype))
            cv.index_copy_(1, slot, v.to(cv.dtype))
        n_valid = torch.clamp_max(pos + 1, s_i)
        qh = q.reshape(b, kv, g, hd).float()
        s_ = torch.einsum("bkgh,bskh->bkgs", qh,
                          _kv_full(cfg, cache, "k", i)).mul_(scale)
        valid = torch.arange(s_i, device=x.device) < n_valid
        s_.masked_fill_(~valid, -1e30)
        p = torch.softmax(s_, dim=-1)
        del s_
        att = torch.einsum("bkgs,bskh->bkgh", p, _kv_full(cfg, cache, "v", i))
        del p
        att = att.reshape(b, 1, h_heads * hd).to(cfg.dtype)
        x = x + att @ lp["wo"].to(cfg.dtype)
        h = rms_norm(x, lp["mlp_norm"], eps=cfg.norm_eps,
                     plus_one=cfg.rmsnorm_plus_one)
        if cfg.is_moe:
            y, _ = moe_block(cfg, lp, h)
        else:
            y = mlp_block(cfg, lp, h)
        x = x + y

    x = rms_norm(x, params["final_norm"], eps=cfg.norm_eps,
                 plus_one=cfg.rmsnorm_plus_one)
    logits = (x[:, 0, :] @ _unembed(cfg, params)).float()
    out_cache = {"k": cache["k"], "v": cache["v"], "pos": pos + 1}
    if cfg.kv_quant:
        out_cache["k_scale"] = cache["k_scale"]
        out_cache["v_scale"] = cache["v_scale"]
    return logits, out_cache


def reduced(cfg: LMConfig, **overrides) -> LMConfig:
    """Smoke-test-sized variant of a config (same family/features)."""
    small = dict(
        n_layers=min(cfg.n_layers, 2 if cfg.global_every is None
                     else cfg.global_every + 1),
        d_model=64, n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2), head_dim=16, d_ff=128,
        vocab_size=256,
        sliding_window=None if cfg.sliding_window is None else 16,
        n_experts=None if cfg.n_experts is None else 4,
        seq_chunk=16, loss_chunk=16,
        dtype=torch.float32,
    )
    small.update(overrides)
    return replace(cfg, **small)
