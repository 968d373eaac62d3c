"""LM decode engine: slot-based continuous batching over ragged positions.

The port's counterpart of ``repro.serve.decode_engine``. The decode cells
use the lockstep ``decode_step`` (whole batch at one position). Serving
needs per-request positions; this engine keeps a fixed batch of SLOTS,
each with its own position and ring cache row, and advances all active
slots in one step per token (``decode_step_ragged``). Finished slots are
refilled from the queue; every shape is fixed by ``n_slots`` and
``max_seq``. A step is a plain call (the reference jits it) and syncs
the host once, for the greedy ids.

The reference's ragged step ignores ``kv_quant`` (R3 in ROADMAP §3): it
casts unquantized k and v to int8, reads them back without scales and
drops the scales from the cache it returns, so its engine over an int8
cache decodes from garbage. The port refuses such a config with
``ValueError`` instead of copying that.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from ..device import resolve_device
from ..models import transformer
from ..models.common import rms_norm
from ..models.transformer import (LMConfig, _embed, _layer, _qkv, _unembed,
                                  mlp_block, moe_block)


def _refuse_kv_quant(cfg: LMConfig) -> None:
    if cfg.kv_quant:
        raise ValueError(
            "R3: the ragged decode step has no int8 KV cache; the "
            "reference's casts unquantized k and v to int8 and drops the "
            "scales, so its engine over a kv_quant config decodes from "
            "garbage. Use a config with kv_quant=False, or the lockstep "
            "transformer.decode_step.")


@torch.inference_mode()
def decode_step_ragged(cfg: LMConfig, params: dict, cache: dict,
                       tokens: torch.Tensor, pos: torch.Tensor,
                       active: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """One token for every ACTIVE slot; slots carry independent positions.

    tokens, pos, active: [B]. Inactive slots compute but do not write
    cache. The cache passed in is updated IN PLACE (row b's slot
    ``pos[b] % S_i`` of each layer's k and v) and returned; its ``pos``
    is left as it was. Raises ``ValueError`` for a ``kv_quant`` config
    (R3).
    """
    _refuse_kv_quant(cfg)
    b = tokens.shape[0]
    h_heads, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    g = h_heads // kv
    x = _embed(cfg, params, tokens)[:, None, :]
    thetas = cfg.layer_thetas()
    scale = hd ** -0.5
    posv = pos[:, None]                                  # [B, 1]
    rows = torch.arange(b, device=x.device)

    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        ck, cv = cache["k"][i], cache["v"][i]
        s_i = ck.shape[1]
        h = rms_norm(x, lp["attn_norm"], eps=cfg.norm_eps,
                     plus_one=cfg.rmsnorm_plus_one)
        q, k, v = _qkv(cfg, lp, h, posv, float(thetas[i]))
        slot = (pos % s_i).long()                        # [B] per-row ring
        on = active[:, None, None]
        # one (row, slot) pair a row: each write has one writer
        ck.index_put_((rows, slot),
                      torch.where(on, k[:, 0].to(ck.dtype), ck[rows, slot]))
        cv.index_put_((rows, slot),
                      torch.where(on, v[:, 0].to(cv.dtype), cv[rows, slot]))
        n_valid = torch.clamp_max(pos + 1, s_i)[:, None]  # [B, 1]
        qh = q.reshape(b, kv, g, hd).float()
        s_ = torch.einsum("bkgh,bskh->bkgs", qh, ck.float()).mul_(scale)
        valid = torch.arange(s_i, device=x.device)[None, :] < n_valid
        s_.masked_fill_(~valid[:, None, None, :], -1e30)
        p = torch.softmax(s_, dim=-1)
        del s_
        att = torch.einsum("bkgs,bskh->bkgh", p, cv.float())
        att = att.reshape(b, 1, h_heads * hd).to(cfg.dtype)
        x = x + att @ lp["wo"].to(cfg.dtype)
        h = rms_norm(x, lp["mlp_norm"], eps=cfg.norm_eps,
                     plus_one=cfg.rmsnorm_plus_one)
        y = moe_block(cfg, lp, h)[0] if cfg.is_moe else mlp_block(cfg, lp, h)
        x = x + y

    x = rms_norm(x, params["final_norm"], eps=cfg.norm_eps,
                 plus_one=cfg.rmsnorm_plus_one)
    logits = (x[:, 0, :] @ _unembed(cfg, params)).float()
    return logits, {"k": cache["k"], "v": cache["v"], "pos": cache["pos"]}


@dataclass
class _Slot:
    request_id: int | None = None
    prompt: list[int] = field(default_factory=list)
    fed: int = 0                  # prompt tokens consumed
    generated: list[int] = field(default_factory=list)
    max_new: int = 16


class DecodeEngine:
    """Fixed-slot continuous batching around ``decode_step_ragged``.

    ``params`` live on ``device`` (default ``cuda``; ``ResidencyError``
    without one), where the cache is made. Raises ``ValueError`` for a
    ``kv_quant`` config (R3)."""

    def __init__(self, cfg: LMConfig, params, *, n_slots: int = 4,
                 max_seq: int = 256, greedy: bool = True, device=None):
        _refuse_kv_quant(cfg)
        self.cfg = cfg
        self.params = params
        self.n_slots = n_slots
        self.max_seq = max_seq
        self.device = resolve_device(device)
        self.cache = transformer.init_decode_cache(cfg, n_slots, max_seq,
                                                   device=self.device)
        self.pos = torch.zeros((n_slots,), dtype=torch.int32,
                               device=self.device)
        self.slots = [_Slot() for _ in range(n_slots)]
        self.queue: deque = deque()
        self.finished: dict[int, list[int]] = {}
        self._next_id = 0

    def submit(self, prompt_ids: list[int], *, max_new: int = 16) -> int:
        rid = self._next_id
        self._next_id += 1
        self.queue.append((rid, list(prompt_ids), max_new))
        return rid

    def _fill_slots(self) -> None:
        for i, s in enumerate(self.slots):
            if s.request_id is None and self.queue:
                rid, prompt, max_new = self.queue.popleft()
                self.slots[i] = _Slot(request_id=rid, prompt=prompt,
                                      max_new=max_new)
                self.pos[i] = 0

    @torch.inference_mode()
    def step(self) -> None:
        """Advance every active slot by one token (prefill or generate)."""
        self._fill_slots()
        tokens = np.zeros(self.n_slots, np.int32)
        active = np.zeros(self.n_slots, bool)
        for i, s in enumerate(self.slots):
            if s.request_id is None:
                continue
            active[i] = True
            if s.fed < len(s.prompt):
                tokens[i] = s.prompt[s.fed]
            else:
                tokens[i] = s.generated[-1]
        if not active.any():
            return
        # one upload a step: the ids and the active mask together
        up = torch.as_tensor(np.stack([tokens, active.astype(np.int32)]))
        up = up.to(self.device)
        act = up[1].bool()
        logits, self.cache = decode_step_ragged(
            self.cfg, self.params, self.cache, up[0], self.pos, act)
        nxt = torch.argmax(logits, dim=-1).cpu().numpy()   # the step's sync
        self.pos = self.pos + act.to(torch.int32)
        for i, s in enumerate(self.slots):
            if s.request_id is None:
                continue
            if s.fed < len(s.prompt):
                s.fed += 1
                if s.fed == len(s.prompt):
                    s.generated.append(int(nxt[i]))
            else:
                s.generated.append(int(nxt[i]))
            if len(s.generated) >= s.max_new:
                self.finished[s.request_id] = s.generated
                self.slots[i] = _Slot()

    def run_until_done(self, max_steps: int = 10_000) -> dict[int, list[int]]:
        for _ in range(max_steps):
            if not self.queue and all(s.request_id is None
                                      for s in self.slots):
                break
            self.step()
        return self.finished
