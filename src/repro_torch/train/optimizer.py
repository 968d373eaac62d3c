"""AdamW + LR schedules + global-norm clipping, in torch.

The port's counterpart of ``repro.train.optimizer``, with its arithmetic:
f32 moments, bias correction from ``step + 1``, decoupled weight decay on
the f32 param, the update cast to the param's dtype. Optimizer state is a
params-shaped tree ``{"m", "v"}`` of f32 tensors and an int32 0-d
``"step"``; ``update`` builds new tensors and writes into none it is
given. Leaves are visited in ``jax.tree_util``'s order (dict keys sorted),
so the global norm sums them in the reference's order.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import torch

from ..models.common import tree_map, tree_paths, tree_unflatten


def cosine_schedule(*, peak_lr: float, warmup_steps: int, total_steps: int,
                    min_ratio: float = 0.1
                    ) -> Callable[[torch.Tensor], torch.Tensor]:
    def lr(step):
        step = step.float()
        warm = peak_lr * (step + 1.0) / max(warmup_steps, 1)
        t = torch.clamp((step - warmup_steps) /
                        max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = peak_lr * (min_ratio + (1 - min_ratio) * 0.5 *
                         (1 + torch.cos(math.pi * t)))
        return torch.where(step < warmup_steps, warm, cos)
    return lr


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for _, x in tree_paths(tree)))


def clip_by_global_norm(tree, max_norm: float):
    norm = global_norm(tree)
    scale = torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-9), 1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), tree), norm


@dataclass(frozen=True)
class AdamW:
    lr: Callable[[torch.Tensor], torch.Tensor] | float = 1e-3
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: float | None = 1.0

    def init(self, params) -> dict:
        """Zero moments shaped like ``params`` (f32) and step 0 (int32),
        on the params' device (``meta`` params give ``meta`` state)."""
        leaves = [x for _, x in tree_paths(params)]
        dev = leaves[0].device if leaves else None
        zeros = lambda: tree_map(  # noqa: E731
            lambda p: torch.zeros_like(p, dtype=torch.float32), params)
        return {"m": zeros(), "v": zeros(),
                "step": torch.zeros((), dtype=torch.int32, device=dev)}

    def update(self, grads, state: dict, params) -> tuple:
        """Returns (new_params, new_state, metrics)."""
        grads = tree_map(lambda g: g.float(), grads)
        if self.clip_norm is not None:
            grads, gnorm = clip_by_global_norm(grads, self.clip_norm)
        else:
            gnorm = global_norm(grads)
        step = state["step"] + 1
        if callable(self.lr):
            lr = self.lr(step)
        else:
            lr = torch.tensor(self.lr, dtype=torch.float32,
                              device=step.device)
        b1, b2 = self.b1, self.b2
        bc1 = 1 - torch.pow(b1, step.float())
        bc2 = 1 - torch.pow(b2, step.float())

        def upd(p, g, m, v):
            # the reference's expressions, one temporary at a time: each
            # in-place op acts on a tensor made here, never on an input
            m = (b1 * m).add_((1 - b1) * g)
            v = (b2 * v).add_(((1 - b2) * g).mul_(g))
            delta = (m / bc1).div_(torch.sqrt(v / bc2).add_(self.eps))
            delta = delta.add_(self.weight_decay * p.float()).to(p.dtype)
            return (p - delta.mul_(lr)).to(p.dtype), m, v

        flat_p = [x for _, x in tree_paths(params)]
        flat_g = [x for _, x in tree_paths(grads)]
        flat_m = [x for _, x in tree_paths(state["m"])]
        flat_v = [x for _, x in tree_paths(state["v"])]
        out = [upd(p, g, m, v) for p, g, m, v
               in zip(flat_p, flat_g, flat_m, flat_v, strict=True)]
        new_p = tree_unflatten(params, [o[0] for o in out])
        new_m = tree_unflatten(params, [o[1] for o in out])
        new_v = tree_unflatten(params, [o[2] for o in out])
        return new_p, {"m": new_m, "v": new_v, "step": step}, \
            {"grad_norm": gnorm, "lr": lr}
