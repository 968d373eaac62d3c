"""int8 gradient compression with error feedback, in torch.

The port's counterpart of ``repro.train.grad_compress``: each gradient
tensor plus its residual is quantized to int8 with a per-tensor scale
(what would travel the wire), dequantized, and the quantization residual
is carried to the next step so the bias vanishes over steps (1-bit-Adam /
EF-SGD lineage). ``torch.round`` rounds half to even, as ``jnp.round``
does, so the codes are the reference's.
"""

from __future__ import annotations

import torch

from ..models.common import tree_map, tree_paths, tree_unflatten


def init_error_feedback(params) -> dict:
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params)


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    scale = torch.clamp_min(torch.max(torch.abs(x)), 1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_grads(grads, ef_state):
    """Quantize grads+residual to int8; returns (dequantized, new residual)."""
    def one(g, e):
        x = g.float() + e
        q, s = quantize_int8(x)
        deq = dequantize_int8(q, s)
        return deq, x - deq

    flat_g = [x for _, x in tree_paths(grads)]
    flat_e = [x for _, x in tree_paths(ef_state)]
    out = [one(g, e) for g, e in zip(flat_g, flat_e, strict=True)]
    return (tree_unflatten(grads, [o[0] for o in out]),
            tree_unflatten(grads, [o[1] for o in out]))
