"""Shared model components: norms, RoPE, initializers, masking.

The port's counterpart of ``repro.models.common``. Params are trees
(dicts, lists and tuples) of torch tensors, every module a ``(params, x)
-> y`` function on tensors. Initializers draw from an explicit
:class:`torch.Generator` on the parameters' device; :func:`split_keys`
stands in for ``jax.random.split``, and the ``meta`` device for
``jax.eval_shape`` (no memory, no draw).
"""

from __future__ import annotations

import numpy as np
import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, *, eps: float = 1e-6,
             plus_one: bool = False) -> torch.Tensor:
    """RMSNorm; ``plus_one`` selects the Gemma ``(1 + w)`` convention."""
    dt = x.dtype
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    x32 = x32 * torch.rsqrt(var + eps)
    w = weight.float()
    w = 1.0 + w if plus_one else w
    return (x32 * w).to(dt)


def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *, theta: float
               ) -> torch.Tensor:
    """Rotary embedding. x: [..., S, n_heads, head_dim]; positions: [..., S]."""
    hd = x.shape[-1]
    freqs = torch.as_tensor(rope_freqs(hd, theta), dtype=torch.float32,
                            device=x.device)
    ang = positions[..., None].float() * freqs                   # [..., S, hd/2]
    cos = torch.cos(ang)[..., None, :]                           # [..., S, 1, hd/2]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def causal_window_mask(q_pos: torch.Tensor, k_pos: torch.Tensor,
                       window: torch.Tensor | int) -> torch.Tensor:
    """True where key j may attend query i: causal ∧ (window==0 ∨ i-j<window).

    ``window`` is an int or a tensor scalar (a per-layer value), 0 meaning
    full (dense causal) attention. It is read as a host int, so a mask on
    the card costs no copy to the device.
    """
    causal = k_pos[None, :] <= q_pos[:, None]
    w = int(window)
    limit = w if w > 0 else torch.iinfo(torch.int32).max
    dist_ok = (q_pos[:, None] - k_pos[None, :]) < limit
    return causal & dist_ok


def uniform_init(gen: torch.Generator, shape, scale: float,
                 dtype=torch.float32, *, device=None) -> torch.Tensor:
    """U(-scale, scale) drawn from ``gen`` on ``device`` (default: the
    generator's); on ``meta`` an empty tensor of the shape."""
    device = torch.device(gen.device if device is None else device)
    out = torch.empty(tuple(shape), dtype=dtype, device=device)
    if device.type == "meta":
        return out
    return out.uniform_(-scale, scale, generator=gen)


def normal_init(gen: torch.Generator, shape, stddev: float,
                dtype=torch.float32, *, device=None) -> torch.Tensor:
    """N(0, 1) · ``stddev`` drawn from ``gen`` on ``device`` (default: the
    generator's); on ``meta`` an empty tensor of the shape."""
    device = torch.device(gen.device if device is None else device)
    if device.type == "meta":
        return torch.empty(tuple(shape), dtype=dtype, device=device)
    return torch.randn(tuple(shape), generator=gen, dtype=dtype,
                       device=device).mul_(stddev)


def split_keys(gen: torch.Generator, n: int) -> list[torch.Generator]:
    """``n`` generators on ``gen``'s device, seeded by ``n`` draws from
    ``gen``: one generator a parameter, as ``jax.random.split`` gives one
    key a parameter, so a draw never depends on another's size."""
    seeds = torch.randint(0, 2 ** 62, (n,), generator=gen,
                          device=gen.device).tolist()
    return [torch.Generator(device=gen.device).manual_seed(s) for s in seeds]


def tree_map(fn, tree):
    """``fn`` applied to every leaf of a tree of dicts, lists and tuples
    (named ones too); the result has the tree's structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v) for v in tree]
        return type(tree)(*out) if hasattr(tree, "_fields") else type(tree)(
            out)
    return fn(tree)


def tree_leaves(tree) -> list:
    """The leaves of a tree of dicts, lists and tuples, in order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def count_params(params) -> int:
    return int(sum(int(np.prod(x.shape)) for x in tree_leaves(params)))


def cast_tree(params, dtype):
    return tree_map(
        lambda x: x.to(dtype) if x.is_floating_point() else x, params)


def tree_paths(tree, prefix: tuple = ()) -> list:
    """``(path, leaf)`` pairs in ``jax.tree_util``'s order: a dict's keys
    sorted, a list's or tuple's items in order; a path holds the keys and
    indices that lead to the leaf."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in tree_paths(tree[k], prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in tree_paths(v, prefix + (i,))]
    return [(prefix, tree)]


def tree_unflatten(like, leaves):
    """A tree of ``like``'s structure (its dicts' key order kept) holding
    ``leaves``, given in :func:`tree_paths`' order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            out = dict.fromkeys(t)
            for k in sorted(t):
                out[k] = build(t[k])
            return out
        if isinstance(t, (list, tuple)):
            vals = [build(v) for v in t]
            return type(t)(*vals) if hasattr(t, "_fields") else type(t)(
                vals)
        return next(it)

    return build(like)
