"""Train-step builder: microbatched grad accumulation + AdamW update.

The port's counterpart of ``repro.train.step``. ``make_train_step`` turns
a per-example ``loss_fn(params, batch) -> (loss, aux)`` into the step

    grads = (1/M) Σ_m grad(loss_fn)(params, microbatch_m)
    params, opt = adamw.update(clip(grads), opt, params)

Microbatches run one after another into a params-shaped f32 accumulator
(the reference's ``lax.scan``), so the activations are one microbatch's.
Optional int8 gradient compression with error feedback sits between
accumulation and the optimizer.

The step is functional: grads come from ``torch.autograd.grad`` over
detached aliases of the param leaves, and every result is a new tensor,
so the params, optimizer state and batch it is given are never written.
A step that raises midway leaves them bitwise as they were, which the
loop's retry relies on.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..models.common import tree_map, tree_paths, tree_unflatten
from .grad_compress import compress_grads, init_error_feedback
from .optimizer import AdamW


def _split_microbatches(batch: dict, n: int) -> dict:
    return tree_map(
        lambda x: x.reshape(n, x.shape[0] // n, *x.shape[1:])
        if isinstance(x, torch.Tensor) else x, batch)


def _microbatch(mbs: dict, i: int) -> dict:
    return tree_map(lambda x: x[i] if isinstance(x, torch.Tensor) else x,
                    mbs)


def value_and_grad(loss_fn: Callable, params, batch):
    """``(loss, aux), grads`` of ``loss_fn(params, batch)`` with respect to
    every floating-point leaf of ``params`` (zeros where a leaf is unused),
    without touching ``params``: the loss sees detached aliases."""
    leaves = [x for _, x in tree_paths(params)]
    work = [x.detach().requires_grad_(x.is_floating_point())
            for x in leaves]
    with torch.enable_grad():
        loss, aux = loss_fn(tree_unflatten(params, work), batch)
        wrt = [w for w in work if w.requires_grad]
        got = iter(torch.autograd.grad(loss, wrt, allow_unused=True))
    grads = []
    for w in work:
        g = next(got) if w.requires_grad else None
        grads.append(torch.zeros_like(w) if g is None else g)
    aux = tree_map(lambda a: a.detach() if isinstance(a, torch.Tensor)
                   else a, aux)
    return (loss.detach(), aux), tree_unflatten(params, grads)


def make_train_step(loss_fn: Callable, optimizer: AdamW, *,
                    n_microbatches: int = 1,
                    compress: bool = False) -> Callable:
    """Returns ``train_step(params, opt_state, batch) -> (params, opt, metrics)``.

    ``opt_state`` carries {"m","v","step"} and, when ``compress``, an "ef"
    error-feedback tree.
    """

    def train_step(params, opt_state, batch):
        if n_microbatches > 1:
            mbs = _split_microbatches(batch, n_microbatches)
            acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                   for _, p in tree_paths(params)]
            losses = []
            for i in range(n_microbatches):
                (loss, _), g = value_and_grad(loss_fn, params,
                                              _microbatch(mbs, i))
                acc = [a + x.float() for a, (_, x)
                       in zip(acc, tree_paths(g), strict=True)]
                losses.append(loss)
                del g
            grads = tree_unflatten(params,
                                   [a / n_microbatches for a in acc])
            del acc
            loss = torch.stack(losses).mean()
        else:
            (loss, _metrics), grads = value_and_grad(loss_fn, params, batch)

        if compress:
            grads, ef = compress_grads(grads, opt_state["ef"])

        new_params, new_opt, om = optimizer.update(
            grads, {k: opt_state[k] for k in ("m", "v", "step")}, params)
        if compress:
            new_opt["ef"] = ef
        metrics = {"loss": loss, **om}
        return new_params, new_opt, metrics

    return train_step


def init_train_state(params, optimizer: AdamW, *, compress: bool = False):
    state = optimizer.init(params)
    if compress:
        state["ef"] = init_error_feedback(params)
    return state
