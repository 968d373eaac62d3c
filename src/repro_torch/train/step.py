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


def microbatch_count(batch: dict, n: int) -> int:
    """How many microbatches a step made for ``n`` runs on ``batch``:
    ``n`` on plain tensors; on a ``DTensor`` batch ``gcd(rows, n)``, where
    ``rows`` are a rank's own (a microbatch never moves a row between
    ranks, nor splits one). With one row a rank that is 1, whatever
    ``n``: the step is then the one-microbatch step. The dry run records
    it beside ``n``."""
    import math

    from ..dist.sharding import is_dtensor

    rows = [x.to_local().shape[0] for x in batch.values() if is_dtensor(x)]
    return math.gcd(rows[0], n) if rows else n


def _split_microbatches(batch: dict, n: int) -> list[dict]:
    """``batch`` as microbatches. A tensor leaf's ``i``-th of ``n`` is row
    block ``i`` of ``x.reshape(n, B // n, ...)`` (the reference's); a
    ``DTensor``'s is made of each rank's ``i``-th block of its own rows,
    with the same placements, and there are :func:`microbatch_count` of
    them."""
    from ..dist.sharding import is_dtensor

    n = microbatch_count(batch, n)

    def split(x):
        if not isinstance(x, torch.Tensor):
            return [x] * n
        if not is_dtensor(x):
            return list(x.reshape(n, x.shape[0] // n, *x.shape[1:]))
        from torch.distributed.tensor import DTensor

        local = x.to_local()
        per = local.shape[0] // n
        shape = (x.shape[0] // n, *x.shape[1:])
        stride = torch.empty(shape, device="meta").stride()
        return [DTensor.from_local(local[i * per:(i + 1) * per],
                                   x.device_mesh, x.placements,
                                   run_check=False, shape=shape,
                                   stride=stride) for i in range(n)]

    parts = {k: split(v) for k, v in batch.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


def _like_params(grads, params):
    """Each ``DTensor`` gradient redistributed to its param's placements
    (the data-parallel reduction: a reduce-scatter where the param is
    sharded, an all-reduce where it is replicated; a plain param's
    gradient comes back plain); plain gradients as they are."""
    from torch.distributed.tensor import Replicate

    from ..dist.sharding import is_dtensor

    def like(g, p):
        if not is_dtensor(g):
            return g
        if is_dtensor(p):
            return g.redistribute(p.device_mesh, p.placements)
        return g.redistribute(g.device_mesh,
                              [Replicate()] * g.device_mesh.ndim).to_local()

    return tree_unflatten(params, [
        like(g, p) for (_, g), (_, p)
        in zip(tree_paths(grads), tree_paths(params), strict=True)])


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
            acc = [torch.zeros_like(p, dtype=torch.float32)
                   for _, p in tree_paths(params)]
            losses = []
            for mb in mbs:
                (loss, _), g = value_and_grad(loss_fn, params, mb)
                g = _like_params(g, params)
                acc = [a + x.float() for a, (_, x)
                       in zip(acc, tree_paths(g), strict=True)]
                losses.append(loss)
                del g
            grads = tree_unflatten(params, [a / len(mbs) for a in acc])
            del acc
            loss = torch.stack(losses).mean()
        else:
            (loss, _metrics), grads = value_and_grad(loss_fn, params, batch)
            grads = _like_params(grads, params)

        if compress:
            grads, ef = compress_grads(grads, opt_state["ef"])

        new_params, new_opt, om = optimizer.update(
            grads, {k: opt_state[k] for k in ("m", "v", "step")}, params)
        if compress:
            new_opt["ef"] = ef
        metrics = {"loss": loss, **om}
        return new_params, new_opt, metrics

    train_step.n_microbatches = n_microbatches
    return train_step


def init_train_state(params, optimizer: AdamW, *, compress: bool = False):
    state = optimizer.init(params)
    if compress:
        state["ef"] = init_error_feedback(params)
    return state
