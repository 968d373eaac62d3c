"""Segment reductions — the shared sparse primitive, in torch.

The port's counterpart of ``repro.sparse.segment_ops`` (which stands on
``jax.ops.segment_sum`` / ``segment_max``): message passing, embedding
bags and BM25 scoring all reduce to ``out[s] += values[p]`` for ``s =
segment_ids[p]``. These are plain torch functions on tensors of any
device; no kernel is involved. They keep the reference's conventions:

* a segment reduction drops every id outside ``[0, num_segments)``, so
  ``num_segments`` is a sentinel id for padding (as ``jax.ops.segment_*``
  drops out-of-range ids);
* a gather by segment id (``segment_softmax``) follows ``jnp`` indexing:
  a negative id counts from the end and the result is clamped into range;
* ``scatter_add`` follows ``.at[idx].add(mode="drop")``: a negative index
  counts from the end, and what is still out of range is dropped.

Every sum here runs in one fixed order, on the CPU and on the card: a
segment adds its rows one after another in input order (a
:class:`SegmentPlan` sorts the ids once, stably, and
``torch.segment_reduce`` sums each segment's run serially, one thread a
column on CUDA), so a sum is the same bits run to run and on both
devices, and never goes through float atomics (``index_add_`` on CUDA
adds with atomics in no fixed order). The backward passes keep the
order too: :func:`segment_sum`'s is a gather, and :func:`gather_rows`
(a row gather whose backward sums the rows' gradients by id through a
plan) stands in for ``index_select`` and ``table[ids]`` wherever a
training path gathers rows (``index_select``'s backward is
``index_add_``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


def _kept(segment_ids, num_segments: int):
    return (segment_ids >= 0) & (segment_ids < num_segments)


@dataclass(frozen=True)
class SegmentPlan:
    """The fixed summation order of one id vector.

    ``order`` lists every row stably sorted by id, the dropped ones (ids
    outside ``[0, num_segments)``) last under the sentinel id
    ``num_segments``; ``lengths`` ``[num_segments + 1]`` counts each
    segment's rows (the last entry the dropped ones); ``ids`` is the id
    of each row with the dropped ones set to the sentinel. Made once, it
    serves every sum over the same ids (a layer's forward, its recompute
    and its backward)."""
    order: torch.Tensor
    lengths: torch.Tensor
    ids: torch.Tensor
    num_segments: int


def segment_plan(segment_ids, num_segments: int) -> SegmentPlan:
    """The :class:`SegmentPlan` of ``segment_ids`` (any integer dtype,
    1-D) over ``num_segments`` segments. No host sync."""
    ids = segment_ids.long()
    ids = torch.where(_kept(ids, num_segments), ids, num_segments)
    sorted_ids, order = torch.sort(ids, stable=True)
    edges = torch.searchsorted(
        sorted_ids, torch.arange(num_segments + 2, device=ids.device))
    return SegmentPlan(order=order, lengths=edges.diff(), ids=ids,
                       num_segments=num_segments)


def plan_sum(plan: SegmentPlan, values) -> torch.Tensor:
    """``[num_segments, ...]`` sums of ``values`` rows in ``plan``'s
    order: each segment's rows added serially in input order (the values
    are viewed 2-D so that ``segment_reduce`` runs its serial loop on
    CUDA too, never a tree)."""
    tail = values.shape[1:]
    flat = values.reshape(values.shape[0], -1).index_select(0, plan.order)
    out = torch.segment_reduce(flat, "sum", lengths=plan.lengths, axis=0,
                               unsafe=True)
    return out[:plan.num_segments].reshape(plan.num_segments, *tail)


class _SegmentSum(torch.autograd.Function):
    """:func:`plan_sum` whose backward is the gather of the output's
    gradient by id (zero for a dropped row): no sum, so no order."""

    @staticmethod
    def forward(ctx, values, plan):
        ctx.plan = plan
        return plan_sum(plan, values)

    @staticmethod
    def backward(ctx, grad):
        plan = ctx.plan
        pad = grad.new_zeros((1, *grad.shape[1:]))
        return torch.cat([grad, pad]).index_select(0, plan.ids), None


def segment_sum(values, segment_ids, num_segments: int, *,
                plan: SegmentPlan | None = None) -> torch.Tensor:
    """Sum of ``values`` rows by segment, ``[num_segments, ...]``; ids
    outside ``[0, num_segments)`` (the sentinel ``num_segments`` among
    them) are dropped. Each segment adds its rows in input order (the
    same bits as a serial ``index_add_``); ``plan`` is
    ``segment_plan(segment_ids, num_segments)`` made beforehand."""
    if plan is None:
        plan = segment_plan(segment_ids, num_segments)
    return _SegmentSum.apply(values, plan)


class _GatherRows(torch.autograd.Function):
    """``table.index_select(0, ids)`` whose backward sums the rows'
    gradients by id in a :class:`SegmentPlan`'s fixed order."""

    @staticmethod
    def forward(ctx, table, ids, plan):
        ctx.save_for_backward(ids)
        ctx.plan, ctx.n_rows = plan, table.shape[0]
        return table.index_select(0, ids)

    @staticmethod
    def backward(ctx, grad):
        plan = ctx.plan
        if plan is None:
            (ids,) = ctx.saved_tensors
            plan = segment_plan(ids, ctx.n_rows)
        return plan_sum(plan, grad), None, None


def gather_rows(table, ids, *, plan: SegmentPlan | None = None
                ) -> torch.Tensor:
    """``table[ids]`` for 1-D ``ids`` in ``[0, len(table))``: the same
    rows as ``index_select``, with a backward that adds the gradient of
    every row into its table row in input order (``plan``, if given, is
    ``segment_plan(ids, len(table))``, made once for several gathers)."""
    return _GatherRows.apply(table, ids.long(), plan)


def segment_mean(values, segment_ids, num_segments: int, *,
                 eps: float = 1e-9, plan: SegmentPlan | None = None
                 ) -> torch.Tensor:
    """Mean of ``values`` rows by segment; an empty segment gives 0."""
    if plan is None:
        plan = segment_plan(segment_ids, num_segments)
    s = segment_sum(values, segment_ids, num_segments, plan=plan)
    ones = values.new_ones(values.shape[:1])
    cnt = segment_sum(ones, segment_ids, num_segments, plan=plan)
    return s / cnt.clamp_min(eps)[(...,) + (None,) * (s.dim() - 1)]


def segment_max(values, segment_ids, num_segments: int) -> torch.Tensor:
    """Max of ``values`` rows by segment; an empty segment gives the
    dtype's lowest value (``-inf`` for floats), as ``jax.ops.segment_max``
    does."""
    keep = _kept(segment_ids, num_segments)
    low = (float("-inf") if values.dtype.is_floating_point
           else torch.iinfo(values.dtype).min)
    out = values.new_full((num_segments, *values.shape[1:]), low)
    v = values[keep]
    idx = segment_ids[keep].long().view((-1,) + (1,) * (v.dim() - 1))
    return out.scatter_reduce_(0, idx.expand_as(v), v, reduce="amax")


def _jnp_take_index(idx, n: int):
    """``jnp`` indexing's rule: a negative index counts from the end, and
    the result is clamped into ``[0, n)``."""
    return torch.where(idx < 0, idx + n, idx).clamp(0, n - 1).long()


def segment_softmax(logits, segment_ids, num_segments: int
                    ) -> torch.Tensor:
    """Softmax normalized within each segment (GAT-style edge softmax)."""
    m = segment_max(logits, segment_ids, num_segments)
    m = torch.where(torch.isfinite(m), m, 0.0)
    at = _jnp_take_index(segment_ids, num_segments)
    e = torch.exp(logits - m[at])
    z = segment_sum(e, segment_ids, num_segments)
    return e / z[at].clamp_min(1e-9)


def scatter_add(acc, idx, values) -> torch.Tensor:
    """``acc[idx] += values`` into a new tensor, with ``.at[].add``'s
    ``mode="drop"``: a negative index counts from the end, and an index
    still outside ``[0, len(acc))`` is dropped."""
    n = acc.shape[0]
    idx = torch.where(idx < 0, idx + n, idx)
    return acc + segment_sum(values, idx, n)


def one_hot_matmul_segment_sum(values, segment_ids, num_segments: int
                               ) -> torch.Tensor:
    """Scatter-add expressed as a dense one-hot matmul (the MXU form).

    ``out[s] = Σ_p 1[segment_ids[p] == s] · values[p]`` — the same sums as
    :func:`segment_sum`, as one product; the reference uses it as the jnp
    oracle of its block kernels.
    """
    oh = (segment_ids[:, None] == torch.arange(
        num_segments, dtype=segment_ids.dtype,
        device=segment_ids.device)[None, :]).to(values.dtype)
    if values.dim() == 1:
        return values @ oh
    return torch.einsum("p...,ps->s...", values, oh)
