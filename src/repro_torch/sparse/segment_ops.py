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

Sums run in ``index_add_``'s order: serial on the CPU, with atomics on
CUDA, so on the card they agree with the CPU within rounding only.
"""

from __future__ import annotations

import torch


def _kept(segment_ids, num_segments: int):
    return (segment_ids >= 0) & (segment_ids < num_segments)


def segment_sum(values, segment_ids, num_segments: int) -> torch.Tensor:
    """Sum of ``values`` rows by segment, ``[num_segments, ...]``; ids
    outside ``[0, num_segments)`` (the sentinel ``num_segments`` among
    them) are dropped."""
    keep = _kept(segment_ids, num_segments)
    out = values.new_zeros((num_segments, *values.shape[1:]))
    return out.index_add_(0, segment_ids[keep].long(), values[keep])


def segment_mean(values, segment_ids, num_segments: int, *,
                 eps: float = 1e-9) -> torch.Tensor:
    """Mean of ``values`` rows by segment; an empty segment gives 0."""
    s = segment_sum(values, segment_ids, num_segments)
    ones = values.new_ones(values.shape[:1])
    cnt = segment_sum(ones, segment_ids, num_segments)
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
    keep = _kept(idx, n)
    return acc.clone().index_add_(0, idx[keep].long(), values[keep])


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
