"""EmbeddingBag in torch: a row gather + a reduction over the fanout.

The port's counterpart of ``repro.sparse.embedding_bag``. Bags are
fixed-fanout ``[..., F]`` index arrays (recsys multi-hot fields, GNN
sampled neighbourhoods) with optional per-sample weights and a ``-1``
padding convention. These are plain torch functions, as the reference's
are plain jnp: they materialise the ``[..., F, D]`` gather and do not go
through K8 (``kernels.ops.embedding_bag``), as the reference's do not go
through its kernel.
"""

from __future__ import annotations

import torch


def embedding_bag(table, indices, weights=None, *,
                  combiner: str = "sum") -> torch.Tensor:
    """Gather-and-reduce: table ``[V, D]``, indices ``[..., F]`` ->
    ``[..., D]``.

    ``indices == -1`` are padding (contribute zero; excluded from
    ``"mean"``; a bag of pads alone gives 0 under ``"max"``).
    """
    valid = indices >= 0
    safe = torch.where(valid, indices, 0).long()
    rows = table[safe]                                   # [..., F, D]
    w = valid.to(table.dtype)
    if weights is not None:
        w = w * weights
    rows = rows * w[..., None]
    if combiner == "sum":
        return rows.sum(dim=-2)
    if combiner == "mean":
        denom = w.sum(dim=-1, keepdim=True).clamp_min(1e-9)
        return rows.sum(dim=-2) / denom
    if combiner == "max":
        neg = torch.where(valid[..., None], rows,
                          torch.finfo(table.dtype).min)
        out = neg.amax(dim=-2)
        any_valid = valid.any(dim=-1, keepdim=True)
        return torch.where(any_valid, out, 0.0)
    raise ValueError(f"unknown combiner {combiner!r}")


def multi_table_lookup(tables, indices) -> torch.Tensor:
    """Per-field single-hot lookup: indices ``[B, n_fields]`` ->
    ``[B, n_fields, D]``, one table per categorical field, all of one
    width."""
    cols = [t[indices[:, i].long()] for i, t in enumerate(tables)]
    return torch.stack(cols, dim=1)


def stacked_table_lookup(table, offsets, indices) -> torch.Tensor:
    """Lookup into one concatenated ``[Σ vocab_f, D]`` table;
    ``offsets[f]`` is the row offset of field ``f``."""
    flat = indices + offsets[None, :]
    return table[flat.long()]
