"""Plain torch oracles for every kernel of this package.

The port's counterpart of ``repro.kernels.ref``. Each ``*_ref`` takes
exactly the operands of its kernel counterpart and is written in the most
obvious torch form — no blocking, no schedule — so tests can hold a
kernel or its twin against unambiguous semantics. The selections rank by
value descending, then position ascending (a stable sort), the order the
reference's ``lax.top_k`` gives equal values. Nothing on a serving path
calls them.
"""

from __future__ import annotations

import torch


def _top(x: torch.Tensor, k: int, dim: int = -1):
    """``(values, positions)`` of the ``k`` largest along ``dim``, equal
    values in position order."""
    vals, idx = torch.sort(x, dim=dim, descending=True, stable=True)
    return vals.narrow(dim, 0, k), idx.narrow(dim, 0, k)


def bm25_block_score_ref(token_ids, local_doc, scores, uniq_tokens, weights,
                         *, block_size: int, spmd_axes=None) -> torch.Tensor:
    """[nb, P] postings x [U, B] query weights -> [nb, block_size, B] scores.

    For each posting p in block i: binary-search its token in the sorted
    unique-token table (exact match; padding postings have token -1 and
    match nothing), gather the per-query weight row, multiply by the eager
    score, scatter-add into its local document row. ``spmd_axes`` is the
    reference's mesh-axis pin for its ``vmap``; one device ignores it.
    """
    nb, _ = token_ids.shape
    idx = torch.searchsorted(uniq_tokens, token_ids).clamp(
        max=uniq_tokens.shape[0] - 1)
    hit = (uniq_tokens[idx] == token_ids)[..., None]
    w = torch.where(hit, weights[idx], 0.0)                     # [nb, P, B]
    contrib = scores[..., None] * w
    out = torch.zeros((nb, block_size, weights.shape[1]),
                      dtype=contrib.dtype, device=contrib.device)
    dst = local_doc.long()[..., None].expand_as(contrib)
    return out.scatter_add_(1, dst, contrib)


def bm25_block_topk_ref(token_ids, local_doc, scores, uniq_tokens, weights,
                        *, block_size: int, k: int, n_docs: int):
    """Oracle for the fused kernel: dense block scores, then per-block top-k.

    Documents past ``n_docs`` (tail-of-last-block padding) are masked to
    the float minimum before selection. Returns ``(values [nb, k, B],
    rows [nb, k, B] int32)``.
    """
    dense = bm25_block_score_ref(token_ids, local_doc, scores, uniq_tokens,
                                 weights, block_size=block_size)
    nb = dense.shape[0]
    gdoc = (torch.arange(nb, device=dense.device)[:, None] * block_size
            + torch.arange(block_size, device=dense.device)[None, :])
    masked = torch.where((gdoc < n_docs)[:, :, None], dense,
                         torch.finfo(dense.dtype).min)
    vals, idx = _top(masked, k, dim=1)
    return vals, idx.to(torch.int32)


def bm25_gather_topk_ref(token_ids, slot_ids, scores, uniq_tokens, weights,
                         candidates, *, acc_block: int, k: int):
    """Oracle for the gathered fused kernel (``bm25_gather_score_topk``).

    Dense per-chunk candidate-slot scores, padding slots (candidate id -1)
    masked to the float minimum, per-chunk top-k, the winning slots
    translated to global doc ids through the chunk's candidate table.
    Returns ``(values [nc, k, B], doc ids [nc, k, B] int32)``.
    """
    dense = bm25_block_score_ref(token_ids, slot_ids, scores, uniq_tokens,
                                 weights, block_size=acc_block)
    masked = torch.where((candidates >= 0)[:, :, None], dense,
                         torch.finfo(dense.dtype).min)
    vals, slots = _top(masked, k, dim=1)
    gids = torch.gather(candidates[:, :, None].expand_as(dense), 1, slots)
    return vals, gids.to(torch.int32)


def block_segment_sum_ref(values, segment_ids, *, num_segments: int
                          ) -> torch.Tensor:
    """[nb, P, D] values + [nb, P] local ids -> [nb, num_segments, D].

    Padding rows must carry zero values (the blocked layouts guarantee it).
    """
    nb, _, d = values.shape
    out = torch.zeros((nb, num_segments, d), dtype=values.dtype,
                      device=values.device)
    dst = segment_ids.long()[..., None].expand_as(values)
    return out.scatter_add_(1, dst, values)


def embedding_bag_ref(table, indices, weights) -> torch.Tensor:
    """[V, D] table + [B, F] indices (-1 pad) + [B, F] weights -> [B, D]."""
    valid = indices >= 0
    rows = table[torch.where(valid, indices, 0).long()]       # [B, F, D]
    w = weights * valid.to(table.dtype)
    return (rows * w[..., None]).sum(dim=1)


def blockwise_topk_ref(x, *, k: int, block: int):
    """[n] -> per-block (values [nb, k], global indices [nb, k]),
    descending."""
    nb = x.shape[0] // block
    vals, idx = _top(x[:nb * block].reshape(nb, block), k)
    return vals, idx + (torch.arange(nb, dtype=idx.dtype,
                                     device=idx.device) * block)[:, None]
