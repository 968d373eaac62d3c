"""Entry points around the kernels: retrieval, top-k and the sparse
substrate.

The port's counterpart of ``repro.kernels.ops``: each function composes a
kernel wrapper with the surrounding tensor code (layout reshapes, the
global winner merge, the default-document splice, the §2.1 shift). Every
merge follows the port's tie rule (``core.retrieval.rank_order``).
``segment_sum_blocked`` (K7) and ``embedding_bag`` (K8) are the sparse
substrate's kernel-backed entry points.
"""

from __future__ import annotations

import torch

from ..core.retrieval import (_all_gather_merge, missing_doc_ids,
                              rank_order, splice_default_docs, topk_torch)
from ..dist import sharding
from .block_segment_sum import block_segment_sum
from .blockwise_topk import blockwise_topk
from .bm25_block_score import bm25_block_score, bm25_block_score_topk
from .bm25_gather_score import (bm25_gather_score_topk, gather_fold_fits,
                                bm25_resident_score_topk,
                                bm25_resident_score_topk_pruned)
from .embedding_bag import embedding_bag as embedding_bag_kernel


def bm25_score_blocked(token_ids, local_doc, scores, uniq_tokens, weights,
                       nonocc_shift, *, block_size: int, n_docs: int
                       ) -> torch.Tensor:
    """Batched BM25 scores ``[B, n_docs]`` from block-bucketed postings.

    ``nonocc_shift`` is the per-query ``Σᵢ wᵢ·S⁰(qᵢ)`` constant (``[B]``):
    zero for the sparse variants, the §2.1 shift for BM25L/BM25+/TFldp.
    K6 writes the dense ``[nb, block_size, B]`` sums; they are laid out as
    ``[B, nb·block_size]``, cut to ``n_docs`` and shifted. It writes the
    whole score matrix to device memory — for full-score consumers and the
    unfused path ``topk(bm25_score_blocked(...))``; retrieval goes through
    :func:`bm25_retrieve_blocked`, which never does.
    """
    out = bm25_block_score(token_ids, local_doc, scores, uniq_tokens,
                           weights, block_size=block_size)
    nb, bs, b = out.shape
    flat = out.permute(2, 0, 1).reshape(b, nb * bs)[:, :n_docs]
    # the permuted view is query-fastest; write the sum out row-major
    res = torch.empty((b, n_docs), dtype=out.dtype, device=out.device)
    return torch.add(flat, nonocc_shift[:, None], out=res)


def topk(x, k: int, *, block: int = 4096
         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Two-stage top-k over the last axis: per-segment K5 + global merge.

    Accepts ``[n]`` or ``[B, n]`` f32; returns ``(values, indices)`` (i32)
    in (value desc, index asc) order. For ``n > block`` stage 1 is K5 over
    the ``ceil(n / block)`` segments of each row, ``kb = min(k, block)``
    winners each (a ragged last segment included: its absent positions are
    never selected); stage 2 ranks the ``nb·kb`` candidates with
    :func:`~repro_torch.core.retrieval.rank_order` — lossless, since every
    global winner wins its own segment. ``n <= block`` is ranked directly
    with the same order. ``k > n`` raises ``ValueError``.

    On a ``DTensor`` ``x`` whose last dim is split over mesh dims (a
    partitioned step's scores) stage 1 runs on each rank's own entries
    (:func:`_partitioned_topk`); the result is then the same plain
    tensors on every rank.
    """
    if sharding.is_partitioned(x):
        return _partitioned_topk(x, k, block)
    squeeze = x.dim() == 1
    if squeeze:
        x = x[None]
    n = x.shape[1]
    if not 0 <= k <= n:
        raise ValueError(f"need 0 <= k <= n, got k={k}, n={n}")
    if n <= block or k == 0:
        idx, vals = topk_torch(x, k)
        idx = idx.to(torch.int32)
    else:
        vals, idx = _merge(*_segment_winners(x, k, block), k)
    if squeeze:
        return vals[0], idx[0]
    return vals, idx


def _segment_winners(x, k: int, block: int, *, first: int = 0,
                     n: int | None = None):
    """Stage 1 of :func:`topk`: K5 over the ``ceil(m / block)`` segments of
    each row of ``x`` ``[B, m]``, ``kb = min(k, block)`` winners each, as
    ``[B, nb·kb]`` values and ids: ``first`` + the position in the row,
    or ``n`` (default ``m``) where a ragged segment has no entry."""
    bsz, m = x.shape
    kb = min(k, block)
    bvals, bpos = blockwise_topk(x, k=kb, block=block)
    nb = bvals.shape[0] // bsz
    base = (torch.arange(nb, dtype=torch.int32, device=x.device)
            * block)[None, :, None]
    if first:
        base = base + first
    gidx = torch.where(bpos.view(bsz, nb, kb) >= 0,
                       bpos.view(bsz, nb, kb) + base, m if n is None else n
                       ).view(bsz, nb * kb)
    return bvals.view(bsz, nb * kb), gidx


def _merge(vals, ids, k: int):
    """Stage 2 of :func:`topk`: the first ``k`` of each row's candidates
    ``[B, m]`` in :func:`~repro_torch.core.retrieval.rank_order`'s order
    (value desc, id asc), as ``(values, ids)``."""
    sel = rank_order(vals, ids)[:, :k]
    return torch.gather(vals, 1, sel), torch.gather(ids, 1, sel)


def candidate_width(n: int, shards: int, k: int, block: int) -> int:
    """The candidates each rank sends in the partitioned :func:`topk` of
    ``n`` entries over ``shards`` pieces: ``kb = min(k, block)`` for every
    segment of the longest piece, so that every rank's list has one width
    (the all-gather takes equal shapes). The longest piece is the first,
    ``ceil(n / shards)`` long: DTensor cuts ``ceil`` chunks, and nested
    cuts compose (``ceil(ceil(n / a) / b) == ceil(n / (a b))``)."""
    return -(-(-(-n // shards)) // block) * min(k, block)


def rank_candidates(local, first: int, n: int, k: int, block: int,
                    width: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Stage 1 of the partitioned :func:`topk` on one rank: K5 over the
    segments of the rank's piece ``local`` ``[B, m]`` (entries ``first``
    .. ``first + m - 1`` of ``n``), ``kb = min(k, block)`` winners each,
    as ``[B, width]`` values and global ids. A segment shorter than
    ``kb``, and an empty piece, leave ``(-inf, n)`` slots, and the list is
    padded with them up to ``width``: :func:`~repro_torch.core.retrieval.
    rank_order` puts such a slot after every real entry, ``-inf`` ones
    included, since its id is larger. A plain function of its arguments,
    so a rank's stage runs the same for a virtual rank."""
    bsz, m = local.shape
    if m:
        vals, ids = _segment_winners(local, k, block, first=first, n=n)
    else:
        vals = local.new_empty((bsz, 0))
        ids = torch.empty((bsz, 0), dtype=torch.int32, device=local.device)
    pad = width - vals.shape[1]
    if pad < 0:
        raise ValueError(f"{vals.shape[1]} candidates exceed the width "
                         f"{width}")
    if pad:
        vals = torch.cat([vals, vals.new_full((bsz, pad), float("-inf"))],
                         dim=1)
        ids = torch.cat([ids, ids.new_full((bsz, pad), n)], dim=1)
    return vals, ids


def _partitioned_topk(x, k: int, block: int):
    """:func:`topk` of a ``DTensor`` ``x`` (``[n]`` or ``[B, n]``) whose
    last dim is split over mesh dims (the others replicated), evenly or
    not: stage 1 on each rank's own piece (:func:`rank_candidates`, at the
    offset and length of DTensor's layout, ``dist.sharding.shard_extent``;
    a segment may then hold part of a global one: still lossless, since
    every global winner wins its own piece, and ties go by index), then
    one all-gather of the ``[B, width]`` candidates over the splitting
    dims and the rank merge (``core.retrieval._all_gather_merge``, the
    sharded steps' own). ``k = 0`` gives empty boards on every rank with
    no collective; ``k > n`` raises as :func:`topk` does. Returns plain
    tensors, the same on every rank; on one rank, :func:`topk`'s own
    board."""
    from torch.distributed.tensor.placement_types import _StridedShard

    mesh = x.device_mesh
    last = x.ndim - 1
    if any(p.is_partial() or isinstance(p, _StridedShard)
           or (p.is_shard() and not p.is_shard(last))
           for p in x.placements):
        raise ValueError(f"topk takes a tensor split on its last dim in "
                         f"the mesh's order, got {list(x.placements)}")
    n = x.shape[-1]
    if not 0 <= k <= n:
        raise ValueError(f"need 0 <= k <= n, got k={k}, n={n}")
    local = x.to_local()
    squeeze = local.dim() == 1
    if squeeze:
        local = local[None]
    if k == 0:
        vals = local.new_empty((local.shape[0], 0))
        idx = torch.empty((local.shape[0], 0), dtype=torch.int32,
                          device=local.device)
    else:
        first, m = sharding.shard_extent(mesh, x.placements, x.shape, last)
        if m != local.shape[1]:
            raise ValueError(f"the local piece holds {local.shape[1]} "
                             f"entries where the layout gives {m}")
        shards = sharding.split_index(mesh, x.placements, last)[1]
        vals, gidx = rank_candidates(local, first, n, k, block,
                                     candidate_width(n, shards, k, block))
        group = sharding.axes_group(mesh, tuple(
            name for name, p in zip(mesh.mesh_dim_names, x.placements)
            if p.is_shard()))
        if group is not None:
            idx, vals, _ = _all_gather_merge(gidx, vals, None, group, shards,
                                             k)
        else:                                     # one rank holds them all
            vals, idx = _merge(vals, gidx, k)
    if squeeze:
        return vals[0], idx[0]
    return vals, idx


def bm25_retrieve_blocked(token_ids, local_doc, scores, uniq_tokens,
                          weights, nonocc_shift, *, block_size: int,
                          n_docs: int, k: int
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-scan retrieval: blocked postings -> (ids, scores) ``[B, k]``.

    Stage 1 is the fused score→top-k kernel (``[nb, kb, B]`` winners; the
    dense ``[nb, block_size, B]`` matrix never reaches device memory).
    Stage 2 is :func:`topk` over the ``nb·kb`` candidates per query (K5
    over segments of 4,096, then the rank merge) — lossless because every
    global winner wins its own block — and the winners' global ids are
    gathered at the positions it returns. A candidate's position is
    ``blk·kb + r`` and K2 ranks equal scores by row ascending, so among
    equal scores position order is doc id order: the board is the one a
    sort of all candidates by (score desc, doc id asc) gives, bit for bit.
    The §2.1 shift is a per-query constant, added after the merge.
    """
    kb = min(k, block_size, n_docs)
    vals, loc = bm25_block_score_topk(
        token_ids, local_doc, scores, uniq_tokens, weights,
        block_size=block_size, k=kb, n_docs=n_docs)
    nb, _, b = vals.shape
    flat_v = vals.permute(2, 0, 1).reshape(b, nb * kb)
    top_v, pos = topk(flat_v, min(k, n_docs, nb * kb))
    # the winner at flat position blk·kb + r of query q is loc[blk, r, q]
    pos = pos.long()
    q = torch.arange(b, device=pos.device)[:, None]
    rows = loc.reshape(-1)[pos * b + q]
    ids = torch.div(pos, kb, rounding_mode="floor") * block_size + rows
    return ids.to(torch.int32), top_v + nonocc_shift[:, None]


def bm25_retrieve_gathered(token_ids, slot_ids, scores, uniq_tokens,
                           weights, candidates, nonocc_shift, *,
                           acc_block: int, k: int, n_docs: int,
                           two_level: bool = True
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Host-gathered retrieval (the ladder's host rung): O(Σ df) postings
    -> (ids, scores) ``[B, k]``.

    Stage 1 is K4 (:func:`~.bm25_gather_score.bm25_gather_score_topk`).
    With ``two_level=True`` (default) the chunk winners are folded into
    one ``[kb, B]`` board in the same launch; ``two_level=False`` keeps the
    per-chunk ``[nc, kb, B]`` boards and merges them here. The fold keeps
    only ``kb = min(k, acc_block)`` winners, so when ``kb < k`` — or when
    the chunk boards outgrow the fold's shared memory — the chunked path
    runs instead. It is exact: with ``kb < k`` each chunk's top-``kb`` is
    its whole candidate set (a chunk holds at most ``acc_block``), and
    otherwise the merge of the chunk boards is the fold's board. Stage 2
    splices in default documents: a document outside the candidate set
    contributes no posting, so its exact raw score is 0 —
    :func:`~repro_torch.core.retrieval.missing_doc_ids` names ``k`` of them
    from the sorted candidate table. The §2.1 shift is added last.
    """
    kk = min(k, n_docs)
    kb = min(kk, acc_block)
    nc = token_ids.shape[0]
    if two_level and (kb < kk or not gather_fold_fits(nc)):
        two_level = False
    vals, gids = bm25_gather_score_topk(
        token_ids, slot_ids, scores, uniq_tokens, weights, candidates,
        acc_block=acc_block, k=kb, two_level=two_level)
    if two_level:
        flat_v, flat_i = vals.T, gids.T                 # [B, kb]
    else:
        b = vals.shape[2]
        flat_v = vals.permute(2, 0, 1).reshape(b, nc * kb)
        flat_i = gids.permute(2, 0, 1).reshape(b, nc * kb)
    ids, mvals = splice_default_docs(
        flat_v, flat_i, kk, n_docs,
        default_ids=missing_doc_ids(candidates.reshape(-1), kk, n_docs))
    return ids, mvals + nonocc_shift[:, None]


def bm25_retrieve_resident(desc, weights, doc_ids_res, scores_res, def_ids,
                           nonocc_shift, *, block_size: int, frag: int,
                           k: int, n_docs: int, double_buffer: bool = True
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Device-resident retrieval: fragment descriptors -> (ids, scores)
    ``[B, k]``.

    ``doc_ids_res``/``scores_res`` are the resident CSC arrays of a
    ``sparse.block_csr.DeviceIndex`` (uploaded once at build); the
    per-batch operands are the ``[6, nf]`` fragment table, the ``[U, B]``
    query weights, ``k`` default doc ids from unvisited blocks
    (``core.retrieval.default_doc_ids``) and the ``[B]`` §2.1 shift — none
    of it postings. The kernels return the merged board, so the only
    post-processing is the default-document splice and the shift add.
    """
    kk = min(k, n_docs)
    vals, gids = bm25_resident_score_topk(
        desc, weights, doc_ids_res, scores_res, block_size=block_size,
        frag=frag, k=kk, n_docs=n_docs, double_buffer=double_buffer)
    ids, mvals = splice_default_docs(vals.T, gids.T, kk, n_docs,
                                     default_ids=def_ids)
    return ids, mvals + nonocc_shift[:, None]


def bm25_retrieve_resident_pruned(desc, weights, doc_ids_res, scores_res,
                                  bounds, def_ids, nonocc_shift, *,
                                  block_size: int, frag: int, k: int,
                                  n_docs: int):
    """Pruned-regime resident retrieval: ``(ids, scores, skipped)``.

    :func:`bm25_retrieve_resident` with the block-max skip (K3): ``desc``
    is the threshold-COMPACTED fragment table, ``bounds`` the batch's
    ``[nb, B]`` block upper bounds. ``def_ids`` MUST come from
    the UNPRUNED visited-block set: a pruned block's documents score below
    the threshold, not zero, so they are neither candidates nor defaults.
    ``skipped`` is K3's in-kernel skip count (a 0-d tensor). The
    ``(ids, scores)`` board equals the unpruned path's on the same batch.

    Fault-injection site ``kernel.resident_pruned``
    (``repro_torch.serve.faults``): an armed ``nan_board``/``inf_board``
    fault poisons the ``[B, k]`` board built from K3's — exactly the
    non-finite entry a broken launch would produce, caught downstream by
    the retriever's finite-check.
    """
    kk = min(k, n_docs)
    vals, gids, skipped = bm25_resident_score_topk_pruned(
        desc, weights, bounds, doc_ids_res, scores_res,
        block_size=block_size, frag=frag, k=kk, n_docs=n_docs)
    ids, mvals = splice_default_docs(vals.T, gids.T, kk, n_docs,
                                     default_ids=def_ids)
    mvals = mvals + nonocc_shift[:, None]
    import sys
    _f = sys.modules.get("repro_torch.serve.faults")
    if _f is not None and _f.ACTIVE:
        mvals = _f.fire("kernel.resident_pruned", mvals)
    return ids, mvals, skipped


def segment_sum_blocked(values, segment_ids, *, num_segments: int,
                        tile_p: int = 512) -> torch.Tensor:
    """Blocked scatter-add (K7): ``[nb, P, D]`` + ``[nb, P]`` -> ``[nb,
    num_segments, D]``; ``P`` must be a multiple of ``tile_p``."""
    return block_segment_sum(values, segment_ids, num_segments=num_segments,
                             tile_p=tile_p)


def embedding_bag(table, indices, weights=None, *, tile_b: int = 128
                  ) -> torch.Tensor:
    """Kernel-backed EmbeddingBag (K8): ``[V, D]`` table + ``[B, F]``
    indices (``-1`` pad) + ``[B, F]`` weights (``None``: ones) -> ``[B,
    D]``.

    The reference pads ``B`` up to a multiple of ``tile_b``, its kernel's
    bag tile; K8 takes any ``B`` (a warp a slice of a bag's columns), so
    ``tile_b`` is only checked, and nothing is padded.
    """
    if tile_b < 1:
        raise ValueError(f"tile_b must be >= 1, got {tile_b}")
    if weights is None:
        weights = torch.ones(indices.shape, dtype=table.dtype,
                             device=table.device)
    return embedding_bag_kernel(table, indices, weights)
