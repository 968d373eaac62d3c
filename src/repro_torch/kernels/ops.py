"""Retrieval entry points around the kernels: merge, splice and shift.

The port's counterpart of ``repro.kernels.ops``: each function composes a
kernel wrapper with the surrounding tensor code (layout reshapes, the
global winner merge, the default-document splice, the §2.1 shift). Every
merge follows the port's tie rule (``core.retrieval.rank_order``).
"""

from __future__ import annotations

import torch

from ..core.retrieval import rank_order, splice_default_docs
from .bm25_block_score import bm25_block_score_topk
from .bm25_gather_score import bm25_resident_score_topk


def bm25_retrieve_blocked(token_ids, local_doc, scores, uniq_tokens,
                          weights, nonocc_shift, *, block_size: int,
                          n_docs: int, k: int
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-scan retrieval: blocked postings -> (ids, scores) ``[B, k]``.

    Stage 1 is the fused score→top-k kernel (``[nb, kb, B]`` winners; the
    dense ``[nb, block_size, B]`` matrix never reaches device memory).
    Stage 2 is the global merge over ``nb·kb`` candidates per query —
    lossless because every global winner wins its own block. The §2.1
    shift is a per-query constant, added after the merge.
    """
    kb = min(k, block_size, n_docs)
    vals, loc = bm25_block_score_topk(
        token_ids, local_doc, scores, uniq_tokens, weights,
        block_size=block_size, k=kb, n_docs=n_docs)
    nb, _, b = vals.shape
    gids = loc + (torch.arange(nb, dtype=torch.int32, device=loc.device)
                  * block_size)[:, None, None]
    flat_v = vals.permute(2, 0, 1).reshape(b, nb * kb)
    flat_i = gids.permute(2, 0, 1).reshape(b, nb * kb)
    sel = rank_order(flat_v, flat_i)[:, :min(k, n_docs, nb * kb)]
    return (torch.gather(flat_i, 1, sel),
            torch.gather(flat_v, 1, sel) + nonocc_shift[:, None])


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
