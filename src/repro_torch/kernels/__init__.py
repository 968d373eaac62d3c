"""Hand-written CUDA kernels of the port, with their plain torch twins.

Each kernel module holds the wrapper (checks operands, launches the CUDA
kernel on the current stream for a CUDA tensor, runs the twin for a CPU
tensor), the twin, and a launch counter. Sources live in ``csrc/`` and are
built by ``_build`` at first use.

Kernels:
  bm25_gather_score — K1, resident gather→score→top-k (gathered regime),
                      K3, the same with the block-max skip (pruned), and
                      K4, host-gathered candidate chunks (the ladder's
                      host rung)
  bm25_block_score  — K2, fused full-scan score→top-k (full-scan regime),
                      and K6, the same scan's dense scores (the unfused
                      path ``ops.topk(ops.bm25_score_blocked(...))``), f32
                      and bf16
  blockwise_topk    — K5, per-segment top-k of a dense score matrix
                      (stage 1 of ``ops.topk``), f32 and bf16
  block_segment_sum — K7, per-block scatter-add of the sparse substrate
                      (``ops.segment_sum_blocked``)
  embedding_bag     — K8, weighted gather-and-sum of table rows
                      (``ops.embedding_bag``)

``ref`` holds a plain torch oracle of every kernel (the reference's
``kernels/ref.py``), independent of the twins.

As in the reference, the package attribute ``embedding_bag`` is the op
(``ops.embedding_bag``); the kernel module is reached by name, ``from
repro_torch.kernels.embedding_bag import embedding_bag_plain, ...``.
"""

from . import (block_segment_sum, blockwise_topk, bm25_block_score,
               bm25_gather_score)
from .embedding_bag import LAUNCHES as _EMBEDDING_BAG_LAUNCHES
from .ops import (bm25_retrieve_blocked, bm25_retrieve_gathered,
                  bm25_retrieve_resident, bm25_retrieve_resident_pruned,
                  bm25_score_blocked, embedding_bag, segment_sum_blocked,
                  topk)
from . import ref

COUNTERS = (bm25_gather_score.LAUNCHES, bm25_block_score.LAUNCHES,
            bm25_gather_score.LAUNCHES_PRUNED,
            bm25_gather_score.LAUNCHES_GATHER, blockwise_topk.LAUNCHES,
            bm25_block_score.LAUNCHES_DENSE, block_segment_sum.LAUNCHES,
            _EMBEDDING_BAG_LAUNCHES, blockwise_topk.LAUNCHES_BF16,
            bm25_block_score.LAUNCHES_DENSE_BF16)

__all__ = ["COUNTERS", "bm25_retrieve_blocked", "bm25_retrieve_gathered",
           "bm25_retrieve_resident", "bm25_retrieve_resident_pruned",
           "bm25_score_blocked", "embedding_bag", "ref",
           "segment_sum_blocked", "topk"]
