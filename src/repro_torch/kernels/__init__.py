"""Hand-written CUDA kernels of the port, with their plain torch twins.

Each kernel module holds the wrapper (checks operands, launches the CUDA
kernel on the current stream for a CUDA tensor, runs the twin for a CPU
tensor), the twin, and a launch counter. Sources live in ``csrc/`` and are
built by ``_build`` at first use.

Kernels:
  bm25_gather_score — K1, resident gather→score→top-k (gathered regime)
  bm25_block_score  — K2, fused full-scan score→top-k (full-scan regime)
"""

from . import bm25_block_score, bm25_gather_score
from .ops import bm25_retrieve_blocked, bm25_retrieve_resident

COUNTERS = (bm25_gather_score.LAUNCHES, bm25_block_score.LAUNCHES)

__all__ = ["COUNTERS", "bm25_retrieve_blocked", "bm25_retrieve_resident"]
