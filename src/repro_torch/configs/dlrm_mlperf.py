"""DLRM MLPerf benchmark config [arXiv:1906.00091] — Criteo 1TB.

13 dense features -> bottom MLP 512-256-128; 26 categorical features with
the MLPerf vocabulary sizes below (≈188M rows total, dim 128 ≈ 96 GB fp32
of embedding state — more than one 80 GB card holds); dot interaction;
top MLP 1024-1024-512-256-1. Tables are stored concatenated.
"""

from ..models.recsys import RecsysConfig, reduced
from .common import recsys_cells

# MLPerf DLRM (Criteo Terabyte) per-table row counts
MLPERF_VOCABS = (
    39884406, 39043, 17289, 7420, 20263, 3, 7120, 1543, 63, 38532951,
    2953546, 403346, 10, 2208, 11938, 155, 4, 976, 14, 39979771,
    25641295, 39664984, 585935, 12972, 108, 36,
)

CONFIG = RecsysConfig(
    name="dlrm-mlperf", model="dlrm",
    vocab_sizes=MLPERF_VOCABS, embed_dim=128, n_dense=13,
    bot_mlp=(512, 256, 128), top_mlp=(1024, 1024, 512, 256, 1),
)

SMOKE = reduced(CONFIG)

FAMILY = "recsys"


def cells():
    return recsys_cells("dlrm-mlperf", CONFIG)
