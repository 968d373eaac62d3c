"""SASRec [arXiv:1808.09781]: self-attentive sequential recommendation.

embed_dim=50 (the paper's MovieLens setting, deliberately not padded to a
multiple of 64), 2 blocks, 1 head, seq_len=50. Item catalog sized 2^20 so
the ``retrieval_cand`` cell scores the full catalog.
"""

from ..models.recsys import RecsysConfig, reduced
from .common import recsys_cells

CONFIG = RecsysConfig(
    name="sasrec", model="sasrec",
    vocab_sizes=(1_048_576,), embed_dim=50,
    n_blocks=2, n_heads=1, seq_len=50,
)

SMOKE = reduced(CONFIG)

FAMILY = "recsys"


def cells():
    return recsys_cells("sasrec", CONFIG)
