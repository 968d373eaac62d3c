"""MIND [arXiv:1904.08030]: multi-interest capsule routing retrieval.

embed_dim=64, 4 interest capsules, 3 dynamic-routing iterations,
label-aware attention. Item catalog 2^20 (retrieval_cand scores the full
catalog with the max-over-interests dot).
"""

from ..models.recsys import RecsysConfig, reduced
from .common import recsys_cells

CONFIG = RecsysConfig(
    name="mind", model="mind",
    vocab_sizes=(1_048_576,), embed_dim=64,
    n_interests=4, capsule_iters=3, seq_len=50,
)

SMOKE = reduced(CONFIG)

FAMILY = "recsys"


def cells():
    return recsys_cells("mind", CONFIG)
