"""AutoInt [arXiv:1810.11921]: self-attentive feature interaction.

39 sparse fields (Criteo: 13 bucketized numeric + 26 categorical),
embed_dim=16, 3 attention layers, 2 heads, d_attn=32. Field vocabularies
below total ≈1M features (the paper's Criteo feature count).
"""

from ..models.recsys import RecsysConfig, reduced
from .common import recsys_cells

# 13 bucketized numeric fields + 26 categorical (sums to ~998k features)
AUTOINT_VOCABS = tuple([64] * 13) + (
    1461, 584, 1_000_000 - 13 * 64 - 1461 - 584 - 305 - 24 - 12518 - 634
    - 4 - 42647 - 5161 - 3176 - 27 - 11746 - 155 - 4 - 977 - 15 - 286181
    - 105 - 142573 - 300_000 - 12337 - 11 - 5641 - 34,
    305, 24, 12518, 634, 4, 42647, 5161, 3176, 27, 11746, 155, 4, 977, 15,
    286181, 105, 142573, 300_000, 12337, 11, 5641, 34,
)

CONFIG = RecsysConfig(
    name="autoint", model="autoint",
    vocab_sizes=AUTOINT_VOCABS, embed_dim=16,
    n_attn_layers=3, n_heads=2, d_attn=32,
)

SMOKE = reduced(CONFIG)

FAMILY = "recsys"


def cells():
    return recsys_cells("autoint", CONFIG)
