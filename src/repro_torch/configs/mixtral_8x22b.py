"""mixtral-8x22b [arXiv:2401.04088]: the heavyweight MoE cell (141B params).

56L, d_model=6144, 48 heads (GQA kv=8), d_ff=16384, vocab=32768,
8 experts top-2, SWA 4096. Parameters + optimizer state only fit through
the FSDP-style (data+model) weight sharding; training uses 8 microbatches.
"""

import torch

from ..models.transformer import LMConfig, reduced
from .common import lm_cells

CONFIG = LMConfig(
    name="mixtral-8x22b",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=16384, vocab_size=32768,
    sliding_window=4096,
    n_experts=8, top_k=2, capacity_factor=1.25, moe_group_seq=4096,
    rope_theta=1_000_000.0,
    dtype=torch.bfloat16,
)

SMOKE = reduced(CONFIG, moe_group_seq=16)

FAMILY = "lm"
N_MICROBATCHES = 8                # the train cell's, with the training slice


def cells():
    return lm_cells("mixtral-8x22b", CONFIG)
