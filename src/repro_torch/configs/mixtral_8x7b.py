"""mixtral-8x7b [arXiv:2401.04088]: 8-expert top-2 MoE with SWA.

32L, d_model=4096, 32 heads (GQA kv=8), d_ff=14336, vocab=32000,
8 experts top-2. Sliding window 4096 (mistral lineage) ⇒ long_500k runs
window-capped. MoE uses the token-dispatch formulation with
group-local token dispatch (``moe_group_seq=4096``) bounding the [G, E, C, d_ff] expert activations.
"""

import torch

from ..models.transformer import LMConfig, reduced
from .common import lm_cells

CONFIG = LMConfig(
    name="mixtral-8x7b",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=32000,
    sliding_window=4096,
    n_experts=8, top_k=2, capacity_factor=1.25, moe_group_seq=4096,
    rope_theta=1_000_000.0,
    dtype=torch.bfloat16,
)

SMOKE = reduced(CONFIG, moe_group_seq=16)

FAMILY = "lm"
N_MICROBATCHES = 8                # the train cell's, with the training slice


def cells():
    return lm_cells("mixtral-8x7b", CONFIG)
