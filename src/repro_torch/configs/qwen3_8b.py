"""qwen3-8b [hf:Qwen/Qwen3-8B]: dense GQA with qk-norm.

36L, d_model=4096, 32 heads (GQA kv=8), head_dim=128, d_ff=12288,
vocab=151936. Pure full attention — as in the reference, the
``long_500k`` cell is SKIPPED for this arch (no sub-quadratic attention).
"""

import torch

from ..models.transformer import LMConfig, reduced
from .common import lm_cells

CONFIG = LMConfig(
    name="qwen3-8b",
    n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=12288, vocab_size=151936,
    qk_norm=True, rope_theta=1_000_000.0,
    dtype=torch.bfloat16,
)

SMOKE = reduced(CONFIG)

FAMILY = "lm"
N_MICROBATCHES = 4                # the train cell's, with the training slice


def cells():
    return lm_cells("qwen3-8b", CONFIG, skip_long=True)
