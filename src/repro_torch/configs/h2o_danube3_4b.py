"""h2o-danube3-4b [arXiv:2401.16818]: llama+mistral mix with SWA.

24L, d_model=3840, 32 heads (GQA kv=8), d_ff=10240, vocab=32000.
head_dim = 3840/32 = 120 — deliberately not a multiple of 64 or 128.
All layers sliding-window (mistral-style 4096)
⇒ the long_500k decode cell runs with a window-capped KV cache.
"""

import torch

from ..models.transformer import LMConfig, reduced
from .common import lm_cells

CONFIG = LMConfig(
    name="h2o-danube3-4b",
    n_layers=24, d_model=3840, n_heads=32, n_kv_heads=8, head_dim=120,
    d_ff=10240, vocab_size=32000,
    sliding_window=4096, rope_theta=10_000.0,
    dtype=torch.bfloat16,
)

SMOKE = reduced(CONFIG)

FAMILY = "lm"
N_MICROBATCHES = 4


def cells():
    return lm_cells("h2o-danube3-4b", CONFIG, n_microbatches=N_MICROBATCHES)
