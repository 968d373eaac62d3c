"""gemma3-1b [hf:google/gemma-3-1b-pt]: 5:1 local:global attention.

26L, d_model=1152, 4 heads (GQA kv=1), head_dim=256, d_ff=6912,
vocab=262144. Every 6th layer is global (full attention, rope theta 1e6);
the rest slide over a 512-token window (theta 10k). Gemma conventions:
(1+w) RMSNorm, embeddings scaled by sqrt(d_model), tied unembedding.
long_500k runs: only the 4 global layers keep full-length KV (kv=1).
"""

import torch

from ..models.transformer import LMConfig, reduced
from .common import lm_cells

CONFIG = LMConfig(
    name="gemma3-1b",
    n_layers=26, d_model=1152, n_heads=4, n_kv_heads=1, head_dim=256,
    d_ff=6912, vocab_size=262144,
    sliding_window=512, global_every=6,
    rope_theta=10_000.0, rope_theta_global=1_000_000.0,
    embed_scale=True, rmsnorm_plus_one=True, tie_embeddings=True,
    dtype=torch.bfloat16,
)

SMOKE = reduced(CONFIG, global_every=3, n_layers=3)

FAMILY = "lm"
N_MICROBATCHES = 2


def cells():
    return lm_cells("gemma3-1b", CONFIG, n_microbatches=N_MICROBATCHES)
