"""LM serving at full width on the card.

Every test carries the ``cuda`` marker and skips without an NVIDIA GPU.
On a machine with one, run

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_lm_cuda.py

Each runs one of ``chip_smoke.py``'s phase 12 checks (loaded by path),
with its tolerances:

* gemma3-1b at full width in f32: ``prefill`` of a 64-token prompt and 4
  teacher-forced ``decode_step``s from ``pos = 0``, the card against the
  CPU within rtol/atol 1e-3, greedy ids equal where the CPU's top-2 gap
  is clear;
* ``DecodeEngine`` on the card (gemma3-1b, bf16, 8 slots) against a
  lockstep B = 1 ``decode_step`` of the same requests, teacher-forced
  with the engine's ids: equal ids except under a top-2 gap of 4 bf16
  ulps;
* mixtral-8x7b's layer 0 ``moe_block`` in f32 on 64 tokens against the
  per-token formula ``Σ_k w_tk · expert_{e_tk}(x_t)`` over the kept
  choices within rtol/atol 1e-4, its router's integers equal to the
  CPU's on the same logits.

A check that fails raises ``RuntimeError``. The file imports neither
jax nor ``repro``.
"""

import importlib.util
from dataclasses import replace
from pathlib import Path

import pytest
import torch

from repro_torch import configs
from repro_torch.configs.common import lm_cells
from repro_torch.kernels import COUNTERS

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _smoke():
    """``chip_smoke.py``, for phase 12's checks."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _specs(arch, cfg):
    (cell,) = [c for c in lm_cells(arch, cfg, n_microbatches=1)
               if c.shape == "decode_32k"]
    return cell.build(None)[1][0]


def test_gemma_full_width_f32_card_matches_cpu(cuda_device):
    smoke = _smoke()
    cfg = configs.get_config("gemma3-1b")
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    prompt = torch.randint(0, cfg.vocab_size, (1, smoke.LM_CHECK_PROMPT),
                           generator=gen, device=cuda_device,
                           dtype=torch.int32)
    with torch.inference_mode():
        d = smoke.lm_card_vs_cpu(cfg, gen, prompt)
    assert d["prefill"] < 1.0 and d["decode"] < 1.0


def test_engine_on_the_card_matches_lockstep(cuda_device):
    smoke = _smoke()
    smoke.ENGINE_REQUESTS = smoke.ENGINE_LOCKSTEP = 4
    cfg = configs.get_config("gemma3-1b")
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    for c in COUNTERS:
        c.reset()
    with torch.inference_mode():
        params = smoke.lm_cast(cfg, _specs("gemma3-1b", cfg), gen)
        r = smoke.lm_engine_run(cfg, params, 1, cuda_device)
    assert r["compared"] > 0
    assert all(c.n == 0 for c in COUNTERS)


def test_mixtral_moe_block_matches_per_token_formula(cuda_device):
    smoke = _smoke()
    cfg = replace(configs.get_config("mixtral-8x7b"), n_layers=1)
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    with torch.inference_mode():
        params = smoke.lm_cast(cfg, _specs("mixtral-8x7b", cfg), gen)
        r = smoke.moe_vs_formula(cfg, params, gen)
    assert r["kept"] <= smoke.MOE_CHECK_TOKENS * cfg.top_k
