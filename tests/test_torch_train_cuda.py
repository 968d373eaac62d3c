"""Training on the card: the fixed summation order and card-vs-CPU steps.

Every test carries the ``cuda`` marker and skips without an NVIDIA GPU.
On a machine with one, run

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_train_cuda.py

Each runs one of ``chip_smoke.py``'s phase 13 checks (loaded by path),
with its tolerances:

* ``train_probe``: the port's ``segment_sum`` and ``gather_rows``'
  backward give the same bits in two runs on the card and the CPU's bits
  (Zipf-skewed ids; ``index_add_``, ``index_select``'s backward and
  ``table[ids]``'s backward are run beside them and reported);
* ``train_card_vs_cpu``: each family's SMOKE (f32) trained three steps
  on the CPU and twice on the card: the two card runs bitwise equal, the
  losses within rtol 1e-5, the first step's grads within rtol 1e-4 /
  atol 1e-6 · max |g|, the params within atol 1e-5 where AdamW's first
  step is held to a sign by the grads;
* no kernel of the port launches on the training path.

A check that fails raises ``RuntimeError``. The file imports neither
jax nor ``repro``.
"""

import importlib.util
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import COUNTERS

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the training checks run on it")
    return torch.device("cuda")


def _smoke():
    """``chip_smoke.py``, for phase 13's checks."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_fixed_order_sums_repeat_and_match_the_cpu(cuda_device):
    out = _smoke().train_probe(0)
    assert out["segment_sum"] == 0 and out["gather_rows backward"] == 0


def test_smoke_steps_on_the_card_match_the_cpu(cuda_device):
    for c in COUNTERS:
        c.reset()
    res = _smoke().train_card_vs_cpu(0)
    assert len(res) == 8 and all(r["repeat"] for r in res.values())
    assert all(c.n == 0 for c in COUNTERS)
