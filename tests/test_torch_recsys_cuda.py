"""The recsys serving cells at full width on the card.

Both tests carry the ``cuda`` marker and skip without an NVIDIA GPU. On a
machine with one, run

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_recsys_cuda.py

* MIND's three cells (``serve_p99``, ``serve_bulk``, ``retrieval_cand``)
  at ``configs/mind.py``'s full width, against the same functions on the
  CPU with the same params, within the smoke's rtol 1e-4, atol 1e-4; the
  retrieval board bitwise K5's twin on the card's scores;
* AutoInt's ``retrieval_cand``: 2^20 candidates drawn from field 0's 64
  values, so the board is a block of ties; bitwise equal to K5's twin,
  and in the tie rule's order (value desc, then candidate position asc).

The file imports neither jax nor ``repro``.
"""

import importlib.util
from pathlib import Path

import pytest
import torch

from repro_torch import configs
from repro_torch.kernels import ops
from repro_torch.kernels import blockwise_topk as k5
from repro_torch.models import recsys
from repro_torch.models.common import tree_map

pytestmark = pytest.mark.cuda

RTOL = ATOL = 1e-4
K = 100


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _smoke():
    """``chip_smoke.py``, for its batch and candidate draws
    (``recsys_inputs``, ``recsys_candidates``): the tests draw as phase 11
    does."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_mind_cells_full_width_match_the_cpu(cuda_device):
    cfg = configs.get_config("mind")
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    params = recsys.init_params(gen, cfg, device=cuda_device)
    cpu_params = tree_map(lambda t: t.cpu(), params)
    smoke = _smoke()
    seen = []
    for cell in configs.get_cells("mind"):
        if cell.kind == "train":            # phase 13's and the train tests'
            continue
        fn, args = cell.build(None)
        batch = smoke.recsys_inputs(cfg, args[1], gen,
                                    serve=cell.kind == "serve")
        cpu_batch = {k: v.cpu() for k, v in batch.items()}
        if cell.kind == "serve":
            got = fn(params, batch)
            want = recsys.forward(cfg, cpu_params, cpu_batch)
            assert bool(torch.isfinite(got).all())
            torch.testing.assert_close(got.cpu(), want, rtol=RTOL,
                                       atol=ATOL)
        else:
            cands = smoke.recsys_candidates(cfg, args[2].shape[0], gen)
            before = k5.LAUNCHES.n
            idx, vals = fn(params, batch, cands)
            assert k5.LAUNCHES.n > before
            scores = recsys.retrieval_scores(cfg, params, batch, cands)
            want = recsys.retrieval_scores(cfg, cpu_params, cpu_batch,
                                           cands.cpu())
            torch.testing.assert_close(scores.cpu(), want, rtol=RTOL,
                                       atol=ATOL)
            tv, ti = ops.topk(scores.cpu(), K, block=4096)
            assert torch.equal(idx.cpu(), ti)
            assert torch.equal(vals.cpu().view(torch.int32),
                               tv.view(torch.int32))
            # each id its own score on the CPU too, within the tolerance
            torch.testing.assert_close(want.gather(1, idx.cpu().long()),
                                       vals.cpu(), rtol=RTOL, atol=ATOL)
        seen.append(cell.shape)
    assert seen == ["serve_p99", "serve_bulk", "retrieval_cand"]


def test_autoint_tied_board_bitwise_equal_to_the_twin(cuda_device):
    cfg = configs.get_config("autoint")
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    params = recsys.init_params(gen, cfg, device=cuda_device)
    cell = [c for c in configs.get_cells("autoint")
            if c.shape == "retrieval_cand"][0]
    fn, args = cell.build(None)
    smoke = _smoke()
    batch = smoke.recsys_inputs(cfg, args[1], gen, serve=False)
    n = args[2].shape[0]
    cands = smoke.recsys_candidates(cfg, n, gen)
    before = k5.LAUNCHES.n
    idx, vals = fn(params, batch, cands)
    assert k5.LAUNCHES.n == before + 1
    scores = recsys.retrieval_scores(cfg, params, batch, cands)
    # 64 candidate values, a few more scores (the card's GEMMs may round
    # a row by its position): thousands of candidates a score
    assert torch.unique(scores).numel() < n // 1000
    tv, ti = ops.topk(scores.cpu(), K, block=4096)
    assert torch.equal(idx.cpu(), ti)
    assert torch.equal(vals.cpu().view(torch.int32), tv.view(torch.int32))
    # the tie rule: every value above the board's last is in whole; at
    # the last value, its lowest candidate positions
    s, ids, v = scores[0].cpu(), idx[0].long().cpu(), vals[0].cpu()
    assert torch.unique(v).numel() < K // 10              # a block of ties
    last = v[-1]
    above = torch.nonzero(s > last).flatten()
    assert torch.equal(torch.sort(ids[v > last]).values, above)
    at = torch.nonzero(s == last).flatten()[:int((v == last).sum())]
    assert torch.equal(ids[v == last], at)
