"""The LM family's training path on the port against the reference's.

gemma3-1b's and mixtral-8x7b's f32 smokes (local and global attention,
and the MoE dispatch with dropped tokens): the loss and every grad leaf
(``torch_train_parity.check_grads``), and one whole ``make_train_step``
(``check_step``): gemma3-1b at M = 1 and 2 with ``compress`` off and on,
mixtral-8x7b at M = 2. ``loss_fn`` runs each layer and each loss chunk
under ``torch.utils.checkpoint`` (non-reentrant), as the reference remats
them, and the embedding gather is ``gather_rows``.
"""

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.models import transformer as pt
from torch_train_parity import check_grads, check_step

STEPS = [("lm:gemma3-1b", m, c) for m in (1, 2) for c in (False, True)] \
    + [("lm:mixtral-8x7b", 2, False)]


@pytest.mark.parametrize("case", ["lm:gemma3-1b", "lm:mixtral-8x7b"])
def test_loss_and_grads_match_reference(case):
    check_grads(case)


@pytest.mark.parametrize("case,m,compress", STEPS)
def test_train_step_matches_reference(case, m, compress):
    check_step(case, m, compress)


def test_layers_and_loss_chunks_are_checkpointed(monkeypatch):
    cfg = configs.get_smoke("gemma3-1b")
    params = pt.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(2, 48)).astype(np.int32))
    seen, gathers = [], []
    real, real_gather = pt.checkpoint, pt.gather_rows

    def spy(fn, *args, **kw):
        seen.append((fn.__name__, kw.get("use_reentrant")))
        return real(fn, *args, **kw)

    def gather_spy(table, ids, **kw):
        gathers.append(tuple(ids.shape))
        return real_gather(table, ids, **kw)

    monkeypatch.setattr(pt, "checkpoint", spy)
    monkeypatch.setattr(pt, "gather_rows", gather_spy)
    pt.loss_fn(cfg, params, {"tokens": toks, "labels": toks})
    assert seen == [("_layer_fwd", False)] * cfg.n_layers + [
        ("_chunk_ce", False)] * (48 // cfg.loss_chunk)
    assert gathers == [(2 * 48,)]
