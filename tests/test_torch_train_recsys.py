"""The recsys family's training path on the port against the reference's.

The four archs' f32 smokes (DLRM, AutoInt, SASRec, MIND; ``take_rows``'
fixed-order backward, repeated items and pads in the histories): the loss
and every grad leaf (``torch_train_parity.check_grads``), and one whole
``make_train_step`` (``check_step``) for each arch, SASRec's at M = 1 and
2 with ``compress`` off and on.
"""

import pytest

from torch_train_parity import check_grads, check_step

ARCHS = ["dlrm-mlperf", "autoint", "sasrec", "mind"]
STEPS = [(f"recsys:{a}", 1, False) for a in ARCHS if a != "sasrec"] + [
    ("recsys:sasrec", m, c) for m in (1, 2) for c in (False, True)]


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    check_grads(f"recsys:{arch}")


@pytest.mark.parametrize("case,m,compress", STEPS)
def test_train_step_matches_reference(case, m, compress):
    check_step(case, m, compress)
