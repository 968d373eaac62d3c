"""``python -m repro_torch.launch.train``: the training launcher on the port.

The port's launcher takes the reference's flags (plus ``--device``) and
prints its ``[train]`` lines: for one arch of each family (lm, recsys,
gnn) at ``--smoke --device cpu`` it trains, checkpoints and, run again
with more steps on the same ``--ckpt-dir``, resumes from the newest
complete step (no step at or below it is logged again); the reference's
launcher prints the same lines but for the numbers. ``--arch bm25s``
exits with the reference's message; without ``--device`` and without a
GPU the launcher raises ``ResidencyError`` instead of training on the
host.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.serve.errors import ResidencyError
from repro_torch.train.checkpoint import latest_complete_step

ROOT = Path(__file__).resolve().parents[1]
STEP = re.compile(r"\[train\] step +(\d+) loss ([\d.]+) lr [\d.e+-]+$")


def _train(package, *args, check=True):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-m", f"{package}.launch.train",
                        *args], cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=300)
    if check:
        assert r.returncode == 0, r.stderr[-3000:]
    return r


@pytest.mark.parametrize("arch,family", [("gemma3-1b", "lm"),
                                         ("sasrec", "recsys"),
                                         ("egnn", "gnn")])
def test_launcher_trains_resumes_and_prints_the_reference_lines(
        arch, family, tmp_path):
    ck = str(tmp_path / "ck")
    out = _train("repro_torch", "--arch", arch, "--smoke", "--device", "cpu",
                 "--steps", "3", "--ckpt-dir", ck, "--batch", "4",
                 "--seq-len", "16").stdout.strip().splitlines()
    assert out[0] == (f"[train] arch={arch} family={family} "
                      f"mesh={{'data': 1, 'model': 1}} smoke=True")
    assert re.fullmatch(r"\[train\] [\d.]+M params", out[1])
    (s,) = [STEP.match(ln) for ln in out[2:-1]]
    assert int(s.group(1)) == 3 and float(s.group(2)) > 0
    assert out[-1] == "[train] done"
    assert latest_complete_step(ck) == 3
    again = _train("repro_torch", "--arch", arch, "--smoke", "--device",
                   "cpu", "--steps", "12", "--ckpt-dir", ck, "--batch", "4",
                   "--seq-len", "16").stdout.strip().splitlines()
    logged = [int(STEP.match(ln).group(1)) for ln in again[2:-1]]
    assert logged == [10, 12]                  # from step 3, not from 0
    assert latest_complete_step(ck) == 12
    ref = _train("repro", "--arch", arch, "--smoke", "--steps", "3",
                 "--batch", "4", "--seq-len", "16").stdout.strip().splitlines()
    assert len(ref) == len(out) and ref[0] == out[0]
    assert STEP.match(ref[2]).group(1) == "3"


def test_launcher_refuses_what_does_not_train():
    r = _train("repro_torch", "--arch", "bm25s", "--smoke", "--device", "cpu",
               check=False)
    ref = _train("repro", "--arch", "bm25s", "--smoke", check=False)
    msg = "--arch bm25s is not trainable (family=bm25s); use launch/serve.py"
    assert r.returncode != 0 and ref.returncode != 0
    assert r.stderr.strip().splitlines()[-1] == msg
    assert ref.stderr.strip().splitlines()[-1] == msg


def test_launcher_defaults_to_the_card(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device exists")
    from repro_torch.launch import train
    with pytest.raises(ResidencyError):
        train.main(["--arch", "egnn", "--smoke", "--steps", "1"])
    import torch.distributed as tdist
    assert not tdist.is_initialized()
