"""``python -m repro_torch.launch.serve``: the serving launcher on the port.

The port's launcher takes the reference's flags and prints its lines:
the same indexing line, the same posting count (the corpus generator and
the index build are byte-identical per seed), the same stream summary and
degradation count; ``--straggle`` hedges the slow shard away under the
4-shard quorum and ``--rescale`` re-shards mid-stream, as in the
reference. ``--device cpu`` runs the shard retrievers' kernel twins on
the host; without ``--device`` and without a GPU the launcher raises
``ResidencyError`` instead of falling back to the host.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.serve.errors import ResidencyError

ROOT = Path(__file__).resolve().parents[1]
SUMMARY = re.compile(r"\[serve\] (\d+) queries  [\d.]+ QPS  p50 [\d.]+ms  "
                     r"p99 [\d.]+ms  degraded (\d+)/(\d+)$")
POSTINGS = re.compile(r"\[serve\] indexed in [\d.]+s \(([\d.]+)M postings\)$")


def _serve(package, *args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-m", f"{package}.launch.serve",
                        *args], cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout.strip().splitlines()


def _same_lines(mine, ref):
    assert len(mine) == len(ref)
    assert mine[0] == ref[0]
    assert POSTINGS.match(mine[1]).group(1) == POSTINGS.match(ref[1]).group(1)
    for a, b in zip(mine[2:-1], ref[2:-1]):
        assert a == b
    got, want = SUMMARY.match(mine[-1]), SUMMARY.match(ref[-1])
    assert got and want and got.groups() == want.groups()
    return got.groups()


def test_launcher_prints_the_reference_lines():
    args = ("--docs", "2000", "--shards", "2", "--queries", "20")
    mine = _serve("repro_torch", "--device", "cpu", *args)
    ref = _serve("repro", *args)
    assert mine[0] == ("[serve] indexing 2000 docs (lucene, k1=1.5, "
                       "b=0.75) into 2 shards...")
    assert _same_lines(mine, ref) == ("20", "0", "20")


def test_launcher_straggle_and_rescale_as_the_reference():
    """Two queries on 4 shards hedge the sleeping shard 0 away (degraded),
    two more after the re-shard to 2 wait for it (the quorum needs both)."""
    args = ("--docs", "2000", "--shards", "4", "--queries", "4",
            "--straggle", "--deadline-ms", "50", "--rescale", "2",
            "--variant", "bm25+")
    mine = _serve("repro_torch", "--device", "cpu", *args)
    ref = _serve("repro", *args)
    assert "[serve] elastic re-shard -> 2" in mine
    assert _same_lines(mine, ref) == ("4", "2", "4")


def test_launcher_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the launcher would run on it")
    from repro_torch.launch.serve import main
    with pytest.raises(ResidencyError, match="device='cpu'"):
        main(["--docs", "50", "--queries", "1"])
