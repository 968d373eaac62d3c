"""The port stands alone: no JAX, no ``repro``, kernels built on demand.

* ``import repro_torch`` (and every subpackage) leaves ``jax`` out of
  ``sys.modules``;
* an AST scan finds no import of ``jax`` or ``repro`` in any module of
  ``src/repro_torch`` or in ``chip_smoke.py``;
* every CUDA source names the TPU kernel it replaces and its bound;
* the build step keys each library by its sources and looks for its
  compiler only when asked to build (this suite imports every module
  without one);
* ``chip_smoke.py`` exits non-zero and prints no result without a GPU and
  outside the repository.
"""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _run(args, cwd, env_extra=None, timeout=120):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.update(env_extra or {})
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_import_leaves_jax_out_of_sys_modules():
    code = ("import sys, repro_torch, repro_torch.core, repro_torch.sparse, "
            "repro_torch.kernels, repro_torch.serve, repro_torch.convert, "
            "repro_torch.kernels.ops\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\nprint('clean')")
    r = _run(["-c", code], cwd=ROOT)
    assert r.returncode == 0, r.stderr
    assert "clean" in r.stdout


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0], node.lineno


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py"))
                         + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_module_imports_jax_or_repro(path):
    bad = [(m, ln) for m, ln in _imported_roots(path) if m in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("name", ["bm25_resident", "bm25_block_score"])
def test_cuda_sources_carry_their_note(name):
    src = (PORT / "kernels" / "csrc" / f"{name}.cu").read_text()
    assert "Replaces: src/repro/kernels/" in src
    assert "Bound on the H100" in src
    assert "__fadd_rn" in src and "__fmul_rn" in src   # no FMA contraction
    assert "atomicAdd" not in src                      # fixed sum order


def test_build_is_keyed_by_source_and_finds_nvcc_on_demand(monkeypatch,
                                                            tmp_path):
    from repro_torch.kernels import _build
    a = _build.library_path("bm25_resident")
    assert a == _build.library_path("bm25_resident")
    assert a != _build.library_path("bm25_block_score")
    assert a.parent == _build.BUILD_DIR and a.suffix == ".so"
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(shutil, "which", lambda name: None)
    if not Path("/usr/local/cuda/bin/nvcc").exists():
        with pytest.raises(RuntimeError, match="nvcc"):
            _build.nvcc_path()


def test_chip_smoke_fails_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the smoke would run for real")
    r = _run([str(ROOT / "chip_smoke.py")], cwd=ROOT)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_chip_smoke_fails_outside_the_repository(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env={k: v for k, v in os.environ.items()
                            if k != "PYTHONPATH"},
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
