"""The port stands alone: no JAX, no ``repro``, kernels built on demand.

* ``import repro_torch`` (and every subpackage, ``dist``, ``launch`` with
  ``train``, ``kernels.ref``, ``models`` with ``transformer`` and
  ``egnn``, ``serve`` with ``decode_engine``, ``train`` with each of its
  modules, and ``configs`` with each config module, the LM ones and
  EGNN's among them) leaves ``jax`` out of ``sys.modules``, and
  importing ``launch.mesh`` starts no process group;
* an AST scan finds no import of ``jax`` or ``repro`` in any module of
  ``src/repro_torch``, in ``chip_smoke.py`` or in ``tools/``, and no
  ``sys.modules.get`` of a ``repro.`` module (the fault sites peek at
  ``repro_torch.serve.faults``);
* every CUDA source names the TPU kernel it replaces and its bound, and
  every one is built; the BM25 sources round each product and sum
  separately, and no source adds with atomics;
* the build step keys each library by its sources and looks for its
  compiler only when asked to build (this suite imports every module
  without one);
* ``chip_smoke.py`` exits non-zero and prints no result without a GPU and
  outside the repository, and ``tools/time_board_kernels.py`` exits 2
  without a GPU.
"""

import ast
import os
import re
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
            "repro_torch.kernels.ops, repro_torch.serve.faults, "
            "repro_torch.serve.overload, repro_torch.serve.health, "
            "repro_torch.serve.retrieval_engine, repro_torch.serve.frontend, "
            "repro_torch.core.scoring, "
            "repro_torch.kernels.blockwise_topk, "
            "repro_torch.kernels.bm25_block_score, repro_torch.device, "
            "repro_torch.data, repro_torch.data.graphs, "
            "repro_torch.data.corpus, repro_torch.data.clicklogs, "
            "repro_torch.data.lm, repro_torch.sparse.reorder, "
            "repro_torch.sparse.snapshot, "
            "repro_torch.sparse.segment_ops, "
            "repro_torch.sparse.embedding_bag, "
            "repro_torch.kernels.block_segment_sum, "
            "repro_torch.kernels.embedding_bag, repro_torch.dist, "
            "repro_torch.dist.sharding, repro_torch.launch, "
            "repro_torch.launch.mesh, repro_torch.launch.serve, "
            "repro_torch.kernels.ref, repro_torch.models, "
            "repro_torch.models.common, repro_torch.models.recsys, "
            "repro_torch.configs, repro_torch.configs.common, "
            "repro_torch.configs.dlrm_mlperf, repro_torch.configs.autoint, "
            "repro_torch.configs.mind, repro_torch.configs.sasrec, "
            "repro_torch.models.transformer, "
            "repro_torch.serve.decode_engine, "
            "repro_torch.configs.gemma3_1b, "
            "repro_torch.configs.h2o_danube3_4b, "
            "repro_torch.configs.qwen3_8b, "
            "repro_torch.configs.mixtral_8x7b, "
            "repro_torch.configs.mixtral_8x22b, "
            "repro_torch.train, repro_torch.train.optimizer, "
            "repro_torch.train.step, repro_torch.train.grad_compress, "
            "repro_torch.train.checkpoint, repro_torch.train.loop, "
            "repro_torch.models.egnn, repro_torch.configs.egnn, "
            "repro_torch.launch.train\n"
            "from repro_torch.configs import all_cells, get_cells\n"
            "for c in all_cells():\n    c.build(None)\n"
            "from repro_torch.convert import recsys_params_from_reference\n"
            "from repro_torch.convert import lm_params_from_reference\n"
            "from repro_torch.convert import (egnn_params_from_reference, "
            "train_state_from_reference)\n"
            "from repro_torch.train import AdamW, make_train_step\n"
            "from repro_torch.serve import DecodeEngine\n"
            "from repro_torch.core import BM25Retriever, score_batch\n"
            "from repro_torch.serve import ServingFrontend\n"
            "from repro_torch.kernels.ops import topk, bm25_score_blocked\n"
            "from repro_torch.kernels.ops import (embedding_bag, "
            "segment_sum_blocked)\n"
            "from repro_torch.core import sharded_retrieve_adaptive\n"
            "from repro_torch.core.retrieval import (make_sharded_retrieve, "
            "stack_shard_arrays)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\nprint('clean')")
    r = _run(["-c", code], cwd=ROOT)
    assert r.returncode == 0, r.stderr
    assert "clean" in r.stdout


def test_importing_the_mesh_module_starts_no_process_group():
    """The mesh builders are functions: importing ``launch.mesh`` (and the
    sharding layer) initialises no ``torch.distributed`` group."""
    code = ("import torch.distributed as d\n"
            "import repro_torch.launch.mesh, repro_torch.dist\n"
            "from repro_torch.launch.mesh import make_production_mesh\n"
            "assert not d.is_initialized()\nprint('clean')")
    r = _run(["-c", code], cwd=ROOT)
    assert r.returncode == 0, r.stderr
    assert "clean" in r.stdout


def test_serving_stack_leaves_the_fault_harness_out():
    """The fault sites peek at ``sys.modules``: importing and running the
    serving stack never imports ``repro_torch.serve.faults`` itself."""
    code = ("import sys, numpy as np\n"
            "from repro_torch.core import build_index\n"
            "from repro_torch.serve import DeviceRetriever\n"
            "idx = build_index([np.array([0, 1], np.int32)], 2)\n"
            "DeviceRetriever(idx, device='cpu', gather='host', block_size=8,"
            " tile=8, acc_block=8, q_max=8).retrieve_batch("
            "[np.array([1], np.int32)], 1)\n"
            "assert 'repro_torch.serve.faults' not in sys.modules\n"
            "print('clean')")
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


def _sys_modules_lookups(path: Path):
    """The string constants passed to ``sys.modules.get`` (the fault
    sites' peek at the harness), with their lines."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "get"
                and isinstance(node.func.value, ast.Attribute)
                and node.func.value.attr == "modules"
                and node.args and isinstance(node.args[0], ast.Constant)
                and isinstance(node.args[0].value, str)):
            yield node.args[0].value, node.lineno


PY_PATHS = (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
            + sorted((ROOT / "tools").glob("*.py")))


@pytest.mark.parametrize("path", PY_PATHS,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_module_imports_jax_or_repro(path):
    """No import of ``jax`` or ``repro``, and no ``sys.modules.get`` of a
    ``repro.`` (or jax) module: a copied fault site that peeks at
    ``"repro.serve.faults"`` imports nothing, but never fires."""
    bad = [(m, ln) for m, ln in _imported_roots(path) if m in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"
    bad = [(m, ln) for m, ln in _sys_modules_lookups(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} looks up {bad} in sys.modules"


def test_the_sys_modules_scan_finds_the_fault_sites():
    """The scan sees every fault site's peek (so an empty result above
    means the names are right, not that the scan is blind)."""
    found = {(p.relative_to(PORT).as_posix(), m)
             for p in sorted(PORT.rglob("*.py"))
             for m, _ in _sys_modules_lookups(p)}
    assert {("serve/frontend.py", "repro_torch.serve.faults"),
            ("serve/retrieval_engine.py", "repro_torch.serve.faults"),
            ("sparse/fragment_device.py", "repro_torch.serve.faults")} <= found


@pytest.mark.parametrize("name", ["bm25_resident", "bm25_block_score",
                                  "bm25_gather_score"])
def test_cuda_sources_carry_their_note(name):
    src = (PORT / "kernels" / "csrc" / f"{name}.cu").read_text()
    assert "Replaces: src/repro/kernels/" in src
    assert "Bound on the H100" in src
    assert "__fadd_rn" in src and "__fmul_rn" in src   # no FMA contraction
    assert "atomicAdd" not in src                      # fixed sum order


def _code(text: str) -> str:
    """A CUDA source without its comments."""
    return re.sub(r"//[^\n]*", "", text)


def test_block_scatter_is_gone_and_no_k_round_select_remains():
    """K2 and K4 left their first template: ``block_scatter.cuh`` is
    deleted and included by no source, and no source keeps the k-round
    column select (``column_best`` / ``column_take``)."""
    csrc = PORT / "kernels" / "csrc"
    assert not (csrc / "block_scatter.cuh").exists()
    for f in sorted(csrc.glob("*.cu*")):
        code = _code(f.read_text())
        assert "block_scatter" not in code, f.name
        assert "column_best" not in code and "column_take" not in code, \
            f.name


@pytest.mark.parametrize("name", ["block_walk.cuh", "threshold_fold.cuh",
                                  "block_topk.cuh", "owner_round.cuh"])
def test_shared_headers_round_and_use_no_atomics(name):
    """The headers K1-K4 and K6 share: none adds with atomics; the walk's
    sums are owner_round.cuh's, rounded separately (__fmul_rn then
    __fadd_rn: no FMA contraction), and each header names them."""
    csrc = PORT / "kernels" / "csrc"
    src = (csrc / name).read_text()
    assert "atomic" not in _code(src)
    assert "__fadd_rn" in src and "__fmul_rn" in src
    rounds = _code((csrc / "owner_round.cuh").read_text())
    assert "__fadd_rn(" in rounds and "__fmul_rn(" in rounds
    includes = {
        "block_walk.cuh": ["owner_round.cuh"],
        "block_topk.cuh": ["block_walk.cuh", "threshold_fold.cuh"],
        "threshold_fold.cuh": ["owner_round.cuh", "select_topk.cuh"],
        "owner_round.cuh": []}[name]
    for inc in includes:
        assert f'#include "{inc}"' in src


@pytest.mark.parametrize("name,uses", [
    ("bm25_block_score", ["block_topk<false>", "walk_block("]),
    ("bm25_gather_score", ["block_topk<true>", "launch_board_merge("]),
    ("bm25_resident", ["fold_mark(", "fold_merge(", "owner_round("])])
def test_kernels_share_the_walk_and_the_fold(name, uses):
    """K2 and K4 run the shared body (the walk, then the threshold fold);
    K6 the walk alone; K1/K3 the owner rounds and the same fold."""
    code = _code((PORT / "kernels" / "csrc" / f"{name}.cu").read_text())
    for u in uses:
        assert u in code, u


def test_topk_source_carries_its_note():
    src = (PORT / "kernels" / "csrc" / "blockwise_topk.cu").read_text()
    assert ("Replaces: src/repro/kernels/blockwise_topk.py::"
            "blockwise_topk_kernel") in src
    assert "Bound on the H100" in src
    # one CTA owns a segment; its only atomics count keys in the radix
    # select's integer histogram (exact in any order), never a float
    assert re.findall(r"atomic\w*\(([^,]+),", src) == [
        "&hist[(key >> shift) & (kBins - 1)]"]
    assert "unsigned hist[kBins]" in src
    # the total order is rank_order's: -0.0 folded onto +0.0 first
    assert "__float_as_uint(__fadd_rn(v, 0.0f))" in src


@pytest.mark.parametrize("name,replaces", [
    ("block_segment_sum", "block_segment_sum.py::block_segment_sum"),
    ("embedding_bag", "embedding_bag.py::embedding_bag_kernel")])
def test_sparse_sources_carry_their_note(name, replaces):
    """K7 and K8 name the TPU kernel and their bound, add with ``__fadd_rn``
    (K8 also rounds its products with ``__fmul_rn``) and use no atomics:
    every output element has one writer that sums in input order."""
    src = (PORT / "kernels" / "csrc" / f"{name}.cu").read_text()
    assert f"Replaces: src/repro/kernels/{replaces}" in src
    assert "Bound on the H100" in src
    assert "__fadd_rn" in src
    assert "__fmul_rn" in src or name == "block_segment_sum"
    assert "atomic" not in src


def test_build_is_keyed_by_source_and_finds_nvcc_on_demand(monkeypatch,
                                                            tmp_path):
    from repro_torch.kernels import _build
    a = _build.library_path("bm25_resident")
    assert a == _build.library_path("bm25_resident")
    assert a != _build.library_path("bm25_block_score")
    assert set(_build.SOURCES) == {p.stem for p in
                                   (PORT / "kernels" / "csrc").glob("*.cu")}
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


def test_time_board_kernels_fails_without_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the tool would run for real")
    r = _run([str(ROOT / "tools" / "time_board_kernels.py"), str(tmp_path),
              "--src", str(ROOT / "src"), "--label", "cpu"], cwd=ROOT)
    assert r.returncode == 2
    assert "no CUDA device" in r.stderr


def test_chip_smoke_fails_outside_the_repository(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env={k: v for k, v in os.environ.items()
                            if k != "PYTHONPATH"},
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
