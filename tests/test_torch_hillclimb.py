"""``launch/hillclimb.py`` against the reference's, and ``main`` on a fake
group.

* The variants: ``_variants()`` gives the reference's cell keys and
  variant names, and for each variant the same note, ``model_flops``,
  microbatch count (the train step's ``n_microbatches``), re-mesh shape
  and argument shapes and dtypes (params, optimizer state, batch, caches,
  blocked postings and tables: the reference's ``ShapeDtypeStruct``
  leaves against the port's ``meta`` tensors). The reference's variants
  are built in a subprocess: its module sets ``XLA_FLAGS`` for 512
  devices when imported.
* ``main(["--cell", "bm25s/score_blocked_2m", "--world", "8", ...])`` runs
  the three bm25s variants on 8 fake ranks (a subprocess: a ``fake``
  group never goes into a test process) into a temporary file: each
  record ``ok``, partitioned, under ``<cell>#<variant>@1x8``; the bf16
  variant counts the f32 one's FLOPs, filed under float32 (K6 and K5
  compare and sum in f32), and fewer bytes; a second ``main`` skips
  them.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro_torch.launch import hillclimb

ROOT = Path(__file__).resolve().parents[1]

REF_SCRIPT = textwrap.dedent("""
    import json
    import numpy as np
    import jax
    from repro.launch import hillclimb
    from repro.launch.mesh import make_production_mesh

    mesh = make_production_mesh(multi_pod=False)
    out = {}
    for key, vs in hillclimb._variants().items():
        for name, cell in vs.items():
            fn, args = cell.build(mesh)
            code = getattr(fn, "__code__", None)
            free = {} if code is None else dict(zip(
                code.co_freevars, (c.cell_contents for c in fn.__closure__)))
            remesh = None
            if cell.remesh is not None:
                remesh = list(cell.remesh(mesh).devices.shape)
            out[key + "#" + name] = dict(
                note=cell.note, model_flops=cell.model_flops,
                key=cell.key, kind=cell.kind,
                microbatches=free.get("n_microbatches"), remesh=remesh,
                args=[[list(a.shape), str(np.dtype(a.dtype))]
                      for a in jax.tree_util.tree_leaves(args)])
    print("RESULT" + json.dumps(out))
""")

MAIN_SCRIPT = textwrap.dedent("""
    import json, sys
    from repro_torch.launch import hillclimb
    from repro_torch.launch.dryrun import fake_group
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models.common import tree_paths

    got = {}
    with fake_group(256):
        mesh = make_production_mesh(device_type="cpu")
        for key, vs in hillclimb._variants().items():
            for name, cell in vs.items():
                fn, args = cell.build(mesh)
                code = getattr(fn, "__code__", None)
                free = {} if code is None else dict(zip(
                    code.co_freevars,
                    (c.cell_contents for c in fn.__closure__)))
                remesh = None
                if cell.remesh is not None:
                    remesh = list(cell.remesh(mesh).mesh.shape)
                got[key + "#" + name] = dict(
                    note=cell.note, model_flops=cell.model_flops,
                    key=cell.key, kind=cell.kind,
                    microbatches=free.get("n_microbatches"), remesh=remesh,
                    args=[[list(a.shape),
                           str(a.dtype).removeprefix("torch.")]
                          for _, a in tree_paths(args)])
    argv = ["--cell", "bm25s/score_blocked_2m", "--world", "8", "--out",
            sys.argv[1]]
    hillclimb.main(argv)
    hillclimb.main(argv)            # every record ok: all skipped
    print("RESULT" + json.dumps(got))
""")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("hillclimb") / "hillclimb_torch.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen([sys.executable, "-c", s, *a], cwd=ROOT,
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for s, a in ((REF_SCRIPT, ()), (MAIN_SCRIPT, (str(out),)))]
    outs = []
    for p in procs:
        stdout, err = p.communicate(timeout=600)
        assert p.returncode == 0, err[-3000:]
        outs.append(stdout)
    ref, port = ([ln for ln in o.splitlines() if ln.startswith("RESULT")][-1]
                 for o in outs)
    return (json.loads(ref[len("RESULT"):]), json.loads(out.read_text()),
            outs[1], json.loads(port[len("RESULT"):]))


@pytest.mark.parametrize("field", ["note", "key", "kind", "model_flops",
                                   "microbatches", "remesh", "args"])
def test_the_variants_are_the_reference_ones(runs, field):
    """Keys and names, and for each variant the field, as the reference's;
    the arguments leaf for leaf in the reference's (sorted key) order, the
    re-mesh as the (dp, tp) shape of the 256 ranks."""
    want, got = runs[0], runs[3]
    assert list(got) == list(want) and len(got) == 13
    for key, w in want.items():
        if field == "model_flops":
            assert got[key][field] == pytest.approx(w[field], rel=1e-12), key
        else:
            assert got[key][field] == w[field], key


def test_the_remeshes_are_the_named_splits(runs):
    """dp64tp4 is a (64, 4) mesh, dp32tp8 (32, 8), dp256tp1 (256, 1)."""
    shapes = {k: w["remesh"] for k, w in runs[3].items() if w["remesh"]}
    assert len(shapes) == 7
    for key, shape in shapes.items():
        dp, tp = (int(x) for x in key.split("#")[1].split("_")[0][2:]
                  .split("tp"))
        assert shape == [dp, tp], key


@pytest.mark.parametrize("variant", ["topk2stage", "topk2stage_bf16",
                                     "topk2stage_bf16_b1024"])
def test_main_runs_the_bm25s_variants_on_a_fake_group(runs, variant):
    saved = runs[1]
    rec = saved[f"bm25s/score_blocked_2m#{variant}@1x8"]
    assert rec["ok"] and rec["variant"] == variant
    assert rec["n_chips"] == 8
    assert rec["flops"] > 0 and rec["collectives"]
    assert rec["memory"]["temp_size_b"] > 0
    # K6 and K5 compute in f32 in either instantiation
    assert "bfloat16" not in rec["flops_by_dtype"]
    f32 = saved["bm25s/score_blocked_2m#topk2stage@1x8"]
    if variant == "topk2stage_bf16":
        assert rec["flops"] == f32["flops"]
        assert rec["bytes"] < f32["bytes"]
        assert rec["memory"]["argument_size_b"] < f32["memory"][
            "argument_size_b"]
    if variant == "topk2stage_bf16_b1024":
        b256 = saved["bm25s/score_blocked_2m#topk2stage_bf16@1x8"]
        assert rec["model_flops"] == pytest.approx(4 * b256["model_flops"])


def test_main_skips_what_is_done(runs):
    assert runs[2].count("[hillclimb] skip") == 3
    assert sorted(runs[1]) == sorted(
        f"bm25s/score_blocked_2m#{v}@1x8" for v in (
            "topk2stage", "topk2stage_bf16", "topk2stage_bf16_b1024"))


def test_main_writes_under_build_by_default():
    import inspect

    src = inspect.getsource(hillclimb.main)
    assert 'default="build/hillclimb_torch.json"' in src
    assert "benchmarks/" not in src
