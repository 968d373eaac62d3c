"""The port's dry run end to end, the counterpart of
``tests/test_dryrun_integration.py``.

One subprocess (its ``fake`` process groups never meet the gloo groups
of other tests in an xdist worker) runs ``launch.dryrun.run_cell`` on 8
fake ranks (``make_mesh_from``'s (1, 8) mesh) for ``egnn/molecule``,
``sasrec/serve_p99``, ``mind/retrieval_cand`` and both bm25s cells, then
``bm25s/score_2m`` on the 16 × 16 production mesh of 256 fake ranks, and
``launch.dryrun.main`` for ``--arch bm25s --multi-pod both`` into a JSON
file; ``launch.report``'s three tables run over that file. The records
carry their keys, ``flops > 0``, a bottleneck in {compute, memory,
collective}, ``compute_s`` at the f32 rate for these f32 cells (and the
roofline divides each dtype's FLOPs by its own rate); ``score_2m`` its one all-gather of S · B · (2 · kk + 1) · 4
bytes and a peak of live temporaries; every record a partitioned step's:
a ``collectives`` dict, temporaries, and on a mesh whose data axis holds
two ranks or more wire bytes. No TPU figure stands in ``launch/``.
"""

import json
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro_torch.configs import bm25s
from repro_torch.launch import dryrun, report

ROOT = Path(__file__).resolve().parents[1]
CELLS = [("egnn", "molecule"), ("sasrec", "serve_p99"),
         ("mind", "retrieval_cand"), ("bm25s", "score_2m"),
         ("bm25s", "score_blocked_2m")]
KEYS = {"arch", "shape", "kind", "mesh", "axes", "n_chips", "trace_s",
        "count_bound", "memory",
        "collectives", "flops", "bytes", "flops_per_device",
        "bytes_per_device", "collective_wire_bytes_per_device",
        "compute_s", "memory_s", "collective_s", "bottleneck",
        "flops_by_dtype", "peak_flops", "model_flops", "useful_flops_ratio", "step_time_bound_s",
        "roofline_fraction", "device", "note", "ok", "microbatches"}

SCRIPT = textwrap.dedent("""
    import json, sys
    from repro_torch.configs import get_cells
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh_from, make_production_mesh

    cells = json.loads(sys.argv[1])
    out = {}
    with dryrun.fake_group(8):
        from repro_torch.launch.mesh import check_mesh_backend
        check_mesh_backend("cuda")
        check_mesh_backend("cpu")
        out["fake_serves"] = ["cuda", "cpu"]
        mesh = make_mesh_from(device_type="cpu")
        for arch, shape in cells:
            cell = [c for c in get_cells(arch) if c.shape == shape][0]
            out[cell.key + "@" + "x".join(map(str, mesh.shape))] = \\
                dryrun.run_cell(cell, mesh, verbose=False)
    with dryrun.fake_group(256):
        mesh = make_production_mesh(device_type="cpu")
        cell = get_cells("bm25s")[0]
        out[cell.key + "@16x16"] = dryrun.run_cell(cell, mesh,
                                                   verbose=False)
    dryrun.main(["--arch", "bm25s", "--multi-pod", "both", "--out",
                 sys.argv[2]])
    print("RESULT" + json.dumps(out))
""")


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun") / "dryrun_torch.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT, json.dumps(CELLS), str(out)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("RESULT")][-1]
    return json.loads(line[len("RESULT"):]), json.loads(out.read_text())


@pytest.mark.parametrize("key", [f"{a}/{s}@1x8" for a, s in CELLS]
                         + ["bm25s/score_2m@16x16"])
def test_cell_traces_and_produces_roofline(results, key):
    r = results[0][key]
    assert set(r) == KEYS
    mb = r["microbatches"]          # a train step's; unpartitioned: as made
    assert mb is None or mb["run"] == mb["configured"] >= 1
    assert r["ok"] and r["flops"] > 0 and r["flops_per_device"] > 0
    assert r["bottleneck"] in ("compute", "memory", "collective")
    assert r["memory"]["argument_size_b"] > 0
    assert r["step_time_bound_s"] == max(
        r[t] for t in ("compute_s", "memory_s", "collective_s"))
    assert r["device"] == "NVIDIA H100 80GB HBM3, 700 W"
    # every one of these cells computes in f32: the f32 rate, not bf16's
    assert sum(r["flops_by_dtype"].values()) == pytest.approx(r["flops"])
    assert "bfloat16" not in r["flops_by_dtype"]
    assert r["peak_flops"] == pytest.approx(dryrun.PEAK_FLOPS_F32)
    assert r["compute_s"] == pytest.approx(r["flops_per_device"] / 67e12)


def test_roofline_divides_each_dtype_by_its_peak():
    r = dryrun.roofline({"bfloat16": 8 * 989.4e12, "float32": 8 * 67e12},
                        0.0, 0.0, 8, 8 * 989.4e12)
    assert r["compute_s"] == pytest.approx(2.0)
    assert r["bottleneck"] == "compute" and r["collective_s"] == 0.0
    assert r["peak_flops"] == pytest.approx((989.4e12 + 67e12) / 2)
    assert r["roofline_fraction"] == pytest.approx(989.4e12 / 2 / (
        (989.4e12 + 67e12) / 2))
    bf16 = dryrun.roofline({"bfloat16": 989.4e12}, 0.0, 0.0, 1, 0.0)
    assert bf16["compute_s"] == pytest.approx(1.0)
    assert bf16["peak_flops"] == pytest.approx(989.4e12)


@pytest.mark.parametrize("mesh,n", [("1x8", 8), ("16x16", 256)])
def test_score_2m_gathers_its_candidates_once(results, mesh, n):
    r = results[0][f"bm25s/score_2m@{mesh}"]
    kk = min(bm25s.TOP_K, bm25s.N_DOCS // n)
    payload = n * bm25s.QUERY_BATCH * (2 * kk + 1) * 4
    assert r["collectives"] == {"all-gather": {
        "count": 1, "bytes": payload, "wire_bytes": payload}}
    assert r["collective_wire_bytes_per_device"] == payload
    assert r["collective_s"] > 0
    assert r["memory"]["temp_size_b"] > 0
    assert "p_max" in r["count_bound"]


@pytest.mark.parametrize("key", ["egnn/molecule@1x8", "sasrec/serve_p99@1x8",
                                 "mind/retrieval_cand@1x8",
                                 "bm25s/score_blocked_2m@1x8"])
def test_every_cell_is_traced_partitioned(results, key):
    """The recsys, EGNN and default blocked cells run as one rank's
    program like every other: a ``collectives`` dict (counts, payload and
    wire bytes), temporaries, and wire bytes on a mesh whose data axis
    holds two ranks or more (on the (1, 8) mesh only EGNN's edges, the
    candidates and the blocks, split over every axis, cross ranks); their
    records again on the production meshes (``main``'s file)."""
    r = results[0][key]
    assert isinstance(r["collectives"], dict)
    assert r["collective_wire_bytes_per_device"] == sum(
        d["wire_bytes"] for d in r["collectives"].values())
    assert r["collective_s"] == pytest.approx(
        r["collective_wire_bytes_per_device"] / dryrun.LINK_BW)
    assert r["memory"]["temp_size_b"] > 0
    if not key.startswith("sasrec"):
        assert r["collective_wire_bytes_per_device"] > 0
    if key.startswith("bm25s"):
        for mesh in ("16x16", "2x16x16"):
            big = results[1][f"bm25s/score_blocked_2m@{mesh}"]
            assert big["collective_wire_bytes_per_device"] > 0
            assert big["memory"]["temp_size_b"] > 0
            assert list(big["collectives"]) == ["all-gather"]


def test_argument_bytes_are_one_devices(results):
    """``score_2m``'s six index arrays hold one shard a device; its
    queries are replicated."""
    for mesh, n in (("1x8", 8), ("16x16", 256)):
        r = results[0][f"bm25s/score_2m@{mesh}"]
        nnz = -(-bm25s.N_DOCS * bm25s.AVG_UNIQUE_TOKENS // n // 1024) * 1024
        want = 4 * ((bm25s.N_VOCAB + 1) + 2 * nnz + bm25s.N_VOCAB + 2
                    + 2 * bm25s.QUERY_BATCH * bm25s.Q_MAX)
        assert r["memory"]["argument_size_b"] == want


def test_main_writes_both_meshes_and_the_report_reads_them(results):
    saved = results[1]
    assert sorted(saved) == sorted(
        f"bm25s/{s}@{m}" for s in ("score_2m", "score_blocked_2m")
        for m in ("16x16", "2x16x16"))
    assert all(r["ok"] and r["flops"] > 0 for r in saved.values())
    assert saved["bm25s/score_2m@2x16x16"]["n_chips"] == 512
    table = report.roofline_table(saved, "16x16")
    assert table.count("\n") == 3
    assert "all-gather:1" in report.dryrun_table(saved)
    summary = report.summarize(saved)
    for mesh in ("16x16", "2x16x16"):
        s = summary[mesh]
        assert s["cells"] == 2
        assert sum(s["bottlenecks"].values()) == 2


def test_a_fake_group_serves_any_mesh(results):
    """``check_mesh_backend`` lets the dry run's ``fake`` group (which
    moves no data) serve a cuda mesh and a cpu mesh; gloo for a cuda mesh
    is still refused (``test_torch_sharded.py``)."""
    assert results[0]["fake_serves"] == ["cuda", "cpu"]


def test_report_formats_seconds_and_gib():
    assert report.fmt_s(0.25) == "0.25" and report.fmt_s(2e-3) == "2.0m"
    assert report.fmt_s(3e-6) == "3u"
    assert report.fmt_bytes(3 * 2**29) == "1.50"


def test_no_tpu_figure_in_launch():
    pattern = re.compile(r"197e12|819e9|v5e|\bTPU\b|\bICI\b")
    for path in sorted((ROOT / "src" / "repro_torch" / "launch").glob(
            "*.py")):
        assert not pattern.search(path.read_text()), path.name
