"""The recsys, EGNN and default blocked cells partitioned on DTensor
placements, against the unpartitioned port and the reference.

Port side: 8 gloo CPU ranks (``file://`` rendezvous in the test's
temporary directory, so it is safe under ``xdist``) run, on the (2, 4)
mesh of ``make_mesh_from(max_model=4)`` and on ``remesh_dp_tp(4, 2)`` and
``remesh_dp_tp(8, 1)`` of it, each cell's function on arguments placed by
the cell's ``shardings`` (``dist.sharding.distribute``) under
``dist.sharding.partitioned``:

* the four recsys archs' ``SMOKE`` configs: ``serve_p99`` and
  ``serve_bulk`` (B = 16 and 32; the logits within rtol 1e-5),
  ``retrieval_cand`` (one user; 3 · 2^14, 2^14 and 2^15 candidates on the
  three meshes, so that a rank holds one 4,096-entry segment and a half,
  half of one, and one: values within 1e-5, ids tie-aware) and
  ``train_batch`` (B = 16, one AdamW step: the loss within rtol 1e-5, the
  first moments within rtol 1e-4 + 1e-6 · the leaf's max, the params
  within 1e-5 where the step holds a grad's sign);
* EGNN ``reduced`` configs with a node readout (a 40-node graph) and a
  graph readout (6 molecules), their edges shuffled with the padding
  among them: one step each, held as the recsys steps;
* the default ``score_blocked_2m`` with the module constants patched
  small (8,192 docs in blocks of 64: a rank holds part of a segment):
  the board tie-aware equal to the plain cell's;
* ``take_rows`` on a row-sharded table with ids outside it: NaN rows where
  the plain ``take_rows`` gives them, the other rows bitwise;
* every rank the same, and no rank imports ``jax`` or ``repro``.

One partitioned ``value_and_grad`` each of DLRM and EGNN (node readout) on
the (2, 4) mesh is held to the reference's ``jax.value_and_grad`` on the
same params (carried across by ``convert``), and the partitioned blocked
cell to the reference cell's own function (its jnp oracle and
``blockwise_topk``), at ``tests/torch_train_parity.py``'s bounds and
``tests/test_torch_bm25s.py``'s.

Fake group: a subprocess traces each cell on rank 0 of a ``fake`` group
of 8 on the (2, 4) mesh and counts its matmul FLOPs with
``launch.costs``: times 8 they equal what the reference's placements
replicate, within 2%: a recsys serving or train cell's unpartitioned
FLOPs × the "model" axis (the batch splits over "data" alone);
``retrieval_cand``'s candidate products once and its user tower (one
replicated row) 8 times; EGNN's edge products once and its node MLPs
(``proj_in``, ``phi_h``, ``head``: the FLOPs that do not grow with the
edges) 8 times; the blocked cell's K6 FLOPs once.
"""

import functools
import json
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.configs import bm25s, common
from repro_torch.models import egnn as pe
from repro_torch.models import recsys as pr
from repro_torch.models.common import tree_map, tree_paths
from repro_torch.train.step import value_and_grad

ROOT = Path(__file__).resolve().parents[1]
WORLD = 8
TIMEOUT_S = 420
ARCHS = ("dlrm-mlperf", "autoint", "sasrec", "mind")
READOUTS = ("node", "graph")
MESHES = ("2x4", "4x2", "8x1")
SERVE_B = {"serve_p99": 16, "serve_bulk": 32}
TRAIN_B = 16
# a rank's candidates: 6,144 (a segment and a half), 2,048 (half of one),
# 4,096 (one)
CANDIDATES = {"2x4": 3 * 2 ** 14, "4x2": 2 ** 14, "8x1": 2 ** 15}
TOP_K = 100
LR = 1e-3                      # the recsys and GNN cells' AdamW

LOSS_RTOL = 1e-5
LOGITS_RTOL = 1e-5
BOARD_ATOL = 1e-5
MM_RTOL = 0.02
# the cases whose partitioned ``value_and_grad`` is held to the plain
# one's and the reference's
GRADS_MESH = "2x4"
GRADS_CASES = ("dlrm-mlperf", "egnn:node")


def _egnn_cfg(readout):
    return pe.EGNNConfig(name="e", n_layers=2, d_hidden=16,
                         d_feat=11 if readout == "graph" else 8,
                         n_out=1 if readout == "graph" else 3,
                         readout=readout)


def _recsys_cells(arch, cfg, n_cand):
    out = {shape: common.recsys_serve_cell(arch, cfg, batch=b,
                                           shape_name=shape)
           for shape, b in SERVE_B.items()}
    out["retrieval_cand"] = common.recsys_retrieval_cell(
        arch, cfg, n_candidates=n_cand, k=TOP_K)
    out["train_batch"] = common.recsys_train_cell(arch, cfg, batch=TRAIN_B)
    return out


def _egnn_cell(readout, inp):
    b = inp["batch"]
    return common.gnn_train_cell(
        "egnn", _egnn_cfg(readout), readout, n_nodes=len(b["coords"]),
        n_edges=len(b["edges"]), n_graphs=inp.get("n_graphs"))


def _inputs():
    """Numpy params (the reference's ``init_params``, through
    ``convert``) and batches of every case, made from seeds."""
    import jax

    import repro.configs as ref_configs
    from repro.models import egnn as re
    from repro.models import recsys as rr
    from repro_torch.convert import (egnn_params_from_reference,
                                     recsys_params_from_reference)
    from torch_train_parity import _egnn_batch, _recsys_batch

    def np_tree(t):
        return tree_map(lambda x: x.numpy(), t)

    out = {}
    for arch in ARCHS:
        cfg = configs.get_smoke(arch)
        rp = rr.init_params(jax.random.PRNGKey(0), ref_configs.get_smoke(arch))
        rng = np.random.default_rng(len(arch))

        def serve(b):
            return {k: v for k, v in _recsys_batch(cfg, rng, b).items()
                    if k != "labels"}

        lo = 1 if cfg.model in ("sasrec", "mind") else 0
        out[arch] = {
            "params": np_tree(recsys_params_from_reference(
                jax.device_get(rp), device="cpu")),
            **{shape: serve(b) for shape, b in SERVE_B.items()},
            "train_batch": _recsys_batch(cfg, rng, TRAIN_B),
            "retrieval_cand": {k: v[:1] for k, v in serve(2).items()},
            "candidates": {n: rng.integers(lo, cfg.vocab_sizes[0], size=c
                                           ).astype(np.int32)
                           for n, c in CANDIDATES.items()}}
    for readout in READOUTS:
        kw = {k: getattr(_egnn_cfg(readout), k) for k in (
            "n_layers", "d_hidden", "d_feat", "n_out", "readout")}
        rp = re.init_params(jax.random.PRNGKey(0),
                            re.EGNNConfig(name="e", **kw))
        batch = _egnn_batch(np.random.default_rng(7), readout)
        rng = np.random.default_rng(8)
        edges = np.full((512, 2), -1, np.int32)   # the cell pads to 512
        edges[:len(batch["edges"])] = batch["edges"]
        batch["edges"] = edges[rng.permutation(512)]
        out["egnn:" + readout] = {
            "params": np_tree(egnn_params_from_reference(
                jax.device_get(rp), device="cpu")),
            "batch": batch, **({"n_graphs": 6} if readout == "graph" else {})}
    out["blocked"] = _blocked_data()
    table = out["dlrm-mlperf"]["params"]["table"]
    n = table.shape[0]
    ids = np.random.default_rng(9).integers(-n, n, size=(16, 4))
    ids[0, :] = [n, n + 5, -n - 1, -1]           # outside, and a wrap
    ids[9, 2] = 2 * n
    out["nan"] = {"table": table, "ids": ids.astype(np.int32)}
    return out


def _blocked_data():
    """``tests/test_torch_bm25s.py``'s reduced corpus and batch."""
    import test_torch_bm25s as B
    d = B._data()
    return {k: d[k] for k in ("blocked", "uniq", "weights")}


def _t(tree):
    return tree_map(lambda a: torch.as_tensor(np.array(a)), tree)


def _np(tree):
    return tree_map(lambda x: x.detach().numpy() if isinstance(
        x, torch.Tensor) else x, tree)


def _run_train(loss_fn, fn, inp, place, grads):
    params = place(_t(inp["params"]), 0)
    from repro_torch.train import AdamW

    opt_state = place(AdamW().init(_t(inp["params"])), 1)
    batch = place(_t(inp["batch"]), 2)
    out = {}
    if grads:
        extra = {"n_graphs": inp["n_graphs"]} if "n_graphs" in inp else {}
        (out["loss"], _), out["grads"] = value_and_grad(
            loss_fn, params, dict(batch, **extra))
    p1, s1, met = fn(params, opt_state, batch)
    return dict(out, params=p1, m=s1["m"], step_loss=met["loss"])


def _run_recsys(arch, kind, fn, inp, place=None, grads=False, mesh=None):
    """The cell's function on the case's inputs; ``place(tree, which)``
    lays each argument out (None: plain tensors)."""
    place = place or (lambda tree, which: tree)
    cfg = configs.get_smoke(arch)
    if kind == "train_batch":
        return _run_train(functools.partial(pr.loss_fn, cfg), fn,
                          {"params": inp["params"],
                           "batch": inp["train_batch"]}, place, grads)
    params = place(_t(inp["params"]), 0)
    batch = place(_t(inp[kind]), 1)
    if kind != "retrieval_cand":
        return {"logits": fn(params, batch)}
    ids, vals = fn(params, batch, place(_t(inp["candidates"][mesh]), 2))
    return {"ids": ids, "vals": vals}


def _run_blocked(fn, data, place=None):
    place = place or (lambda tree, which: tree)
    args = [*data["blocked"], data["uniq"], data["weights"]]
    ids, vals = fn(*(place(_t(a), i) for i, a in enumerate(args)))
    return {"ids": ids, "vals": vals}


PORT_SCRIPT = textwrap.dedent("""
    import os, pickle, sys, warnings
    warnings.simplefilter("ignore", FutureWarning)
    import torch
    import torch.distributed as tdist
    sys.path.insert(0, sys.argv[6])
    import test_torch_partitioned_cells as T
    from repro_torch import configs
    from repro_torch.configs import bm25s
    from repro_torch.configs.common import remesh_dp_tp
    from repro_torch.dist import sharding
    from repro_torch.launch.mesh import make_mesh_from
    from repro_torch.models import egnn, recsys
    from repro_torch.models.common import tree_map

    rank, world = int(sys.argv[1]), int(sys.argv[2])
    torch.set_num_threads(1)
    tdist.init_process_group("gloo", init_method="file://" + sys.argv[3],
                             rank=rank, world_size=world)
    inputs = pickle.load(open(sys.argv[4], "rb"))
    for name, v in inputs["small"].items():
        setattr(bm25s, name, v)
    base = make_mesh_from(device_type="cpu", max_model=4)
    meshes = {"2x4": base, "4x2": remesh_dp_tp(4, 2)(base),
              "8x1": remesh_dp_tp(8, 1)(base)}
    out = {}

    def gathered(x):
        if isinstance(x, torch.Tensor):
            if sharding.is_dtensor(x):
                x = x.full_tensor()
            return x.detach().numpy()
        return x

    def run(mesh, cell, go):
        fn, args = cell.build(mesh)
        specs = cell.shardings(mesh, args)
        place = lambda tree, which: sharding.distribute(
            tree, specs[which], mesh)
        with sharding.partitioned(mesh):
            return tree_map(gathered, go(fn, place))

    for name, mesh in meshes.items():
        for arch in T.ARCHS:
            cfg = configs.get_smoke(arch)
            cells = T._recsys_cells(arch, cfg, T.CANDIDATES[name])
            for kind, cell in cells.items():
                grads = (name == T.GRADS_MESH and arch in T.GRADS_CASES
                         and kind == "train_batch")
                out[(name, arch, kind)] = run(mesh, cell, lambda fn, place:
                    T._run_recsys(arch, kind, fn, inputs[arch], place,
                                  grads, name))
        for readout in T.READOUTS:
            key = "egnn:" + readout
            cell = T._egnn_cell(readout, inputs[key])
            out[(name, key)] = run(mesh, cell, lambda fn, place:
                T._run_train(T.functools.partial(
                    egnn.loss_fn, T._egnn_cfg(readout)), fn, inputs[key],
                    place, name == T.GRADS_MESH and key in T.GRADS_CASES))
        out[(name, "blocked")] = run(
            mesh, bm25s._score_blocked_cell(), lambda fn, place:
                T._run_blocked(fn, inputs["blocked"], place))
        nan = inputs["nan"]
        table = sharding.distribute(T._t(nan["table"]),
                                    sharding.param_pspecs(
                                        T._t(nan["table"]), mesh), mesh)
        ids = sharding.distribute(T._t(nan["ids"]), sharding.batch_pspec(
            nan["ids"].shape, mesh), mesh)
        with sharding.partitioned(mesh):
            out[(name, "nan")] = gathered(recsys.take_rows(table, ids))
    out["foreign"] = sorted(m for m in sys.modules
                            if m.split(".")[0] in ("jax", "jaxlib",
                                                   "repro"))
    pickle.dump(out, open(os.path.join(sys.argv[5], f"rank{rank}.pkl"),
                          "wb"))
    tdist.destroy_process_group()
""")

FAKE_SCRIPT = textwrap.dedent("""
    import json, sys, warnings
    warnings.simplefilter("ignore", FutureWarning)
    import torch
    from repro_torch import configs
    from repro_torch.configs import bm25s, common
    from repro_torch.dist import sharding
    from repro_torch.launch import costs, dryrun
    from repro_torch.launch.mesh import make_mesh_from
    from repro_torch.models import egnn

    MM = {"aten.mm", "aten.bmm", "aten.addmm", "aten.baddbmm"}
    K6 = "repro_torch.bm25_block_score"

    def flops(t, ops):
        return sum(d["flops"] for k, d in t["by_op"].items() if k in ops)

    def counts(cell, mesh, ops=MM):
        fn, args = cell.build(mesh)
        flat = costs.trace(fn, args)
        laid = dryrun.lay_out(args, cell.shardings(mesh, args), mesh)
        with sharding.partitioned(mesh):
            part = costs.trace(fn, laid)
        return flops(flat, ops), 8 * flops(part, ops), part["collectives"]

    out = {}
    with dryrun.fake_group(8):
        mesh = make_mesh_from(device_type="cpu", max_model=4)
        for arch in ("dlrm-mlperf", "autoint", "sasrec", "mind"):
            cfg = configs.get_smoke(arch)
            cells = {
                "serve": common.recsys_serve_cell(arch, cfg, batch=64,
                                                  shape_name="s"),
                "train": common.recsys_train_cell(arch, cfg, batch=64),
                "retrieval": common.recsys_retrieval_cell(
                    arch, cfg, n_candidates=2 ** 15),
                "retrieval_x2": common.recsys_retrieval_cell(
                    arch, cfg, n_candidates=2 ** 16)}
            for kind, cell in cells.items():
                g, r, c = counts(cell, mesh)
                out[arch + "/" + kind] = {"global": g, "ranks": r,
                                          "collectives": c}
        for readout in ("node", "graph"):
            cfg = egnn.EGNNConfig(name="e", n_layers=2, d_hidden=16,
                                  d_feat=8, n_out=3, readout=readout)
            for e in (2048, 4096):
                cell = common.gnn_train_cell(
                    "egnn", cfg, readout, n_nodes=200, n_edges=e,
                    n_graphs=5 if readout == "graph" else None)
                g, r, c = counts(cell, mesh)
                out[f"egnn/{readout}/{e}"] = {"global": g, "ranks": r,
                                              "collectives": c}
        for name, v in json.loads(sys.argv[1]).items():
            setattr(bm25s, name, v)
        g, r, c = counts(bm25s._score_blocked_cell(), mesh, {K6})
        out["bm25s/score_blocked"] = {"global": g, "ranks": r,
                                      "collectives": c}
    print("RESULT" + json.dumps(out))
""")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The fake-group subprocess, then the 8 gloo ranks once their inputs
    are made; the plain runs here meanwhile."""
    import test_torch_bm25s as B

    tmp = tmp_path_factory.mktemp("partitioned_cells")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    fake = subprocess.Popen([sys.executable, "-c", FAKE_SCRIPT,
                             json.dumps(B.SMALL)], env=env, cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    inputs = _inputs()
    inputs["small"] = B.SMALL
    pickle.dump(inputs, open(tmp / "inputs.pkl", "wb"))
    procs = [subprocess.Popen(
        [sys.executable, "-c", PORT_SCRIPT, str(r), str(WORLD),
         str(tmp / "rdv"), str(tmp / "inputs.pkl"), str(tmp),
         str(ROOT / "tests")], env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(WORLD)]
    plain = {}
    for arch in ARCHS:
        cfg = configs.get_smoke(arch)
        for mesh in MESHES:
            for kind, cell in _recsys_cells(arch, cfg,
                                            CANDIDATES[mesh]).items():
                if kind != "retrieval_cand" and mesh != MESHES[0]:
                    continue
                fn, _ = cell.build(None)
                plain[(mesh, arch, kind)] = _np(_run_recsys(
                    arch, kind, fn, inputs[arch], grads=arch in GRADS_CASES,
                    mesh=mesh))
    for readout in READOUTS:
        key = "egnn:" + readout
        fn, _ = _egnn_cell(readout, inputs[key]).build(None)
        plain[key] = _np(_run_train(functools.partial(
            pe.loss_fn, _egnn_cfg(readout)), fn, inputs[key],
            lambda tree, which: tree, key in GRADS_CASES))
    saved = {k: getattr(bm25s, k) for k in B.SMALL}
    try:
        for k, v in B.SMALL.items():
            setattr(bm25s, k, v)
        fn, _ = bm25s._score_blocked_cell().build(None)
        plain["blocked"] = _np(_run_blocked(fn, inputs["blocked"]))
    finally:
        for k, v in saved.items():
            setattr(bm25s, k, v)
    nan = _t(inputs["nan"])
    plain["nan"] = _np(pr.take_rows(nan["table"], nan["ids"]))
    errors, outs = [], []
    for p in procs + [fake]:
        try:
            out, err = p.communicate(timeout=TIMEOUT_S)
        except subprocess.TimeoutExpired:
            p.kill()
            out, err = p.communicate()
        outs.append(out)
        if p.returncode != 0:
            errors.append(err[-3000:])
    assert not errors, errors[0]
    line = [ln for ln in outs[-1].splitlines() if ln.startswith("RESULT")]
    return {"inputs": inputs, "plain": plain,
            "ranks": [pickle.load(open(tmp / f"rank{r}.pkl", "rb"))
                      for r in range(WORLD)],
            "fake": json.loads(line[-1][len("RESULT"):])}


def _same_on_every_rank(runs, key):
    first = runs["ranks"][0][key]
    for rank in runs["ranks"][1:]:
        assert all(np.array_equal(a, b, equal_nan=True) for (_, a), (_, b)
                   in zip(tree_paths(rank[key]), tree_paths(first),
                          strict=True)), key


def _board_tie_equal(got, want, msg):
    """Boards equal up to ties: values within ``BOARD_ATOL`` position by
    position, and in every row the ids scoring more than ``BOARD_ATOL``
    above the k-th value the same set."""
    gi, gv, wi, wv = got["ids"], got["vals"], want["ids"], want["vals"]
    assert gi.shape == wi.shape and gi.dtype == wi.dtype, msg
    np.testing.assert_allclose(gv, wv, rtol=0, atol=BOARD_ATOL, err_msg=msg)
    for a_ids, a_v, b_ids, b_v in zip(gi, gv, wi, wv):
        cut = min(a_v[-1], b_v[-1]) + BOARD_ATOL
        assert set(a_ids[a_v > cut].tolist()) == set(
            b_ids[b_v > cut].tolist()), msg


def _check_step(got, want, msg):
    from test_torch_partitioned import _grads_close, _params_close

    np.testing.assert_allclose(got["step_loss"], want["step_loss"],
                               rtol=LOSS_RTOL, err_msg=msg)
    if "grads" in got:
        np.testing.assert_allclose(got["loss"], want["loss"],
                                   rtol=LOSS_RTOL, err_msg=msg)
        _grads_close(got["grads"], want["grads"], msg)
    _grads_close(got["m"], want["m"], msg + " m")
    _params_close(got["params"], want["params"], want["m"], LR, msg)


@pytest.mark.parametrize("shape", list(SERVE_B))
@pytest.mark.parametrize("mesh,arch", [(m, a) for m in MESHES
                                       for a in ARCHS])
def test_serve_cells_equal_the_plain_forward(runs, mesh, arch, shape):
    want = runs["plain"][(MESHES[0], arch, shape)]["logits"]
    for r, rank in enumerate(runs["ranks"]):
        got = rank[(mesh, arch, shape)]["logits"]
        assert got.shape == want.shape and len(got) == SERVE_B[shape]
        np.testing.assert_allclose(got, want, rtol=LOGITS_RTOL, atol=0,
                                   err_msg=f"{mesh} {arch} rank {r}")
    _same_on_every_rank(runs, (mesh, arch, shape))


@pytest.mark.parametrize("mesh,arch", [(m, a) for m in MESHES
                                       for a in ARCHS])
def test_retrieval_cells_equal_the_plain_board(runs, mesh, arch):
    want = runs["plain"][(mesh, arch, "retrieval_cand")]
    for r, rank in enumerate(runs["ranks"]):
        got = rank[(mesh, arch, "retrieval_cand")]
        assert got["ids"].shape == (1, TOP_K)
        _board_tie_equal(got, want, f"{mesh} {arch} rank {r}")
        assert len(set(got["ids"][0].tolist())) == TOP_K
    _same_on_every_rank(runs, (mesh, arch, "retrieval_cand"))


@pytest.mark.parametrize("mesh,arch", [(m, a) for m in MESHES
                                       for a in ARCHS])
def test_recsys_train_cells_equal_the_plain_step(runs, mesh, arch):
    want = runs["plain"][(MESHES[0], arch, "train_batch")]
    for r, rank in enumerate(runs["ranks"]):
        _check_step(rank[(mesh, arch, "train_batch")], want,
                    f"{mesh} {arch} rank {r}")
    _same_on_every_rank(runs, (mesh, arch, "train_batch"))


@pytest.mark.parametrize("mesh,readout", [(m, r) for m in MESHES
                                          for r in READOUTS])
def test_egnn_train_cells_equal_the_plain_step(runs, mesh, readout):
    key = "egnn:" + readout
    for r, rank in enumerate(runs["ranks"]):
        _check_step(rank[(mesh, key)], runs["plain"][key],
                    f"{mesh} {key} rank {r}")
    _same_on_every_rank(runs, (mesh, key))


@pytest.mark.parametrize("mesh", MESHES)
def test_blocked_cell_equals_the_plain_board(runs, mesh):
    want = runs["plain"]["blocked"]
    for r, rank in enumerate(runs["ranks"]):
        _board_tie_equal(rank[(mesh, "blocked")], want, f"{mesh} rank {r}")
    _same_on_every_rank(runs, (mesh, "blocked"))


def test_blocked_cell_equals_the_reference(runs):
    """The partitioned default blocked cell on the (2, 4) mesh against the
    reference cell's own function (its jnp oracle and the jnp
    ``blockwise_topk``), its module constants patched for the call."""
    import jax.numpy as jnp

    import test_torch_bm25s as B
    from repro.configs import bm25s as ref_bm25s
    from repro.launch.mesh import make_test_mesh

    data = runs["inputs"]["blocked"]
    saved = {k: getattr(ref_bm25s, k) for k in B.SMALL}
    try:
        for k, v in B.SMALL.items():
            setattr(ref_bm25s, k, v)
        fn, _ = ref_bm25s._score_blocked_cell(
            doc_block=B.SMALL["DOC_BLOCK"], batch=B.SMALL["QUERY_BATCH"],
            u_max=B.SMALL["U_MAX"]).build(make_test_mesh())
        ref = fn(*(jnp.asarray(a) for a in data["blocked"]),
                 jnp.asarray(data["uniq"]), jnp.asarray(data["weights"]))
    finally:
        for k, v in saved.items():
            setattr(ref_bm25s, k, v)
    got = runs["ranks"][0][("2x4", "blocked")]
    assert (got["vals"][:, 0] > 0).all()
    B._tie_equal((got["ids"], got["vals"]),
                 tuple(np.asarray(t) for t in ref))


@pytest.mark.parametrize("mesh", MESHES)
def test_an_id_outside_the_table_gives_one_nan_row(runs, mesh):
    """``take_rows`` on the row-sharded table: the NaN rows of the plain
    ``take_rows`` (an id outside ``[-rows, rows)``), the others bitwise
    its rows; a NaN row is NaN in every column, not a sum of zeros from
    the ranks that do not hold it."""
    want = runs["plain"]["nan"]
    ids = runs["inputs"]["nan"]["ids"]
    n = runs["inputs"]["nan"]["table"].shape[0]
    bad = (ids < -n) | (ids >= n)
    assert bad.sum() == 4
    for rank in runs["ranks"]:
        got = rank[(mesh, "nan")]
        assert np.isnan(got[bad]).all() and not np.isnan(got[~bad]).any()
        assert np.array_equal(got, want, equal_nan=True)


@pytest.mark.parametrize("case", GRADS_CASES)
def test_partitioned_grads_equal_the_reference(runs, case):
    """The partitioned ``value_and_grad`` on the (2, 4) mesh against
    ``jax.value_and_grad`` of the reference's ``loss_fn`` on the same
    params and batch, at ``torch_train_parity``'s bounds."""
    import jax
    import jax.numpy as jnp

    import repro.configs as ref_configs
    from repro.models import egnn as re
    from repro.models import recsys as rr
    from test_torch_partitioned import _grads_close

    if case.startswith("egnn:"):
        readout = case.split(":")[1]
        inp = runs["inputs"][case]
        kw = {k: getattr(_egnn_cfg(readout), k) for k in (
            "n_layers", "d_hidden", "d_feat", "n_out", "readout")}
        rcfg = re.EGNNConfig(name="e", **kw)
        rp = re.init_params(jax.random.PRNGKey(0), rcfg)
        batch, loss = inp["batch"], functools.partial(re.loss_fn, rcfg)
        got = runs["ranks"][0][(GRADS_MESH, case)]
    else:
        rcfg = ref_configs.get_smoke(case)
        rp = rr.init_params(jax.random.PRNGKey(0), rcfg)
        batch = runs["inputs"][case]["train_batch"]
        loss = functools.partial(rr.loss_fn, rcfg)
        got = runs["ranks"][0][(GRADS_MESH, case, "train_batch")]
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (rloss, _), rgrads = jax.value_and_grad(
        lambda q: loss(q, jb), has_aux=True)(rp)
    np.testing.assert_allclose(got["loss"], np.asarray(rloss),
                               rtol=LOSS_RTOL)
    _grads_close(got["grads"], tree_map(np.asarray, jax.device_get(rgrads)),
                 "reference")


def test_the_ranks_import_neither_jax_nor_repro(runs):
    assert all(rank["foreign"] == [] for rank in runs["ranks"])


@pytest.mark.parametrize("kind", ["serve", "train"])
@pytest.mark.parametrize("arch", ARCHS)
def test_recsys_cells_replicate_over_the_model_axis_only(runs, arch, kind):
    """A serving or train cell's matmul FLOPs, rank 0's times 8 on the
    fake (2, 4) mesh, are the unpartitioned trace's × 4 (the batch splits
    over "data" alone, the "model" ranks repeat it), within 2%; and the
    step issues collectives."""
    c = runs["fake"][f"{arch}/{kind}"]
    assert c["ranks"] == pytest.approx(4 * c["global"], rel=MM_RTOL)
    assert c["collectives"]


@pytest.mark.parametrize("arch", ARCHS)
def test_retrieval_splits_its_candidates_over_every_rank(runs, arch):
    """``retrieval_cand``: the candidate products once over the 8 ranks
    and the user tower (the replicated batch) 8 times. The tower is what
    does not grow with the candidates: 2 F(2^15) − F(2^16) of the
    unpartitioned traces (0 for a CTR model, whose forward runs on the
    candidates' rows), within 2%."""
    c = runs["fake"][f"{arch}/retrieval"]
    x2 = runs["fake"][f"{arch}/retrieval_x2"]
    tower = 2 * c["global"] - x2["global"]
    if arch in ("dlrm-mlperf", "autoint"):
        assert tower == pytest.approx(0.0, abs=MM_RTOL * c["global"])
    assert c["ranks"] == pytest.approx(c["global"] + 7 * tower,
                                       rel=MM_RTOL)
    assert "all-gather" in c["collectives"]


@pytest.mark.parametrize("readout", READOUTS)
def test_egnn_splits_its_edges_and_replicates_its_node_mlps(runs, readout):
    """EGNN's train step: the edge products once over the 8 ranks, the
    node MLPs (``proj_in``, ``phi_h``, ``head``: 2 F(E) − F(2E) of the
    unpartitioned traces, what does not grow with the edges) 8 times,
    within 2%; the layers' sums go through all-reduces."""
    c = runs["fake"][f"egnn/{readout}/2048"]
    x2 = runs["fake"][f"egnn/{readout}/4096"]
    node = 2 * c["global"] - x2["global"]
    assert 0 < node < c["global"]
    assert c["ranks"] == pytest.approx(c["global"] + 7 * node,
                                       rel=MM_RTOL)
    assert "all-reduce" in c["collectives"]


def test_blocked_cell_scores_each_block_once(runs):
    """The default blocked cell: K6's FLOPs over the 8 ranks equal the
    unpartitioned trace's (each rank scores its own blocks), and the
    candidates cross in one all-gather, the scores never."""
    c = runs["fake"]["bm25s/score_blocked"]
    assert c["global"] > 0
    assert c["ranks"] == pytest.approx(c["global"], rel=MM_RTOL)
    assert list(c["collectives"]) == ["all-gather"]
    assert c["collectives"]["all-gather"]["count"] == 1
