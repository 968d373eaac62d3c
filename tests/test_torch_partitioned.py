"""The LM cells partitioned on DTensor placements, against the
unpartitioned port step and the reference.

Port side: 8 gloo CPU ranks (``file://`` rendezvous in the test's
temporary directory, so it is safe under ``xdist``) run, on the (2, 4)
mesh of ``make_mesh_from(max_model=4)`` and on ``remesh_dp_tp(4, 2)`` and
``remesh_dp_tp(8, 1)`` of it, the smoke configs of gemma3-1b, qwen3-8b and
mixtral-8x7b through their cells: the params, optimizer state, batch and
caches are placed by each cell's ``shardings`` (``dist.sharding.
distribute``) and the cell's function runs under ``dist.sharding.
partitioned``. Each rank gathers what it got with ``full_tensor()`` and
the test holds it, rank by rank, to the same function run on plain
tensors here:

* the train cell's step (AdamW, M = 2; a microbatch keeps each rank's own
  rows, which the batch's uniform labels make the same loss): the loss
  within rtol 1e-5, the first moments (``(1 - b1)`` times the mean
  gradient) within the grads' bound, rtol 1e-4 and atol 1e-6 · the leaf's
  max, the params within 1e-5 where the step holds a grad's sign (as
  ``torch_train_parity.check_step`` does); for qwen3-8b on the (2, 4)
  mesh also ``value_and_grad`` of the loss: the loss within rtol 1e-5,
  every grad leaf within the grads' bound;
* ``prefill`` (logits and the K/V cache) and ``decode_step`` on a seeded
  cache, bf16-layout and int8 (``kv_quant``): the logits within 1e-4, the
  updated cache bitwise;
* every rank the same.

One partitioned ``value_and_grad`` (qwen3-8b on the (2, 4) mesh) is also
held to the reference's ``jax.value_and_grad`` on the same params
(carried across by ``convert.lm_params_from_reference``), at the bounds
of ``tests/torch_train_parity.py``.

Fake group: a subprocess runs each partitioned train, prefill and decode
cell of reduced gemma3-1b and qwen3-8b (every sharded width divides its
axis) on rank 0 of a ``fake`` group of 8 and counts its matmul FLOPs with
``launch.costs``: times 8 they equal the unpartitioned trace's within 2%,
which fails if a step secretly runs replicated. Reduced mixtral-8x7b's
excess is the router's products, which every "model" rank runs whole: 4
× the router's FLOPs (3 extra copies on the 4-way axis), within 2%.

With one row a rank and four microbatches the step takes one microbatch
(a rank never splits a row), and its matmuls still split over the ranks.

``remesh_dp_tp`` puts the mesh's ``r``-th rank where the reference puts
device ``r``.
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
from repro_torch.configs import common
from repro_torch.models import transformer as pt
from repro_torch.models.common import tree_map, tree_paths
from repro_torch.train.step import value_and_grad

ROOT = Path(__file__).resolve().parents[1]
WORLD = 8
TIMEOUT_S = 420
ARCHS = ("gemma3-1b", "qwen3-8b", "mixtral-8x7b")
MESHES = ("2x4", "4x2", "8x1")
B, S = 16, 32                  # the cells' batch and sequence
POS = 20                       # the decode caches' position

LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL_REL = 1e-4, 1e-6
PARAM_ATOL = 1e-5
LOGITS_ATOL = 1e-4
MM_RTOL = 0.02
# the case whose partitioned ``value_and_grad`` is held to the plain one's
# and the reference's (the others' gradients are held through the step's
# first moments, (1 - b1) times the microbatches' mean gradient)
GRADS_CASE = ("2x4", "qwen3-8b")


def _inputs(arch):
    """Numpy params (the reference's ``init_params``, through ``convert``),
    batch, prefill tokens, decode tokens and caches of ``arch``'s smoke."""
    import jax

    import repro.configs as ref_configs
    from repro.models import transformer as rt
    from repro_torch.convert import lm_params_from_reference

    rp = rt.init_params(jax.random.PRNGKey(0),
                        ref_configs.get_smoke(arch))
    params = tree_map(lambda x: x.numpy(), lm_params_from_reference(
        jax.device_get(rp), device="cpu"))
    cfg = configs.get_smoke(arch)
    rng = np.random.default_rng(len(arch))
    toks = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    labels = np.roll(toks, -1, 1)
    labels[:, -1] = -1                  # the same count in every row
    caches = {}
    for quant in (False, True):
        c = pt.init_decode_cache(pt.replace(cfg, kv_quant=quant), B, S,
                                 device="cpu")
        c = tree_map(lambda x: x.numpy().copy(), c)
        for name in ("k", "v"):
            for a in c[name]:
                a[...] = (rng.integers(-127, 128, size=a.shape) if quant
                          else rng.normal(size=a.shape))
        for name in ("k_scale", "v_scale"):
            for a in c.get(name, []):
                a[...] = rng.uniform(0.001, 0.02, size=a.shape)
        c["pos"] = np.array(POS, np.int32)
        caches[quant] = c
    return {"params": params, "batch": {"tokens": toks, "labels": labels},
            "prefill": rng.integers(0, cfg.vocab_size, size=(B, S)).astype(
                np.int32),
            "decode": rng.integers(0, cfg.vocab_size, size=(B,)).astype(
                np.int32),
            "caches": caches}


def _t(tree):
    return tree_map(lambda a: torch.as_tensor(np.array(a)), tree)


def _np(tree):
    return tree_map(lambda x: x.detach().numpy() if isinstance(
        x, torch.Tensor) else x, tree)


def _cells(arch, cfg):
    return {
        "train": common.lm_train_cell(arch, cfg, global_batch=B, seq_len=S,
                                      n_microbatches=2),
        "prefill": common.lm_prefill_cell(arch, cfg, batch=B, seq_len=S,
                                          shape_name="prefill"),
        "decode": common.lm_decode_cell(arch, cfg, batch=B, seq_len=S,
                                        shape_name="decode"),
        "decode_int8": common.lm_decode_cell(
            arch, pt.replace(cfg, kv_quant=True), batch=B, seq_len=S,
            shape_name="decode"),
    }


def _run(arch, kind, fn, inp, place=None, grads=True):
    """The cell's function (and, with ``grads``, ``value_and_grad`` of the
    loss for the train cell) on the case's inputs; ``place(tree, which)``
    lays each argument out (None: plain tensors). Results as numpy
    trees."""
    cfg = configs.get_smoke(arch)
    place = place or (lambda tree, which: tree)
    params = place(_t(inp["params"]), 0)
    if kind == "train":
        from repro_torch.train import AdamW

        opt_state = place(AdamW().init(_t(inp["params"])), 1)
        batch = place(_t(inp["batch"]), 2)
        out = {}
        if grads:
            (out["loss"], _), out["grads"] = value_and_grad(
                functools.partial(pt.loss_fn, cfg), params, batch)
        p1, s1, met = fn(params, opt_state, batch)
        return dict(out, params=p1, m=s1["m"], step_loss=met["loss"])
    if kind == "prefill":
        logits, cache = fn(params, place(_t(inp["prefill"]), 1))
        return {"logits": logits, "k": cache["k"], "v": cache["v"]}
    cache = place(_t(inp["caches"][kind == "decode_int8"]), 1)
    logits, out = fn(params, cache, place(_t(inp["decode"]), 2))
    return {"logits": logits, "cache": {k: v for k, v in out.items()
                                        if k != "pos"}}


PORT_SCRIPT = textwrap.dedent("""
    import os, pickle, sys
    import torch
    import torch.distributed as tdist
    sys.path.insert(0, sys.argv[6])
    import test_torch_partitioned as T
    from repro_torch import configs
    from repro_torch.configs.common import remesh_dp_tp
    from repro_torch.dist import sharding
    from repro_torch.launch.mesh import make_mesh_from
    from repro_torch.models.common import tree_map

    rank, world = int(sys.argv[1]), int(sys.argv[2])
    torch.set_num_threads(1)
    tdist.init_process_group("gloo", init_method="file://" + sys.argv[3],
                             rank=rank, world_size=world)
    inputs = pickle.load(open(sys.argv[4], "rb"))
    base = make_mesh_from(device_type="cpu", max_model=4)
    meshes = {"2x4": base, "4x2": remesh_dp_tp(4, 2)(base),
              "8x1": remesh_dp_tp(8, 1)(base)}
    out = {"coords": {n: list(m.get_coordinate())
                      for n, m in meshes.items()}}

    def gathered(x):
        if isinstance(x, torch.Tensor):
            if sharding.is_dtensor(x):
                x = x.full_tensor()
            return x.detach().numpy()
        return x

    for name, mesh in meshes.items():
        for arch in T.ARCHS:
            cfg = configs.get_smoke(arch)
            for kind, cell in T._cells(arch, cfg).items():
                fn, args = cell.build(mesh)
                specs = cell.shardings(mesh, args)
                place = lambda tree, which: sharding.distribute(
                    tree, specs[which], mesh)
                with sharding.partitioned(mesh):
                    got = T._run(arch, kind, fn, inputs[arch], place,
                                 grads=(name, arch) == T.GRADS_CASE)
                out[(name, arch, kind)] = tree_map(gathered, got)
    out["foreign"] = sorted(m for m in sys.modules
                            if m.split(".")[0] in ("jax", "jaxlib",
                                                   "repro"))
    pickle.dump(out, open(os.path.join(sys.argv[5], f"rank{rank}.pkl"),
                          "wb"))
    tdist.destroy_process_group()
""")

FAKE_SCRIPT = textwrap.dedent("""
    import json, sys
    import torch
    from repro_torch.configs import common, get_config
    from repro_torch.dist import sharding
    from repro_torch.launch import costs, dryrun
    from repro_torch.launch.mesh import make_mesh_from
    from repro_torch.models import transformer
    from repro_torch.train.step import microbatch_count

    MM = {"aten.mm", "aten.bmm", "aten.addmm", "aten.baddbmm"}

    def mm(t):
        return sum(d["flops"] for k, d in t["by_op"].items() if k in MM)

    out = {}
    with dryrun.fake_group(8):
        mesh = make_mesh_from(device_type="cpu", max_model=4)
        for arch in ("gemma3-1b", "qwen3-8b", "mixtral-8x7b"):
            cfg = transformer.reduced(get_config(arch))
            cells = {
                "train": common.lm_train_cell(
                    arch, cfg, global_batch=8, seq_len=64, n_microbatches=2),
                "prefill": common.lm_prefill_cell(
                    arch, cfg, batch=8, seq_len=64, shape_name="p"),
                "decode": common.lm_decode_cell(
                    arch, cfg, batch=8, seq_len=64, shape_name="d")}
            for kind, cell in cells.items():
                fn, args = cell.build(mesh)
                flat = costs.trace(fn, args)
                laid = dryrun.lay_out(args, cell.shardings(mesh, args), mesh)
                with sharding.partitioned(mesh):
                    part = costs.trace(fn, laid)
                out[arch + "/" + kind] = {
                    "global": mm(flat), "ranks": 8 * mm(part),
                    "tokens": 8 * (64 if kind != "decode" else 1),
                    "d": cfg.d_model, "experts": cfg.n_experts or 0,
                    "layers": cfg.n_layers,
                    "collectives": part["collectives"]}
        # one row a rank, four microbatches, on the (8, 1) mesh
        mesh = make_mesh_from(device_type="cpu", max_model=1)
        cell = common.lm_train_cell("qwen3-8b", transformer.reduced(
            get_config("qwen3-8b")), global_batch=8, seq_len=64,
            n_microbatches=4)
        fn, args = cell.build(mesh)
        laid = dryrun.lay_out(args, cell.shardings(mesh, args), mesh)
        with sharding.partitioned(mesh):
            part = costs.trace(fn, laid)
        out["qwen3-8b/train_row_a_rank"] = {
            "global": mm(costs.trace(fn, args)), "ranks": 8 * mm(part),
            "microbatches": microbatch_count(laid[-1], fn.n_microbatches),
            "record": dryrun.run_cell(cell, mesh, verbose=False)[
                "microbatches"]}
    print("RESULT" + json.dumps(out))
""")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The 8 gloo ranks and the fake-group subprocess, started together;
    the plain steps run here meanwhile."""
    tmp = tmp_path_factory.mktemp("partitioned")
    inputs = {arch: _inputs(arch) for arch in ARCHS}
    pickle.dump(inputs, open(tmp / "inputs.pkl", "wb"))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen(
        [sys.executable, "-c", PORT_SCRIPT, str(r), str(WORLD),
         str(tmp / "rdv"), str(tmp / "inputs.pkl"), str(tmp),
         str(ROOT / "tests")], env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(WORLD)]
    fake = subprocess.Popen([sys.executable, "-c", FAKE_SCRIPT], env=env,
                            cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    plain = {}
    for arch in ARCHS:
        for kind, cell in _cells(arch, configs.get_smoke(arch)).items():
            fn, _ = cell.build(None)
            plain[(arch, kind)] = _np(_run(arch, kind, fn, inputs[arch],
                                           grads=arch == GRADS_CASE[1]))
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


def _grads_close(got, want, msg):
    for (path, g), (_, w) in zip(tree_paths(got), tree_paths(want),
                                 strict=True):
        top = float(np.abs(w).max(initial=0.0))
        np.testing.assert_allclose(g, w, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL_REL * top,
                                   err_msg=f"{msg} {path}")


def _u(g):
    g = g.astype(np.float64)
    return g / (np.abs(g) + 1e-8)


def _params_close(got, want, moments, lr, msg):
    """Each param within ``PARAM_ATOL`` plus lr times the spread of AdamW's
    first-step direction over the grads the grad bound admits (the
    plain step's grad: its first moment over 1 - b1), as
    ``torch_train_parity.check_step`` holds the port's step to the
    reference's."""
    for (path, a), (_, b), (_, m) in zip(tree_paths(got), tree_paths(want),
                                         tree_paths(moments), strict=True):
        g = m / (1 - 0.9)
        tol = GRAD_RTOL * np.abs(g) + GRAD_ATOL_REL * np.abs(g).max(
            initial=0.0)
        slack = lr * (_u(g + tol) - _u(g - tol))
        err = np.abs(a.astype(np.float64) - b)
        assert (err <= PARAM_ATOL + slack).all(), (msg, path)


CASES = [(m, a) for m in MESHES for a in ARCHS]


@pytest.mark.parametrize("mesh,arch", CASES)
def test_train_cell_equals_the_plain_step(runs, mesh, arch):
    want = runs["plain"][(arch, "train")]
    lr = 3e-4 * 1 / 100                 # the cell's schedule at step 1
    for r, rank in enumerate(runs["ranks"]):
        got = rank[(mesh, arch, "train")]
        msg = f"{mesh} {arch} rank {r}"
        np.testing.assert_allclose(got["step_loss"], want["step_loss"],
                                   rtol=LOSS_RTOL, err_msg=msg)
        if (mesh, arch) == GRADS_CASE:
            np.testing.assert_allclose(got["loss"], want["loss"],
                                       rtol=LOSS_RTOL, err_msg=msg)
            _grads_close(got["grads"], want["grads"], msg)
        _grads_close(got["m"], want["m"], msg + " m")
        _params_close(got["params"], want["params"], want["m"], lr, msg)
        first = runs["ranks"][0][(mesh, arch, "train")]
        assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(
            tree_paths(got), tree_paths(first))), msg


@pytest.mark.parametrize("mesh,arch", CASES)
def test_prefill_cell_equals_the_plain_prefill(runs, mesh, arch):
    want = runs["plain"][(arch, "prefill")]
    for r, rank in enumerate(runs["ranks"]):
        got = rank[(mesh, arch, "prefill")]
        msg = f"{mesh} {arch} rank {r}"
        for key in ("logits", "k", "v"):
            np.testing.assert_allclose(got[key], want[key], rtol=0,
                                       atol=LOGITS_ATOL,
                                       err_msg=f"{msg} {key}")
        first = runs["ranks"][0][(mesh, arch, "prefill")]
        assert all(np.array_equal(got[k], first[k]) for k in got), msg


@pytest.mark.parametrize("quant", [False, True], ids=["bf16_layout", "int8"])
@pytest.mark.parametrize("mesh,arch", CASES)
def test_decode_cell_equals_the_plain_decode(runs, mesh, arch, quant):
    """The logits within 1e-4; in the cache only the slot ``pos % S_i``
    of each layer changes (the rest bitwise as given), and the written
    slot is within 1e-4 (int8: one code apart at most, the scales within
    1e-4 relative)."""
    kind = "decode_int8" if quant else "decode"
    want = runs["plain"][(arch, kind)]
    given = runs["inputs"][arch]["caches"][quant]
    for r, rank in enumerate(runs["ranks"]):
        got = rank[(mesh, arch, kind)]
        msg = f"{mesh} {arch} {kind} rank {r}"
        np.testing.assert_allclose(got["logits"], want["logits"], rtol=0,
                                   atol=LOGITS_ATOL, err_msg=msg)
        for name, layers in want["cache"].items():
            for i, w in enumerate(layers):
                g = got["cache"][name][i]
                slot = POS % w.shape[1]
                rest = np.ones(w.shape[1], bool)
                rest[slot] = False
                assert np.array_equal(g[:, rest], given[name][i][:, rest])
                if name in ("k", "v") and quant:
                    assert np.abs(g[:, slot].astype(np.int32)
                                  - w[:, slot]).max() <= 1, (msg, name, i)
                elif name in ("k", "v"):
                    np.testing.assert_allclose(g[:, slot], w[:, slot],
                                               atol=LOGITS_ATOL, rtol=0)
                else:
                    np.testing.assert_allclose(g[:, slot], w[:, slot],
                                               rtol=1e-4)
        first = runs["ranks"][0][(mesh, arch, kind)]
        assert np.array_equal(got["logits"], first["logits"]), msg


def test_partitioned_grads_equal_the_reference(runs):
    """qwen3-8b's partitioned ``value_and_grad`` on the (2, 4) mesh against
    ``jax.value_and_grad`` of the reference's ``loss_fn`` on the same
    params, at ``torch_train_parity``'s bounds."""
    import jax
    import jax.numpy as jnp

    import repro.configs as ref_configs
    from repro.models import transformer as rt

    rcfg = ref_configs.get_smoke("qwen3-8b")
    rp = rt.init_params(jax.random.PRNGKey(0), rcfg)
    batch = {k: jnp.asarray(v)
             for k, v in runs["inputs"]["qwen3-8b"]["batch"].items()}
    (rloss, _), rgrads = jax.value_and_grad(
        lambda q: rt.loss_fn(rcfg, q, batch), has_aux=True)(rp)
    got = runs["ranks"][0][("2x4", "qwen3-8b", "train")]
    np.testing.assert_allclose(got["loss"], np.asarray(rloss),
                               rtol=LOSS_RTOL)
    _grads_close(got["grads"], tree_map(np.asarray, jax.device_get(
        rgrads)), "reference")


def test_the_ranks_import_neither_jax_nor_repro(runs):
    assert all(rank["foreign"] == [] for rank in runs["ranks"])


def test_remesh_places_rank_r_where_the_reference_places_device_r(
        runs, monkeypatch):
    """``remesh_dp_tp(dp, tp)`` of the (2, 4) mesh puts rank ``r`` where
    the reference's ``remesh_dp_tp`` puts device ``r`` of a (2, 4) mesh
    over devices 0 .. 7 (its ``Mesh`` constructor stubbed to return the
    device grid): ``(r // tp, r % tp)``."""
    from types import SimpleNamespace

    import jax.sharding

    from repro.configs.common import remesh_dp_tp as ref_remesh

    monkeypatch.setattr(jax.sharding, "Mesh",
                        lambda devs, names, **kw: devs)
    base = SimpleNamespace(devices=np.arange(WORLD).reshape(2, 4))
    for name, (dp, tp) in (("4x2", (4, 2)), ("8x1", (8, 1))):
        grid = ref_remesh(dp, tp)(base)
        for r, rank in enumerate(runs["ranks"]):
            want = [int(i) for i in np.argwhere(grid == r)[0]]
            assert rank["coords"][name] == want == [r // tp, r % tp]
    for r, rank in enumerate(runs["ranks"]):
        assert rank["coords"]["2x4"] == [r // 4, r % 4]


@pytest.mark.parametrize("key", [f"{a}/{k}" for a in ("gemma3-1b",
                                                       "qwen3-8b")
                                 for k in ("train", "prefill", "decode")])
def test_dense_steps_split_their_matmuls_over_the_ranks(runs, key):
    """A dense cell's matmul FLOPs, rank 0's times 8 on the fake group,
    equal the unpartitioned trace's within 2%; and the partitioned step
    issues collectives."""
    c = runs["fake"][key]
    assert c["ranks"] == pytest.approx(c["global"], rel=MM_RTOL)
    assert c["collectives"]


def test_a_rank_never_splits_a_row(runs):
    """qwen3-8b's train cell with one row a rank and four microbatches on
    the (8, 1) mesh: the step takes one microbatch of each rank's row
    (``gcd(rows, M)``), so its matmul FLOPs still split over the ranks;
    the step and the dry run's record both say it runs one microbatch of
    the four configured."""
    c = runs["fake"]["qwen3-8b/train_row_a_rank"]
    assert c["ranks"] == pytest.approx(c["global"], rel=MM_RTOL)
    assert c["microbatches"] == 1
    assert c["record"] == {"configured": 4, "run": 1}


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_mixtral_replicates_only_its_router(runs, kind):
    """Reduced mixtral-8x7b: the router's products (``[T, d] @ [d, E]``,
    with the checkpointed recompute and both backward products in the
    train cell: 4 of them) run whole on each of the 4 "model" ranks;
    every other product is split. So the ranks' matmul FLOPs exceed the
    unpartitioned trace's by 3 × the router's, within 2%."""
    c = runs["fake"]["mixtral-8x7b/" + kind]
    router = 2.0 * c["tokens"] * c["d"] * c["experts"] * c["layers"] * (
        4 if kind == "train" else 1)
    assert c["ranks"] - c["global"] == pytest.approx(3 * router,
                                                     abs=MM_RTOL
                                                     * c["global"])
    assert c["ranks"] > c["global"]
