"""The port's configs, cells and registry against the reference's.

For the recsys and the LM families, at full ``CONFIG`` (``meta`` tensors
on the port's side, ``eval_shape`` on the reference's: no memory): every
cell's key, kind, argument shapes and dtypes and ``model_flops``; the
params', batch and (LM decode) cache placements (``dist.sharding``'s
DTensor placements) against the reference's ``PartitionSpec``s over (1,
1), (1, 8), (2, 4) and (3, 2) meshes (an ``AbstractMesh`` on the
reference's side), compared by path with each dim's mesh axes in their
major-first order; the LM configs (``CONFIG``, ``SMOKE``, the constants),
``lm_total_params`` / ``lm_active_params`` / ``_lm_attn_flops`` and
``LM_SHAPES``; the registry's archs, its unknown-name error, and the
reference's archs the port still lacks, pinned to the ones ROADMAP
queues.
"""

import dataclasses
import functools
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

import repro.configs as ref_configs
import repro_torch.configs as configs
from repro_torch.configs import common
from repro_torch.models import transformer as pt

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["autoint", "mind", "dlrm-mlperf", "sasrec"]
LM_ARCHS = ["h2o-danube3-4b", "gemma3-1b", "qwen3-8b", "mixtral-8x22b",
            "mixtral-8x7b"]
# the reference's archs the port does not have yet: ROADMAP §1 queues
# them (bm25s, with the launch tooling)
QUEUED = {"bm25s"}
MESHES = [(1, 1), (1, 8), (2, 4), (3, 2)]
DTYPES = {jnp.dtype(jnp.float32): torch.float32,
          jnp.dtype(jnp.int32): torch.int32,
          jnp.dtype(jnp.bfloat16): torch.bfloat16,
          jnp.dtype(jnp.int8): torch.int8}


def _ref_cells(arch):
    return {c.key: c for c in ref_configs.get_cells(arch)}


def _leaves(tree):
    """(path, leaf) pairs of a tree of dicts, lists and tuples."""
    if isinstance(tree, dict):
        return [((k,) + p, x) for k, v in tree.items()
                for p, x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [((i,) + p, x) for i, v in enumerate(tree)
                for p, x in _leaves(v)]
    return [((), tree)]


def _ref_leaves(tree):
    """(path, leaf) pairs of a reference pytree, keyed as :func:`_leaves`
    keys them (``jax.tree`` orders a dict's keys; compare by path)."""
    out = []
    for kp, x in jax.tree_util.tree_leaves_with_path(tree):
        out.append((tuple(getattr(k, "key", getattr(k, "idx", None))
                          for k in kp), x))
    return out


def test_registry_lists_the_recsys_family():
    """The LM family, EGNN, then the recsys family, in the reference's
    order."""
    assert configs.list_archs() == LM_ARCHS + ["egnn", "autoint", "mind",
                                               "dlrm-mlperf", "sasrec"]
    assert configs.list_archs() == [a for a in ref_configs.list_archs()
                                    if a not in QUEUED]
    for arch in ARCHS + LM_ARCHS:
        mod = configs.get_module(arch)
        ref = ref_configs.get_module(arch)
        fam = "lm" if arch in LM_ARCHS else "recsys"
        assert mod.FAMILY == ref.FAMILY == fam
        assert configs.get_module(arch.replace("-", "_")) is mod
        assert configs._norm(arch.replace("-", "_")) == ref_configs._norm(
            arch.replace("-", "_")) == arch
    assert configs.get_module("h2o_danube_3_4b") is configs.get_module(
        "h2o-danube3-4b")


def test_unknown_arch_raises_the_reference_error():
    with pytest.raises(ValueError) as port:
        configs.get_config("bm25s")
    with pytest.raises(ValueError) as ref:
        ref_configs.get_config("nope")
    assert str(port.value) == (f"unknown arch 'bm25s'; available: "
                               f"{sorted(configs.list_archs())}")
    assert str(ref.value).startswith("unknown arch 'nope'; available: [")


def test_missing_archs_are_the_queued_ones():
    missing = set(ref_configs.list_archs()) - set(configs.list_archs())
    assert missing == QUEUED
    assert set(configs.list_archs()) <= set(ref_configs.list_archs())
    roadmap = (ROOT / "ROADMAP.md").read_text()
    queue = roadmap[roadmap.index("### 1. Modules to port"):
                    roadmap.index("### 2. TPU kernels")]
    for arch in sorted(QUEUED):
        assert f"`{arch}`" in queue, arch


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_the_reference(arch):
    for get in ("get_config", "get_smoke"):
        got = getattr(configs, get)(arch)
        ref = getattr(ref_configs, get)(arch)
        a, b = dataclasses.asdict(got), dataclasses.asdict(ref)
        assert a.pop("dtype") == torch.float32
        assert jnp.dtype(b.pop("dtype")) == jnp.float32
        assert a == b
        assert got.padded_rows == ref.padded_rows
        np.testing.assert_array_equal(got.field_offsets(),
                                      ref.field_offsets())
    if arch == "dlrm-mlperf":
        from repro.configs import dlrm_mlperf as ref_mod
        from repro_torch.configs import dlrm_mlperf as mod
        assert mod.MLPERF_VOCABS == ref_mod.MLPERF_VOCABS
    if arch == "autoint":
        from repro.configs import autoint as ref_mod
        from repro_torch.configs import autoint as mod
        assert mod.AUTOINT_VOCABS == ref_mod.AUTOINT_VOCABS


@pytest.mark.parametrize("arch", ARCHS)
def test_cells_equal_the_reference_at_full_width(arch):
    cells = configs.get_cells(arch)
    ref = _ref_cells(arch)
    assert [c.key for c in cells] == [c.key for c in
                                      ref_configs.get_cells(arch)] == [
        f"{arch}/train_batch", f"{arch}/serve_p99", f"{arch}/serve_bulk",
        f"{arch}/retrieval_cand"]
    for c in cells:
        r = ref[c.key]
        assert (c.arch, c.shape, c.kind) == (r.arch, r.shape, r.kind)
        assert c.model_flops == r.model_flops
        fn, args = c.build(None)
        _, ref_args = r.build(None)
        got, want = dict(_leaves(args)), dict(_ref_leaves(ref_args))
        assert set(got) == set(want)
        for path, a in got.items():
            b = want[path]
            assert a.device.type == "meta", path
            assert tuple(a.shape) == tuple(b.shape), path
            assert a.dtype == DTYPES[jnp.dtype(b.dtype)], path


def test_all_cells_and_model_flops():
    keys = [c.key for c in configs.all_cells()]
    # 4 recsys archs × 4 cells; 5 LM archs × 4, but qwen3-8b skips
    # long_500k; EGNN's 4 shapes
    assert len(keys) == 16 + 19 + 4 == len(set(keys))
    ref_keys = {c.key for c in ref_configs.all_cells()}
    assert set(keys) <= ref_keys
    assert ref_keys - set(keys) == {c.key for c in
                                    ref_configs.get_cells("bm25s")}
    from repro.configs import common as ref_common
    for arch in ARCHS:
        cfg = configs.get_config(arch)
        ref_cfg = ref_configs.get_config(arch)
        for b in (1, 512, 65_536):
            assert common.recsys_model_flops(cfg, b) == \
                ref_common.recsys_model_flops(ref_cfg, b)
    assert common.RECSYS_SHAPES == ref_common.RECSYS_SHAPES


def _fake_mesh(data, model):
    """What ``dist.sharding`` reads of a ``DeviceMesh``: its dim names and
    shape."""
    return SimpleNamespace(mesh_dim_names=("data", "model"),
                           shape=(data, model))


def _port_dims(placements, ndim):
    from torch.distributed.tensor import Replicate, Shard
    dims = [() for _ in range(ndim)]
    for name, p in zip(("data", "model"), placements):
        if isinstance(p, Shard):
            dims[p.dim] = dims[p.dim] + (name,)
        else:
            assert isinstance(p, Replicate), p
    return dims


def _ref_dims(sharding, ndim):
    spec = sharding.spec
    dims = []
    for i in range(ndim):
        e = spec[i] if i < len(spec) else None
        dims.append(() if e is None else (e,) if isinstance(e, str)
                    else tuple(e))
    return dims


@pytest.mark.parametrize("mesh_shape", MESHES,
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_placements_equal_the_reference(arch, mesh_shape):
    mesh = _fake_mesh(*mesh_shape)
    ref_mesh = AbstractMesh(mesh_shape, ("data", "model"))
    ref = _ref_cells(arch)
    for c in configs.get_cells(arch):
        _, args = c.build(mesh)
        r = ref[c.key]
        _, ref_args = r.build(ref_mesh)
        want = dict(_ref_leaves(r.shardings(ref_mesh, ref_args)))
        shapes = {path: tuple(a.shape) for path, a in _leaves(args)}
        # a placement list is one leaf: one entry a mesh dimension
        got = dict(_leaves_placements(c.shardings(mesh, args)))
        assert set(got) == set(want) == set(shapes)
        for path, shape in shapes.items():
            assert len(got[path]) == 2
            assert _port_dims(got[path], len(shape)) == _ref_dims(
                want[path], len(shape)), (c.key, path, shape)


def _leaves_placements(tree):
    """(path, placement list) pairs: a list whose items are placements is
    a leaf."""
    from torch.distributed.tensor import Placement
    if isinstance(tree, dict):
        return [((k,) + p, x) for k, v in tree.items()
                for p, x in _leaves_placements(v)]
    if isinstance(tree, (list, tuple)):
        if tree and all(isinstance(x, Placement) for x in tree):
            return [((), list(tree))]
        return [((i,) + p, x) for i, v in enumerate(tree)
                for p, x in _leaves_placements(v)]
    raise TypeError(f"unexpected leaf {tree!r}")


# -- the LM family ------------------------------------------------------------

LM_SHAPE_NAMES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


@functools.lru_cache(maxsize=None)
def _ref_lm_built(arch):
    """The reference's LM cells of ``arch`` with their built arguments (the
    build reads no mesh), by key."""
    return {c.key: (c, c.build(None)[1])
            for c in ref_configs.get_cells(arch)}


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_configs_equal_the_reference(arch):
    from repro.configs import common as ref_common
    for get in ("get_config", "get_smoke"):
        got = getattr(configs, get)(arch)
        ref = getattr(ref_configs, get)(arch)
        a, b = dataclasses.asdict(got), dataclasses.asdict(ref)
        assert str(a.pop("dtype")) == "torch." + jnp.dtype(b.pop("dtype")).name
        assert a == b
    assert configs.get_config(arch).dtype == torch.bfloat16
    assert configs.get_smoke(arch).dtype == torch.float32
    mod, ref_mod = configs.get_module(arch), ref_configs.get_module(arch)
    assert mod.N_MICROBATCHES == ref_mod.N_MICROBATCHES
    cfg, ref_cfg = mod.CONFIG, ref_mod.CONFIG
    assert common.lm_total_params(cfg) == ref_common.lm_total_params(ref_cfg)
    assert common.lm_active_params(cfg) == ref_common.lm_active_params(
        ref_cfg)
    for b, s_q, s_kv in ((1, 1, 32_768), (4, 512, 4_096), (2, 1, 524_288)):
        assert common._lm_attn_flops(cfg, b, s_q, s_kv) == \
            ref_common._lm_attn_flops(ref_cfg, b, s_q, s_kv)
    assert common.LM_SHAPES == ref_common.LM_SHAPES
    if arch == "gemma3-1b":
        assert common.lm_total_params(cfg) == 999_751_680


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_cells_equal_the_reference_at_full_width(arch):
    cells = configs.get_cells(arch)
    ref = {c.key: c for c in ref_configs.get_cells(arch)}
    shapes = LM_SHAPE_NAMES[:3] if arch == "qwen3-8b" else LM_SHAPE_NAMES
    assert [c.key for c in cells] == [f"{arch}/{s}" for s in shapes]
    assert set(ref) == {c.key for c in cells}
    built = _ref_lm_built(arch)
    for c in cells:
        r, ref_args = built[c.key]
        assert (c.arch, c.shape, c.kind, c.note) == (r.arch, r.shape, r.kind,
                                                     r.note)
        assert c.model_flops == r.model_flops
        fn, args = c.build(None)
        if c.kind == "train":
            step = _step_closure(fn)
            assert step["loss_fn"].func is pt.loss_fn
            assert step["loss_fn"].args == (configs.get_config(arch),)
            assert step["n_microbatches"] == configs.get_module(
                arch).N_MICROBATCHES
            assert step["compress"] is False
        else:
            assert fn.func is {"prefill": pt.prefill,
                               "decode": pt.decode_step}[c.kind]
            assert fn.args == (configs.get_config(arch),)
        got, want = dict(_leaves(args)), dict(_ref_leaves(ref_args))
        assert set(got) == set(want)
        for path, a in got.items():
            b = want[path]
            assert a.device.type == "meta", path
            assert tuple(a.shape) == tuple(b.shape), path
            assert a.dtype == DTYPES[jnp.dtype(b.dtype)], path


def _step_closure(fn) -> dict:
    """The variables ``make_train_step``'s step closes over, by name."""
    assert fn.__qualname__ == "make_train_step.<locals>.train_step"
    return dict(zip(fn.__code__.co_freevars,
                    (c.cell_contents for c in fn.__closure__)))


def _port_dims_ordered(placements, ndim, sizes):
    """Each tensor dim's mesh axes, major first: a ``_StridedShard`` is
    minor to the plain shards of its dim, which its split factor spans."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.placement_types import _StridedShard
    dims = [[] for _ in range(ndim)]
    for name, p in zip(("data", "model"), placements):
        if isinstance(p, _StridedShard):
            dims[p.dim].append((name, p.split_factor))
        elif isinstance(p, Shard):
            dims[p.dim].append((name, None))
        else:
            assert isinstance(p, Replicate), p
    out = []
    for axes in dims:
        plain = [n for n, f in axes if f is None]
        for n, f in axes:
            if f is not None:
                assert f == int(np.prod([sizes[m] for m in plain])), axes
        out.append(tuple(plain + [n for n, f in axes if f is not None]))
    return out


@pytest.mark.parametrize("mesh_shape", MESHES,
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_placements_equal_the_reference(arch, mesh_shape):
    """Params (the serving rule: resident under 8 GiB a chip, else
    data-sharded too), tokens and, for the decode cells, every layer's
    cache and ``pos``, path by path, each dim's axes in their order."""
    mesh = _fake_mesh(*mesh_shape)
    sizes = dict(zip(("data", "model"), mesh_shape))
    ref_mesh = AbstractMesh(mesh_shape, ("data", "model"))
    built = _ref_lm_built(arch)
    strided = 0
    for c in configs.get_cells(arch):
        _, args = c.build(mesh)
        r, ref_args = built[c.key]
        want = dict(_ref_leaves(r.shardings(ref_mesh, ref_args)))
        shapes = {path: tuple(a.shape) for path, a in _leaves(args)}
        got = dict(_leaves_placements(c.shardings(mesh, args)))
        assert set(got) == set(want) == set(shapes)
        for path, shape in shapes.items():
            assert len(got[path]) == 2
            dims = _port_dims_ordered(got[path], len(shape), sizes)
            assert dims == _ref_dims(want[path], len(shape)), (
                c.key, path, shape)
            strided += any(len(d) == 2 and d[0] == "model" for d in dims)
    # the big MoEs keep their weights data-sharded while serving: their
    # K/V projections split d_model model-major over both axes
    if arch.startswith("mixtral") and mesh_shape == (2, 4):
        assert strided > 0


# -- train cells: the recsys and GNN families -----------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_recsys_train_cell_steps_like_the_reference(arch):
    """``train_batch``'s step: ``recsys.loss_fn`` of the config, the
    reference's microbatches, AdamW at 1e-3; its optimizer state on meta
    tensors shaped like the params (f32) with an int32 0-d step."""
    from repro_torch.models import recsys as pr
    (c,) = [c for c in configs.get_cells(arch) if c.kind == "train"]
    fn, (params_s, opt_s, batch_s) = c.build(None)
    step = _step_closure(fn)
    assert step["loss_fn"].func is pr.loss_fn
    assert step["n_microbatches"] == 1 and step["optimizer"].lr == 1e-3
    assert set(opt_s) == {"m", "v", "step"}
    assert opt_s["step"].dtype == torch.int32 and opt_s["step"].dim() == 0
    for (pa, a), (pb, b) in zip(_leaves(params_s), _leaves(opt_s["m"])):
        assert pa == pb and a.shape == b.shape and b.dtype == torch.float32
        assert b.device.type == "meta"
    assert ("labels" in batch_s) == (c.arch in ("autoint", "dlrm-mlperf"))


EGNN_SHAPES = ["full_graph_sm", "minibatch_lg", "ogb_products", "molecule"]


def test_egnn_config_and_cells_equal_the_reference():
    from repro.configs import egnn as ref_mod
    from repro_torch.configs import egnn as mod
    for got, ref in ((mod.CONFIG, ref_mod.CONFIG), (mod.SMOKE, ref_mod.SMOKE)):
        a, b = dataclasses.asdict(got), dataclasses.asdict(ref)
        assert a.pop("dtype") == torch.float32
        assert jnp.dtype(b.pop("dtype")) == jnp.float32
        assert a == b
    assert mod.FAMILY == ref_mod.FAMILY == "gnn"
    assert mod.SHAPE_DEFS == ref_mod.SHAPE_DEFS
    cells = configs.get_cells("egnn")
    ref = {c.key: c for c in ref_configs.get_cells("egnn")}
    assert [c.key for c in cells] == list(ref) == [
        f"egnn/{s}" for s in EGNN_SHAPES]
    for c in cells:
        r = ref[c.key]
        assert (c.arch, c.shape, c.kind, c.note) == (r.arch, r.shape, r.kind,
                                                     r.note)
        assert c.model_flops == r.model_flops
        fn, args = c.build(None)
        _, ref_args = r.build(None)
        got, want = dict(_leaves(args)), dict(_ref_leaves(ref_args))
        assert set(got) == set(want)
        for path, a in got.items():
            b = want[path]
            assert a.device.type == "meta", path
            assert tuple(a.shape) == tuple(b.shape), path
            assert a.dtype == DTYPES[jnp.dtype(b.dtype)], path
        step = _step_closure(fn if c.shape != "molecule"
                             else _molecule_base(fn))
        assert step["loss_fn"].args == (mod.shape_config(c.shape),)


def _molecule_base(fn):
    """The molecule cell's step closes over the base step and the static
    ``n_graphs``."""
    inner = dict(zip(fn.__code__.co_freevars,
                     (x.cell_contents for x in fn.__closure__)))
    assert inner["n_graphs"] == 128
    return inner["base_step"]


@pytest.mark.parametrize("mesh_shape", MESHES,
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_egnn_placements_equal_the_reference(mesh_shape):
    """Params and optimizer state replicated, edges over every mesh axis,
    the other batch leaves replicated."""
    mesh = _fake_mesh(*mesh_shape)
    ref_mesh = AbstractMesh(mesh_shape, ("data", "model"))
    ref = {c.key: c for c in ref_configs.get_cells("egnn")}
    for c in configs.get_cells("egnn"):
        _, args = c.build(mesh)
        r = ref[c.key]
        _, ref_args = r.build(ref_mesh)
        want = dict(_ref_leaves(r.shardings(ref_mesh, ref_args)))
        shapes = {path: tuple(a.shape) for path, a in _leaves(args)}
        got = dict(_leaves_placements(c.shardings(mesh, args)))
        assert set(got) == set(want) == set(shapes)
        for path, shape in shapes.items():
            sizes = dict(zip(("data", "model"), mesh_shape))
            assert _port_dims_ordered(got[path], len(shape), sizes) == \
                _ref_dims(want[path], len(shape)), (c.key, path)
