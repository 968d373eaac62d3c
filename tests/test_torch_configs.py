"""The port's recsys configs, cells and registry against the reference's.

At full ``CONFIG`` (``meta`` tensors on the port's side, ``eval_shape``
on the reference's: no memory): every cell's key, kind, argument shapes
and dtypes and ``model_flops``; the params' and batch placements
(``dist.sharding``'s DTensor placements) against the reference's
``PartitionSpec``s over (1, 1), (1, 8), (2, 4) and (3, 2) meshes (an
``AbstractMesh`` on the reference's side); the registry's archs, its
unknown-name error, and the reference's archs the port still lacks,
pinned to the ones ROADMAP queues.
"""

import dataclasses
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

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["autoint", "mind", "dlrm-mlperf", "sasrec"]
# the reference's archs the port does not have yet: ROADMAP §1 item 5
# queues them (LM serving, then egnn with training, then bm25s)
QUEUED = {"h2o-danube3-4b", "gemma3-1b", "qwen3-8b", "mixtral-8x22b",
          "mixtral-8x7b", "egnn", "bm25s"}
MESHES = [(1, 1), (1, 8), (2, 4), (3, 2)]
DTYPES = {jnp.dtype(jnp.float32): torch.float32,
          jnp.dtype(jnp.int32): torch.int32}


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
    assert configs.list_archs() == ["autoint", "mind", "dlrm-mlperf",
                                    "sasrec"]
    for arch in ARCHS:
        mod = configs.get_module(arch)
        ref = ref_configs.get_module(arch)
        assert mod.FAMILY == ref.FAMILY == "recsys"
        assert configs.get_module(arch.replace("-", "_")) is mod
        assert configs._norm(arch.replace("-", "_")) == ref_configs._norm(
            arch.replace("-", "_")) == arch


def test_unknown_arch_raises_the_reference_error():
    with pytest.raises(ValueError) as port:
        configs.get_config("gemma3-1b")
    with pytest.raises(ValueError) as ref:
        ref_configs.get_config("nope")
    assert str(port.value) == (f"unknown arch 'gemma3-1b'; available: "
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
    assert [c.key for c in cells] == [
        f"{arch}/serve_p99", f"{arch}/serve_bulk", f"{arch}/retrieval_cand"]
    # train_batch is the only reference cell the family lacks
    assert set(ref) - {c.key for c in cells} == {f"{arch}/train_batch"}
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
    assert len(keys) == 12 == len(set(keys))
    ref_keys = {c.key for c in ref_configs.all_cells()}
    assert set(keys) <= ref_keys
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
