"""The partitioned ``ops.topk`` on uneven shards and at ``k = 0``, against
the plain ``ops.topk`` and the reference's ``repro.kernels.ops.topk``.

Port side: three gloo CPU worlds of 2, 3 and 4 ranks (``file://``
rendezvous in the test's temporary directory, so it is safe under
``xdist``) run ``ops.topk`` on ``DTensor`` s whose last dim is split over
a 1-D mesh of the whole world, and in the 4-rank world also over a 2 x 2
mesh with both dims splitting it (DTensor nests the chunks: 5 entries
there are pieces of 2, 1, 1 and 1). The entry counts divide none of the
splits; there are pieces shorter than ``k`` and an empty piece (5 entries
over 4 ranks: 2, 2, 1, 0), counts below and above ``block``, and ``k`` of
0, 1, 100 and ``n``. The values are small integers with ``-inf`` among
them, so equal values meet across every rank boundary, or seeded normals,
1-D and 2-D, f32 and bf16. Each board must be the plain ``ops.topk`` of
the whole tensor bit for bit, ids and values, on every rank; ``k = n + 1``
raises the plain ``ValueError``, as a split of another dim or a
``Partial`` placement does; ``k = 0`` reaches no collective; and
``dist.sharding.shard_extent`` gives each rank's ``to_local()`` piece.

The reference's ``ops.topk`` on the same numpy input takes its
``jax.lax.top_k`` route for these counts (none is a multiple of its
``block`` above it), which ranks equal values by index as the port's tie
rule does: the boards must be its boards.
"""

import math
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.dist import sharding
from repro_torch.kernels import ops

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 300
WORLDS = {"1x2": (2,), "1x3": (3,), "1x4": (4,), "2x2": (2, 2)}
B = 3
# (n, block): below and above the block, and the default block with a
# ragged last segment
SIZES = ((5, 64), (37, 64), (250, 64), (1001, 64), (10_007, 4096))
CONTENTS = ("ties", "normal")
DTYPES = ("float32", "bfloat16")


def _ks(n):
    return sorted({0, 1, min(100, n), n})


def _x(n, content, dtype, ndim):
    """The seeded input of a case as f32 numpy (bf16 cases hold values
    that bf16 keeps exactly)."""
    rng = np.random.default_rng([n, CONTENTS.index(content), ndim])
    if content == "ties":
        x = rng.integers(-3, 4, size=(B, n)).astype(np.float32)
        x[rng.random((B, n)) < 0.1] = -np.inf
    else:
        x = rng.standard_normal((B, n)).astype(np.float32)
        if dtype == "bfloat16":
            x = torch.from_numpy(x).bfloat16().float().numpy()
    return x if ndim == 2 else x[0]


def _cases():
    return [(n, block, content, dtype, ndim)
            for n, block in SIZES for content in CONTENTS
            for dtype in DTYPES for ndim in (1, 2)]


RANK_SCRIPT = textwrap.dedent("""
    import os, pickle, sys, warnings
    warnings.simplefilter("ignore", FutureWarning)
    import torch
    import torch.distributed as tdist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import (DTensor, Partial, Shard,
                                          distribute_tensor)
    sys.path.insert(0, sys.argv[5])
    import test_torch_partitioned_topk as T
    from repro_torch.dist import sharding
    from repro_torch.kernels import ops

    rank, world = int(sys.argv[1]), int(sys.argv[2])
    torch.set_num_threads(1)
    tdist.init_process_group("gloo", init_method="file://" + sys.argv[3],
                             rank=rank, world_size=world)
    gathers = [0]
    merge = ops._all_gather_merge

    def counted(*a, **kw):
        gathers[0] += 1
        return merge(*a, **kw)

    ops._all_gather_merge = counted
    meshes = {name: DeviceMesh("cpu", torch.arange(world).reshape(shape),
                               mesh_dim_names=("data", "model")[-len(shape):])
              for name, shape in T.WORLDS.items()
              if int(torch.tensor(shape).prod()) == world}

    def as_np(t):
        return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()

    def error(fn):
        try:
            fn()
        except ValueError as e:
            return str(e)
        return None

    out = {}
    for name, mesh in meshes.items():
        for case in T._cases():
            n, block, content, dtype, ndim = case
            x = torch.from_numpy(T._x(n, content, dtype, ndim)).to(
                getattr(torch, dtype))
            last = x.ndim - 1
            split = [Shard(last)] * mesh.ndim
            d = distribute_tensor(x, mesh, split)
            off, length = sharding.shard_extent(mesh, split, x.shape, last)
            piece = d.to_local()
            out[(name, case, "extent")] = (
                (off, length), piece.shape[-1],
                length == 0 or torch.equal(piece, x[..., off:off + length]),
                tuple(mesh.get_coordinate()),
                [sharding.shard_extent(mesh.shape, split, x.shape, last, c)
                 for c in torch.cartesian_prod(*(
                     torch.arange(s) for s in mesh.shape)).reshape(
                         -1, mesh.ndim).tolist()])
            for k in T._ks(n):
                before = gathers[0]
                with sharding.partitioned(mesh):
                    vals, ids = ops.topk(d, k, block=block)
                pv, pi = ops.topk(x, k, block=block)
                out[(name, case, k)] = (
                    as_np(vals), ids.numpy(), str(vals.dtype),
                    str(ids.dtype), gathers[0] - before, as_np(pv),
                    pi.numpy())
            with sharding.partitioned(mesh):
                got = error(lambda: ops.topk(d, n + 1, block=block))
            out[(name, case, "past_n")] = (
                got, error(lambda: ops.topk(x, n + 1, block=block)))
        x = torch.from_numpy(T._x(37, "normal", "float32", 2))
        rows = distribute_tensor(x, mesh, [Shard(0)] * mesh.ndim)
        part = DTensor.from_local(x, mesh, [Partial()] * mesh.ndim,
                                  run_check=False)
        with sharding.partitioned(mesh):
            out[(name, "other placements")] = (
                error(lambda: ops.topk(rows, 5)),
                error(lambda: ops.topk(part, 5)))
    out["foreign"] = sorted(m for m in sys.modules
                            if m.split(".")[0] in ("jax", "jaxlib",
                                                   "repro"))
    pickle.dump(out, open(os.path.join(sys.argv[4], f"rank{rank}.pkl"),
                          "wb"))
    tdist.destroy_process_group()
""")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every world's ranks at once; each rank's results by world."""
    tmp = tmp_path_factory.mktemp("partitioned_topk")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    procs = {}
    for world in (2, 3, 4):
        d = tmp / f"world{world}"
        d.mkdir()
        procs[world] = [subprocess.Popen(
            [sys.executable, "-c", RANK_SCRIPT, str(r), str(world),
             str(d / "rdv"), str(d), str(ROOT / "tests")], env=env,
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True) for r in range(world)]
    errors = []
    for ps in procs.values():
        for p in ps:
            try:
                _, err = p.communicate(timeout=TIMEOUT_S)
            except subprocess.TimeoutExpired:
                p.kill()
                _, err = p.communicate()
            if p.returncode != 0:
                errors.append(err[-3000:])
    assert not errors, errors[0]
    return {world: [pickle.load(open(tmp / f"world{world}" / f"rank{r}.pkl",
                                     "rb")) for r in range(world)]
            for world in procs}


def _ranks(runs, mesh):
    return runs[math.prod(WORLDS[mesh])]


def _bits(a):
    return np.ascontiguousarray(a).view(np.int32)


@pytest.mark.parametrize("n,block", SIZES)
@pytest.mark.parametrize("mesh", list(WORLDS))
def test_partitioned_topk_is_the_plain_topk(runs, mesh, n, block):
    """Every case of this ``n``, on every rank: ids and values bit for
    bit the plain ``ops.topk`` of the whole tensor, in its dtype, with
    i32 ids; one all-gather a call, none at ``k = 0``."""
    for r, out in enumerate(_ranks(runs, mesh)):
        for case in _cases():
            if case[:2] != (n, block):
                continue
            for k in _ks(n):
                vals, ids, vdt, idt, gathers, pv, pi = out[(mesh, case, k)]
                what = f"rank {r} {case} k={k}"
                assert vdt == f"torch.{case[3]}" and idt == "torch.int32", \
                    what
                assert vals.shape == pv.shape == (
                    (k,) if case[4] == 1 else (B, k)), what
                assert np.array_equal(ids, pi), what
                assert np.array_equal(_bits(vals), _bits(pv)), what
                assert gathers == (0 if k == 0 else 1), what


@pytest.mark.parametrize("mesh", list(WORLDS))
def test_every_rank_returns_the_same_board(runs, mesh):
    first, *rest = _ranks(runs, mesh)
    for key, got in first.items():
        if not (isinstance(key, tuple) and isinstance(key[-1], int)):
            continue
        for out in rest:
            assert np.array_equal(out[key][1], got[1]), key
            assert np.array_equal(_bits(out[key][0]), _bits(got[0])), key


@pytest.mark.parametrize("mesh", list(WORLDS))
def test_k_past_n_raises_the_plain_error(runs, mesh):
    for out in _ranks(runs, mesh):
        for case in _cases():
            got, plain = out[(mesh, case, "past_n")]
            assert plain is not None and got == plain, case


@pytest.mark.parametrize("mesh", list(WORLDS))
def test_a_split_of_another_dim_or_a_partial_still_raises(runs, mesh):
    for out in _ranks(runs, mesh):
        rows, part = out[(mesh, "other placements")]
        assert rows is not None and "last dim" in rows
        assert part is not None and "last dim" in part


@pytest.mark.parametrize("mesh", list(WORLDS))
def test_shard_extent_gives_each_rank_its_to_local_piece(runs, mesh):
    """On each rank its own extent is its ``to_local()`` piece (length and
    content); the extents of every coordinate, asked on any rank from the
    mesh's shape, are the pieces the ranks at those coordinates hold;
    the pieces tile the dim in coordinate order."""
    ranks = _ranks(runs, mesh)
    for case in _cases():
        n = case[0]
        held = {}
        for out in ranks:
            (off, length), local_len, same, coord, every = out[
                (mesh, case, "extent")]
            assert length == local_len and same, (mesh, case)
            held[coord] = (off, length)
            assert every == ranks[0][(mesh, case, "extent")][4]
        every = ranks[0][(mesh, case, "extent")][4]
        assert [held[c] for c in sorted(held)] == every
        pos = 0
        for off, length in every:
            if length:
                assert off == pos
            pos += length
        assert pos == n


def test_shard_extent_nests_over_two_mesh_dims():
    """DTensor's own layout, without a process group: 10 entries over a 2
    x 2 mesh splitting one dim are 3, 2, 3, 2 at 0, 3, 5, 8 (not
    ``part * ceil(10 / 4)``), and 5 over 4 leave the last rank empty."""
    from torch.distributed.tensor import Replicate, Shard

    nested = [sharding.shard_extent((2, 2), [Shard(1), Shard(1)], (3, 10),
                                    1, c)
              for c in ((0, 0), (0, 1), (1, 0), (1, 1))]
    assert nested == [(0, 3), (3, 2), (5, 3), (8, 2)]
    flat = [sharding.shard_extent((4,), [Shard(0)], (5,), 0, (c,))[1]
            for c in range(4)]
    assert flat == [2, 2, 1, 0]
    assert sharding.shard_extent((2, 2), [Replicate(), Shard(0)], (7,), 0,
                                 (1, 1)) == (4, 3)


def test_the_ranks_import_neither_jax_nor_repro(runs):
    for ranks in runs.values():
        for out in ranks:
            assert out["foreign"] == []


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,block", SIZES)
def test_boards_are_the_references(runs, n, block, dtype):
    """The reference's ``ops.topk`` on the same numpy input (its
    ``lax.top_k`` route for these counts; bf16 in, bf16 out) gives the
    partitioned boards of every mesh, ids and values."""
    import jax.numpy as jnp
    from repro.kernels import ops as ref_ops

    for case in _cases():
        if case[:2] != (n, block) or case[3] != dtype:
            continue
        x = _x(n, case[2], dtype, case[4])
        for k in _ks(n):
            rv, ri = ref_ops.topk(jnp.asarray(x, dtype=dtype), k,
                                  block=block)
            rv = np.asarray(jnp.asarray(rv, jnp.float32))
            for mesh in WORLDS:
                vals, ids = _ranks(runs, mesh)[0][(mesh, case, k)][:2]
                assert np.array_equal(ids, np.asarray(ri)), (mesh, case, k)
                assert np.array_equal(_bits(vals), _bits(rv)), (mesh, case,
                                                                 k)


def test_candidate_width_and_rank_candidates_pad_after_every_entry():
    """A rank's list: its K5 winners (the twin here), then ``(-inf, n)``
    up to the width, ranked after a real ``-inf``; an empty piece sends
    pads alone."""
    x = torch.tensor([[1.0, float("-inf"), 3.0]])
    assert ops.candidate_width(3, 1, 5, 64) == 5
    # the longest piece, ceil(n / shards), in segments of 64
    assert ops.candidate_width(300, 2, 100, 64) == 3 * 64
    assert ops.candidate_width(10, 4, 2, 64) == 2
    vals, ids = ops.rank_candidates(x, 10, 20, 5, 64, 5)
    assert ids.tolist() == [[12, 10, 11, 20, 20]]
    assert vals.tolist() == [[3.0, 1.0] + [float("-inf")] * 3]
    merged = ops._merge(vals, ids, 3)
    assert merged[1].tolist() == [[12, 10, 11]]
    vals, ids = ops.rank_candidates(x[:, :0], 20, 20, 5, 64, 5)
    assert ids.tolist() == [[20] * 5] and vals.dtype == torch.float32
