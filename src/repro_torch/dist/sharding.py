"""Logical-axis sharding: models annotate, meshes decide.

The port's counterpart of ``repro.dist.sharding``, over a
``torch.distributed`` :class:`~torch.distributed.device_mesh.DeviceMesh`.
Model code names *logical* axes — ``"dp"`` (all data-parallel mesh axes:
``"pod"`` and/or ``"data"``) and ``"model"`` (tensor parallelism) — and
this module resolves them against whatever mesh is active:

* :func:`activation_sharding` pushes a mesh onto a stack for the duration
  of a ``with`` block; :func:`constrain` is a NO-OP outside any such
  block, so the exact same model code runs on one device and on a mesh.
* Resolution is divisibility-checked per dimension: an axis whose size
  does not divide the dimension is silently dropped (replicated) instead
  of failing, which is what makes elastic meshes (6 ranks, 4 heads on an
  8-way model axis, ...) work.

A placement is a DTensor placement list, one entry per MESH dimension:
``Shard(d)`` where the reference's ``PartitionSpec`` puts that mesh axis
on tensor dim ``d`` (a ``_StridedShard`` where a spec lists a dim's axes
out of the mesh's order), ``Replicate()`` elsewhere;
:func:`spec_placements` turns a spec into one. ``batch_pspec`` /
``param_pspecs`` are the generic placement rules for cells that have no
architecture-specific sharding (the LM family's are
``configs.common.lm_param_pspecs``).

A partitioned step is one rank's program over ``DTensor`` operands:
:func:`distribute` lays global tensors out by a cell's placements (each
on :func:`execution_placements`), and the step runs under
:func:`partitioned`, where :func:`constrain` redistributes and plain
tensors the step makes count as replicated. The model code keeps its
plain-tensor path and takes the ``DTensor`` one where its operands are
``DTensor`` s inside such a block (:func:`is_partitioned`: outside every
block, on the plain path, one look at the mesh stack); :func:`split_index`,
:func:`shard_extent`, :func:`as_dtensor`, :func:`replicated_local`,
:func:`reduced_grad` and :func:`gathered_over_data` serve its
``local_map`` programs, whose
collectives are written out over :func:`axes_group`'s groups with
:func:`gather_over`, :func:`scatter_sum`, :func:`sum_over` and
:func:`copy_to`.
"""

from __future__ import annotations

import contextlib
import math
import weakref

import torch

from ..models.common import tree_map

# Data-parallel logical axis -> these mesh axes (in mesh-major order).
_DP_AXES = ("pod", "data")

_MESH_STACK: list = []


@contextlib.contextmanager
def activation_sharding(mesh):
    """Activate ``mesh`` for :func:`constrain` / :func:`dp_spmd_axes`."""
    _MESH_STACK.append(mesh)
    try:
        yield mesh
    finally:
        _MESH_STACK.pop()


def _active_mesh():
    return _MESH_STACK[-1] if _MESH_STACK else None


def _sizes(mesh) -> dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def data_axes(mesh) -> tuple[str, ...]:
    """The mesh's non-trivial data-parallel axes (subset of pod/data)."""
    sizes = _sizes(mesh)
    return tuple(a for a in _DP_AXES if sizes.get(a, 1) > 1)


def _axes_size(mesh, axes: tuple[str, ...]) -> int:
    sizes = _sizes(mesh)
    return int(math.prod(sizes[a] for a in axes)) if axes else 1


def _dp_entry(mesh) -> str | tuple[str, ...] | None:
    axes = data_axes(mesh)
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else axes


def dp_spmd_axes() -> str | tuple[str, ...] | None:
    """The active mesh's data-parallel axis name(s), as the reference
    passes them to ``vmap(spmd_axis_name=...)``.

    ``None`` when no mesh is active or the active mesh has no data axes.
    """
    mesh = _active_mesh()
    if mesh is None:
        return None
    return _dp_entry(mesh)


def _resolve(mesh, dim: int, name: str | None) -> tuple[str, ...]:
    """Logical axis name -> the mesh axes sharding a dim of size ``dim``
    (empty: replicated), divisibility-checked."""
    if name is None:
        return ()
    if name == "dp":
        axes = data_axes(mesh)
        if not axes or dim % _axes_size(mesh, axes) != 0:
            return ()
        return axes
    size = _sizes(mesh).get(name, 1)
    return (name,) if size > 1 and dim % size == 0 else ()


def _placements(mesh, per_dim: list[tuple[str, ...]]) -> list:
    """Per-tensor-dim mesh axes -> one DTensor placement per mesh dim.

    A dim's axes are listed major first, as a ``PartitionSpec`` entry
    lists them. Listed in the mesh's order they are plain ``Shard``s; an
    axis listed after an axis that comes later in the mesh (``("model",
    "data")`` on a (data, model) mesh) is a ``_StridedShard`` whose split
    factor is the size of those later axes, which is how DTensor places a
    dim split over mesh dims out of their order."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    sizes = _sizes(mesh)
    out = {}
    for d, axes in enumerate(per_dim):
        for i, a in enumerate(axes):
            later = [b for b in axes[:i] if names.index(b) > names.index(a)]
            if later:
                from torch.distributed.tensor.placement_types import (
                    _StridedShard)
                out[a] = _StridedShard(d, split_factor=math.prod(
                    sizes[b] for b in later))
            else:
                out[a] = Shard(d)
    return [out.get(a, Replicate()) for a in names]


def spec_placements(mesh, *entries) -> list:
    """The placements of ``PartitionSpec(*entries)`` on ``mesh``: each
    entry names the mesh axes that shard its tensor dim (a name, a tuple
    of names major first, or None); the dims past the entries and the
    axes none names replicate."""
    return _placements(mesh, [
        () if e is None else (e,) if isinstance(e, str) else tuple(e)
        for e in entries])


def is_dtensor(x) -> bool:
    """Whether ``x`` is a ``DTensor`` (a partitioned step's operand)."""
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def is_partitioned(x) -> bool:
    """Whether ``x`` is an operand of a partitioned step: a ``DTensor``
    inside an :func:`activation_sharding` block (:func:`partitioned`
    opens one). Outside every block it is False at the cost of one look
    at the mesh stack, as :func:`constrain` makes, so the plain path
    pays no type check an op."""
    return bool(_MESH_STACK) and is_dtensor(x)


def execution_placements(placements) -> list:
    """The placements a partitioned step runs a tensor on: each
    ``_StridedShard`` becomes the plain ``Shard`` of its dim, so a dim
    that a spec splits over mesh dims out of their order (``("model",
    "data")`` on a (data, model) mesh) is split in the mesh's order
    instead. Every device holds the same number of bytes either way; the
    spec's placements stay what :func:`spec_placements` gives."""
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.placement_types import _StridedShard

    return [Shard(p.dim) if isinstance(p, _StridedShard) else p
            for p in placements]


def distribute(tree, placements, mesh):
    """``tree`` (global tensors, the same on every rank) as ``DTensor``
    leaves under ``placements`` (a tree of placement lists, as a cell's
    ``shardings`` gives), each run on its :func:`execution_placements`;
    every rank keeps its own shard."""
    from torch.distributed.tensor import distribute_tensor

    if isinstance(tree, torch.Tensor):
        return distribute_tensor(tree, mesh,
                                 execution_placements(placements))
    if isinstance(tree, dict):
        return {k: distribute(v, placements[k], mesh)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(distribute(v, p, mesh)
                          for v, p in zip(tree, placements, strict=True))
    return tree


def as_dtensor(x, mesh):
    """``x`` as a ``DTensor`` on ``mesh``: a plain tensor (the same on
    every rank) is replicated."""
    from torch.distributed.tensor import DTensor, Replicate

    if isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def replicated_local(x):
    """A plain tensor holding all of ``x``: a ``DTensor`` is made
    replicated (a no-op where it is) and its local tensor returned."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate

    return x.redistribute(x.device_mesh,
                          [Replicate()] * x.device_mesh.ndim).to_local()


def split_index(mesh, placements, dim: int) -> tuple[int, int]:
    """``(i, n)``: this rank holds the ``i``-th of the ``n`` pieces of
    tensor dim ``dim`` under ``placements`` (mesh dims that shard it,
    major first in the mesh's order). Where ``n`` divides the dim the
    pieces are equal and piece ``i`` starts at ``i`` times their length.
    Otherwise DTensor's pieces differ in length and nest over the mesh
    dims, so ``i`` alone does not give the rank's offset: take
    :func:`shard_extent`'s."""
    i, n = 0, 1
    for m, p in enumerate(placements):
        if p.is_shard(dim):
            i = i * mesh.size(m) + mesh.get_local_rank(m)
            n *= mesh.size(m)
    return i, n


def shard_extent(mesh, placements, shape, dim: int,
                 coordinate=None) -> tuple[int, int]:
    """``(offset, length)`` of this rank's piece of tensor dim ``dim`` of a
    tensor of global ``shape`` under ``placements``, as DTensor lays it
    out (``torch.distributed.tensor._utils``): each mesh dim that shards
    it cuts the piece before it into chunks of ``ceil(size / ranks)``, so
    the last chunks may be shorter or empty, and a split over two mesh
    dims nests (10 over 2 x 2: lengths 3, 2, 3, 2 at offsets 0, 3, 5, 8).
    An empty piece has length 0 (its offset says nothing). ``coordinate``
    asks for the piece of the rank at that mesh coordinate instead; then
    ``mesh`` may be the mesh's shape alone. A rank outside the mesh holds
    ``(0, 0)``."""
    from torch.distributed.tensor import _utils

    shape = tuple(int(s) for s in shape)
    if coordinate is None:
        local, off = _utils.compute_local_shape_and_global_offset(
            shape, mesh, list(placements))
    else:
        mesh_shape = tuple(getattr(mesh, "shape", mesh))
        local, off = _utils._compute_local_shape_and_global_offset(
            shape, mesh_shape, [int(c) for c in coordinate],
            list(placements))
    if not off:
        return 0, 0
    return int(off[dim]), int(local[dim])


def gathered_over_data(w):
    """``w`` gathered over the mesh's data axes (the FSDP/ZeRO gather of a
    weight before its use; its backward reduce-scatters the gradient),
    keeping its other placements. A plain ``w`` is returned as it is."""
    if not is_partitioned(w):
        return w
    from torch.distributed.tensor import Replicate

    mesh = w.device_mesh
    dp = data_axes(mesh)
    return w.redistribute(mesh, [
        Replicate() if n in dp else p
        for n, p in zip(mesh.mesh_dim_names, w.placements)])


# the flattened groups of several mesh axes, created once a mesh
_FLAT_GROUPS: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def flat_group(mesh, axes: tuple[str, ...]):
    """The flattened group of several mesh ``axes`` that holds this rank.

    Created here the first time for a mesh: every rank of the default
    group creates every such group, in the same order (a collective), and
    keeps the one it belongs to (None on a rank outside the mesh). One
    axis needs no new group: None (the mesh's own group for that axis,
    :func:`axes_group`, resolved on a member at call time).
    """
    import torch.distributed as tdist

    axes = tuple(axes)
    if len(axes) == 1:
        return None
    groups = _FLAT_GROUPS.setdefault(mesh, {})
    if axes not in groups:
        names = tuple(mesh.mesh_dim_names)
        grid = mesh.mesh
        dims = [names.index(a) for a in axes]
        rest = [d for d in range(grid.dim()) if d not in dims]
        n = math.prod(int(grid.shape[d]) for d in dims)
        me, mine = tdist.get_rank(), None
        for row in grid.permute(*rest, *dims).reshape(-1, n).tolist():
            g = tdist.new_group(sorted(row))
            if me in row:
                mine = g
        groups[axes] = mine
    return groups[axes]


def axes_group(mesh, axes: tuple[str, ...]):
    """The process group over the mesh ``axes`` (in the mesh's order) that
    holds this rank, or None where those axes hold one rank: a collective
    over it would move nothing."""
    axes = tuple(axes)
    if not axes or math.prod(_sizes(mesh)[a] for a in axes) == 1:
        return None
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    return flat_group(mesh, axes)


def _waited(y):
    from torch.distributed import _functional_collectives as funcol

    return y.wait() if isinstance(y, funcol.AsyncCollectiveTensor) else y


def _all_reduce(x, group):
    from torch.distributed import _functional_collectives as funcol

    return _waited(funcol.all_reduce(x, "sum", group))


def gather_over(x, group):
    """The ranks' ``x`` of ``group`` (a process group, or ``(mesh,
    mesh_dim)``) concatenated on dim 0, in the group's rank order; no
    gradient."""
    from torch.distributed import _functional_collectives as funcol

    return _waited(funcol.all_gather_tensor(x.contiguous(), 0, group))


def _scatter_rows(x, group):
    from torch.distributed import _functional_collectives as funcol

    return _waited(funcol.reduce_scatter_tensor(x.contiguous(), "sum", 0,
                                                group))


class _ScatterSum(torch.autograd.Function):
    """Reduce-scatter on dim 0; the backward all-gathers the gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _scatter_rows(x, group)

    @staticmethod
    def backward(ctx, grad):
        return gather_over(grad, ctx.group), None


def scatter_sum(x, group):
    """The sum over ``group``'s ranks of ``x``, each rank keeping its own
    block of dim 0 (the inverse of :func:`gather_over`): one
    reduce-scatter, whose backward all-gathers the gradient."""
    return _ScatterSum.apply(x, group)


class _SumOver(torch.autograd.Function):
    """Tensors of partial sums, all-reduced over ``group`` in one
    collective; the backward passes each gradient on as it is (it is the
    same on every rank: what follows the sum is replicated), and none for
    a sum the loss does not read."""

    @staticmethod
    def forward(ctx, group, *parts):
        ctx.set_materialize_grads(False)
        widths = [p[0].numel() for p in parts]
        packed = torch.cat([p.reshape(p.shape[0], -1) for p in parts], 1)
        whole = _all_reduce(packed, group)
        return tuple(c.reshape(p.shape).clone() for c, p in zip(
            whole.split(widths, dim=1), parts))

    @staticmethod
    def backward(ctx, *grads):
        return (None, *grads)


def sum_over(parts, group):
    """The sums over ``group``'s ranks of each of ``parts`` (tensors of one
    leading size, each rank's partial sums): one all-reduce. The reverse
    of :func:`copy_to` in a ``local_map`` program whose ranks each take
    a share of the work and whose result is replicated."""
    return list(_SumOver.apply(group, *parts))


class _CopyTo(torch.autograd.Function):
    """Tensors as they are; their gradients all-reduced over ``group`` in
    one collective."""

    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        flat = [g.reshape(-1) for g in grads]
        whole = _all_reduce(torch.cat(flat), ctx.group)
        return (None, *(c.view(g.shape) for c, g in zip(
            whole.split([f.numel() for f in flat]), grads)))


def copy_to(xs, group):
    """Tensors ``xs`` (each the same on every rank of ``group``) handed to
    work that the ranks share out: their values as they are, their
    gradients (each rank's share) summed over ``group``, all of them in
    one all-reduce once the last has come back. The reverse of
    :func:`sum_over`."""
    return list(_CopyTo.apply(group, *xs))


def reduced_grad(x):
    """``x`` itself, whose gradient is redistributed to ``x``'s own
    placements before it flows back (a partial gradient is reduced
    there), so that the op that made ``x`` runs its backward on each
    rank's part instead of on every rank whole. A plain ``x`` is
    returned as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(x.to_local(grad_placements=x.placements),
                              x.device_mesh, x.placements, run_check=False,
                              shape=x.shape, stride=x.stride())


@contextlib.contextmanager
def partitioned(mesh):
    """Run a step's code as one rank's program over ``DTensor`` operands
    on ``mesh``: :func:`constrain` resolves against ``mesh``, and a plain
    tensor the step makes counts as replicated where it meets a
    ``DTensor`` (``implicit_replication``)."""
    from torch.distributed.tensor.experimental import implicit_replication

    with activation_sharding(mesh), implicit_replication():
        yield mesh


def serving_mode(tree):
    """The context a serving step runs in: ``torch.inference_mode()``,
    or ``torch.no_grad()`` where ``tree`` holds a partitioned step's
    ``DTensor`` (DTensor refuses inference tensors). Neither records
    autograd history; the arithmetic is the same. Outside every
    :func:`activation_sharding` block the tree is not walked."""
    if not _MESH_STACK:
        return torch.inference_mode()
    from torch.utils._pytree import tree_flatten

    if any(is_dtensor(t) for t in tree_flatten(tree)[0]):
        return torch.no_grad()
    return torch.inference_mode()


def constrain(x, *axes: str | None):
    """Place ``x`` by logical axis names, one per dim.

    No-op outside an :func:`activation_sharding` block. Inside one, a
    ``DTensor`` is redistributed to the resolved placements (a collective
    when they change); a plain tensor is local data and comes back as it
    is. Unresolvable axes (absent from the mesh, size 1, or not dividing
    the dimension) replicate rather than fail; a rank mismatch raises
    ``ValueError``.
    """
    mesh = _active_mesh()
    if mesh is None:
        return x
    if len(axes) != x.ndim:
        raise ValueError(
            f"constrain got {len(axes)} axis names for rank-{x.ndim} array")
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    per_dim = [_resolve(mesh, d, a) for d, a in zip(x.shape, axes)]
    return x.redistribute(mesh, _placements(mesh, per_dim))


def batch_pspec(shape, mesh) -> list:
    """Batch placement: leading dim over the data axes when divisible."""
    shape = tuple(shape)
    axes = data_axes(mesh)
    if not shape or not axes:
        return _placements(mesh, [])
    n = _axes_size(mesh, axes)
    if shape[0] > 0 and shape[0] % n == 0:
        return _placements(mesh, [axes])
    return _placements(mesh, [])


def param_pspecs(params_shapes, mesh):
    """Generic ZeRO-ish parameter placement for architecture-less cells.

    Shards the first dimension divisible by the data-axes size; everything
    else replicates. ``params_shapes`` is a tree of dicts, lists and
    tuples (named ones too) whose leaves have a ``shape`` (tensors, or
    anything else that carries one); the result has the same structure
    with a placement list at each leaf.
    """
    axes = data_axes(mesh)
    n = _axes_size(mesh, axes)

    def one(leaf) -> list:
        shape = tuple(getattr(leaf, "shape", ()))
        if axes:
            for i, d in enumerate(shape):
                if d >= n and d % n == 0:
                    return _placements(mesh, [()] * i + [axes])
        return _placements(mesh, [])

    return tree_map(one, params_shapes)
