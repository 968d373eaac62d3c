"""Device meshes over a ``torch.distributed`` process group.

The port's counterpart of ``repro.launch.mesh``. Every builder is a
FUNCTION: importing this module starts no process group and touches no
device. The caller initialises the default group first
(``torch.distributed.init_process_group`` with its address, world size
and rank); a ``cuda`` mesh needs an NCCL group and a ``cpu`` mesh a gloo
one (:func:`check_mesh_backend`), so a collective never copies a card's
tensors to the host behind the caller's back. The dry run's ``fake``
group, which moves no data, serves either.

Single pod: 16×16 = 256 ranks, axes ("data", "model"). Multi-pod: 2×16×16
= 512 ranks, axes ("pod", "data", "model") — "pod" is pure data
parallelism, "data"/"model" stay within a pod.

:func:`make_mesh_from` supports elastic scaling: given whatever ranks
survive, it builds the largest valid (data, model) mesh.
"""

from __future__ import annotations

# the backend a mesh's collectives need, by the mesh's device type
_BACKEND = {"cuda": "nccl", "cpu": "gloo"}


def mesh_shape(n: int, *, max_model: int = 16) -> tuple[int, int]:
    """The ``(data, model)`` shape :func:`make_mesh_from` gives ``n`` ranks.

    ``model`` is the largest power of two ≤ ``max_model`` that divides
    ``n``; ``data = n // model``, so no rank is left over.
    """
    model = 1
    while model * 2 <= max_model and n % (model * 2) == 0:
        model *= 2
    return n // model, model


def check_mesh_backend(device_type: str, group=None) -> None:
    """Raise ``ValueError`` unless ``group``'s backend (default: the
    default group's) serves tensors of ``device_type``: NCCL for ``cuda``,
    gloo for ``cpu``. A ``fake`` group (the dry run's, which moves no
    data) serves either."""
    import torch.distributed as tdist

    need = _BACKEND.get(device_type)
    if need is None:
        raise ValueError(f"unknown mesh device type {device_type!r}; "
                         f"expected one of {sorted(_BACKEND)}")
    backend = str(tdist.get_backend(group))
    if backend == "fake":
        return
    if ":" in backend:              # e.g. "cpu:gloo,cuda:nccl"
        have = dict(p.split(":") for p in backend.split(",")).get(
            device_type)
    else:
        have = backend
    if have != need:
        raise ValueError(
            f"a {device_type} mesh needs a {need} process group, but the "
            f"group's backend is {backend!r}; initialise the process group "
            f"with backend={need!r}")


def make_mesh_from(ranks=None, *, max_model: int = 16,
                   device_type: str = "cuda"):
    """Largest ``(data, model)`` mesh over the given (surviving) ranks.

    ``ranks`` defaults to every rank of the default group. The shape is
    :func:`mesh_shape`'s; ranks past ``data × model`` are dropped (elastic
    downsize never deadlocks). Every rank of the default group must call
    this (the mesh's process groups are created collectively); a dropped
    rank gets a mesh in which it has no coordinate
    (``mesh.get_coordinate()`` is None).
    """
    import torch
    import torch.distributed as tdist
    from torch.distributed.device_mesh import DeviceMesh

    if not tdist.is_initialized():
        raise RuntimeError("make_mesh_from needs an initialised default "
                           "process group (torch.distributed."
                           "init_process_group)")
    check_mesh_backend(device_type)
    ranks = list(range(tdist.get_world_size()) if ranks is None else ranks)
    if not ranks:
        raise ValueError("make_mesh_from needs at least one rank")
    data, model = mesh_shape(len(ranks), max_model=max_model)
    grid = torch.tensor(ranks[:data * model], dtype=torch.int64).reshape(
        data, model)
    return DeviceMesh(device_type, grid, mesh_dim_names=("data", "model"))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The production mesh: (16, 16) over ("data", "model"), or
    (2, 16, 16) over ("pod", "data", "model") with ``multi_pod``. The
    default group must hold exactly 256 (512) ranks."""
    from torch.distributed.device_mesh import init_device_mesh

    check_mesh_backend(device_type)
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_test_mesh(n_devices: int | None = None, *,
                   device_type: str = "cuda"):
    """Small mesh over the first ``n_devices`` ranks (all by default)."""
    import torch.distributed as tdist

    ranks = list(range(tdist.get_world_size()))[:n_devices]
    return make_mesh_from(ranks, device_type=device_type)
