"""Multi-pod dry run: trace every (arch × shape) cell on ``meta`` tensors on
the production meshes and derive the roofline terms from the trace.

The port's counterpart of ``repro.launch.dryrun``, on the CPU, with no
card. ``main()`` starts a ``fake`` process group of 256 ranks (512 for the
multi-pod mesh) in its own process — it moves no data, so
``launch.mesh.check_mesh_backend`` lets it serve any mesh — and builds the
production meshes over it. Importing this module sets no environment
variable and starts no group. For each cell:

    fn, args = cell.build(mesh)                 # meta tensors
    placements = cell.shardings(mesh, args)
    costs.trace(fn, args)                        # one run under CostMode

Every cell is one rank's program over ``DTensor`` shards: its arguments
are laid out by their placements (``DTensor`` over ``meta`` shards, each
on ``dist.sharding.execution_placements``), rank 0's run is traced under
``dist.sharding.partitioned`` (DTensor's own dispatch runs each op's
redistributions and its local op, and the cells' ``local_map`` programs
their written-out collectives, all of which the cost counter sees), its
count is multiplied by the mesh's size, and its collectives and its peak
of live temporaries are read from that trace.

Record keys differ from the reference's where the port measures something
else: ``trace_s`` (the build and trace, host seconds) replaces
``lower_s``/``compile_s`` (the port compiles nothing); ``flops`` /
``bytes`` are the global traced counts and ``flops_per_device`` /
``bytes_per_device`` replace ``hlo_*_per_device``; there is no
``xla_cost_*``; ``flops_by_dtype`` and ``peak_flops`` say which of the
card's rates ``compute_s`` used (:func:`roofline`). ``memory.argument_size_b`` is exact per device, from the
local shape of each argument under its placements.

Results go to ``build/dryrun_torch.json`` by default, saved atomically
after each cell so that a long sweep survives interruption.

Usage (CPU, no card):
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch bm25s
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all \\
        --include-extra [--multi-pod both] [--out FILE]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import traceback

import torch

# One NVIDIA H100 80GB HBM3 (SXM), at its 700 W power limit; NVIDIA's data
# sheet, dense rates. A FLOP runs at the rate of its compute dtype
# (``costs.compute_dtype``): bf16 and fp16 on the tensor cores, float32
# (the port's f32 matmuls do not use TF32) and every other type outside
# them. The inter-node figure is one GPU's NDR InfiniBand port (400 Gb/s):
# every 16-wide axis of the production mesh crosses a node of 8 GPUs,
# whose NVLink (900 GB/s a GPU) is not the bound.
DEVICE = "NVIDIA H100 80GB HBM3, 700 W"
PEAK_FLOPS = {"bfloat16": 989.4e12, "float16": 989.4e12}   # FLOP/s, dense
PEAK_FLOPS_F32 = 67e12         # FLOP/s, float32 and every other type
HBM_BW = 3.35e12               # B/s, HBM3
LINK_BW = 50e9                 # B/s a GPU, NDR InfiniBand 400 Gb/s


def peak_flops(dtype: str) -> float:
    """The card's FLOP/s for an op that computes in ``dtype``."""
    return PEAK_FLOPS.get(dtype, PEAK_FLOPS_F32)


def roofline(flops_by_dtype: dict, bytes_global: float,
             coll_wire_dev: float, n_chips: int,
             model_flops: float) -> dict:
    """The roofline terms (seconds), the bottleneck and the
    useful-compute ratio.

    ``flops_by_dtype`` (FLOPs by compute dtype) and ``bytes_global`` are
    the traced step's (all devices); per device = ``/ n_chips`` under the
    cell's placements. ``compute_s`` divides each dtype's share by
    :func:`peak_flops` of it; ``peak_flops`` in the record is the rate
    that share-weighted sum comes to (the float32 rate for a step with
    no FLOPs), and ``roofline_fraction`` reads ``model_flops`` against it.
    ``coll_wire_dev`` is one device's wire bytes.
    """
    flops_global = float(sum(flops_by_dtype.values()))
    flops_dev = flops_global / n_chips
    bytes_dev = bytes_global / n_chips
    compute_s = sum(f / peak_flops(d)
                    for d, f in flops_by_dtype.items()) / n_chips
    peak = flops_dev / compute_s if compute_s else PEAK_FLOPS_F32
    terms = {"compute_s": compute_s,
             "memory_s": bytes_dev / HBM_BW,
             "collective_s": coll_wire_dev / LINK_BW}
    bottleneck = max(terms, key=terms.get)
    bound = max(terms.values())
    return {
        "flops_per_device": flops_dev,
        "bytes_per_device": bytes_dev,
        "collective_wire_bytes_per_device": coll_wire_dev,
        **terms,
        "bottleneck": bottleneck.replace("_s", ""),
        "flops_by_dtype": dict(flops_by_dtype),
        "peak_flops": peak,
        "model_flops": model_flops,
        "useful_flops_ratio": (model_flops / flops_global
                               if flops_global else 0.0),
        "step_time_bound_s": bound,
        "roofline_fraction": ((model_flops / (n_chips * peak))
                              / max(bound, 1e-30)),
    }


def _zip_leaves(args, places):
    """(tensor, its placement list) pairs of an argument tree and the
    placement tree ``cell.shardings`` gives for it."""
    if isinstance(args, torch.Tensor):
        yield args, places
    elif isinstance(args, dict):
        for key in args:
            yield from _zip_leaves(args[key], places[key])
    elif isinstance(args, (list, tuple)):
        for a, p in zip(args, places, strict=True):
            yield from _zip_leaves(a, p)


def local_shape(shape, placements, mesh) -> tuple:
    """Rank 0's (the largest) local shape of a tensor of ``shape`` under
    ``placements``: each mesh dim that shards a tensor dim divides it,
    rounding up, in the mesh's order."""
    out = list(shape)
    for i, p in enumerate(placements):
        if p.is_shard():
            out[p.dim] = -(-out[p.dim] // mesh.size(i))
    return tuple(out)


def argument_bytes(args, places, mesh) -> int:
    """Bytes of the arguments one device holds under their placements."""
    return sum(math.prod(local_shape(t.shape, p, mesh)) * t.element_size()
               for t, p in _zip_leaves(args, places))


def lay_out(args, places, mesh):
    """The argument tree with every sharded leaf a ``DTensor`` over a
    ``meta`` shard of its local shape (replicated leaves stay as they
    are): what rank 0 of a partitioned step receives."""
    from torch.distributed.tensor import DTensor

    from ..dist.sharding import execution_placements

    if isinstance(args, torch.Tensor):
        if all(p.is_replicate() for p in places):
            return args
        places = execution_placements(places)
        local = torch.empty(local_shape(args.shape, places, mesh),
                            dtype=args.dtype, device="meta")
        return DTensor.from_local(local, mesh, places, run_check=False,
                                  shape=args.shape, stride=args.stride())
    if isinstance(args, dict):
        return {k: lay_out(v, places[k], mesh) for k, v in args.items()}
    if isinstance(args, (list, tuple)):
        return type(args)(lay_out(a, p, mesh) for a, p in zip(args, places))
    return args


def run_cell(cell, mesh, *, verbose: bool = True) -> dict:
    """Build, lay out and trace one cell on ``mesh``; the record.

    ``trace_s`` is the host seconds of the build and the trace (nothing is
    lowered or compiled). A train step's ``microbatches`` are its
    configured count and the count it runs on the laid-out batch
    (``train.step.microbatch_count``); other cells' are None."""
    from ..dist.sharding import partitioned
    from ..train.step import microbatch_count
    from .costs import trace

    t0 = time.perf_counter()
    if cell.remesh is not None:
        mesh = cell.remesh(mesh)
    fn, args = cell.build(mesh)
    places = cell.shardings(mesh, args)
    n_chips = mesh.size()
    laid = lay_out(args, places, mesh)
    n_mb = getattr(fn, "n_microbatches", None)
    mb = None if n_mb is None else {
        "configured": n_mb, "run": microbatch_count(laid[-1], n_mb)}
    with partitioned(mesh):
        t = trace(fn, laid, track_live=True)
    flops, nbytes = n_chips * t["flops"], n_chips * t["bytes"]
    by_dtype = {k: n_chips * v for k, v in t["flops_by_dtype"].items()}
    colls, wire = t["collectives"], t["wire_bytes"]
    memory = {"argument_size_b": argument_bytes(args, places, mesh),
              "temp_size_b": int(t["peak_live_b"])}
    t_trace = time.perf_counter() - t0
    roof = roofline(by_dtype, nbytes, wire, n_chips, cell.model_flops)
    names = tuple(mesh.mesh_dim_names)
    rec = {
        "arch": cell.arch, "shape": cell.shape, "kind": cell.kind,
        "mesh": "x".join(str(s) for s in mesh.shape),
        "axes": list(names), "n_chips": n_chips,
        "trace_s": round(t_trace, 2),
        "count_bound": cell.count_bound or None,
        "memory": memory, "microbatches": mb, "collectives": colls,
        "flops": flops, "bytes": nbytes,
        **roof,
        "device": DEVICE,
        "note": cell.note, "ok": True,
    }
    if verbose:
        print(f"[dryrun] {cell.key:42s} mesh={rec['mesh']:9s} "
              f"bottleneck={rec['bottleneck']:10s} "
              f"t_bound={rec['step_time_bound_s']:.3e}s "
              f"args/dev={memory['argument_size_b'] / 2**30:.2f}GiB "
              f"temp/dev={memory['temp_size_b'] / 2**30:.2f}GiB "
              f"(trace {t_trace:.1f}s)",
              flush=True)
    return rec


def load_results(path: str) -> dict:
    try:
        with open(path) as f:
            return json.load(f)
    except (FileNotFoundError, json.JSONDecodeError):
        return {}


def save_result(path: str, key: str, rec: dict) -> None:
    results = load_results(path)
    results[key] = rec
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(results, f, indent=1)
    os.replace(tmp, path)


@contextlib.contextmanager
def fake_group(world_size: int):
    """A ``fake`` default process group of ``world_size`` ranks in this
    process, as rank 0; destroyed on exit."""
    import torch.distributed as tdist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    tdist.init_process_group("fake", store=FakeStore(), rank=0,
                             world_size=world_size)
    try:
        yield
    finally:
        tdist.destroy_process_group()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", choices=["off", "on", "both"],
                    default="both")
    ap.add_argument("--out", default="build/dryrun_torch.json")
    ap.add_argument("--skip-done", action="store_true")
    ap.add_argument("--include-extra", action="store_true",
                    help="include the bm25s extra cells in --all")
    args = ap.parse_args(argv)

    from ..configs import all_cells, get_cells
    from .mesh import make_production_mesh

    if args.all:
        cells = all_cells(include_extra=args.include_extra)
    elif args.arch:
        cells = get_cells(args.arch)
        if args.shape:
            cells = [c for c in cells if c.shape == args.shape]
    else:
        ap.error("--arch or --all required")

    pods = {"off": [False], "on": [True],
            "both": [False, True]}[args.multi_pod]
    done = load_results(args.out) if args.skip_done else {}
    failures = []
    for multi_pod in pods:
        tag = "2x16x16" if multi_pod else "16x16"
        with fake_group(512 if multi_pod else 256):
            mesh = make_production_mesh(multi_pod=multi_pod,
                                        device_type="cpu")
            for cell in cells:
                key = f"{cell.key}@{tag}"
                if key in done and done[key].get("ok"):
                    print(f"[dryrun] skip {key} (done)", flush=True)
                    continue
                try:
                    rec = run_cell(cell, mesh)
                except Exception as e:  # record failures, keep sweeping
                    rec = {"arch": cell.arch, "shape": cell.shape,
                           "mesh": tag, "ok": False, "error": repr(e),
                           "traceback": traceback.format_exc()[-2000:]}
                    failures.append(key)
                    print(f"[dryrun] FAIL {key}: {e!r}", flush=True)
                save_result(args.out, key, rec)
    print(f"[dryrun] complete; {len(failures)} failures: {failures}",
          flush=True)


if __name__ == "__main__":
    main()
