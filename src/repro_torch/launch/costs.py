"""Cost accounting for the dry run's roofline: one trace on ``meta`` tensors.

The port's counterpart of ``repro.launch.costs``. The reference walks the
jaxpr and multiplies each ``scan`` body by its length, because XLA's
``cost_analysis`` counts a loop body once. The port has no compiler and no
loop primitive: the step runs as Python on ``meta`` tensors (shapes and
dtypes, no data, no device) under one ``TorchDispatchMode``, so every loop
runs its trips and every op is seen once a time it runs — trip counts are
exact by construction, autograd's backward included.

Each op is charged by the reference's traffic model (``repro/launch/
costs.py``), op by op:

* matmul-like (the ops ``torch.utils.flop_counter`` has a formula for:
  ``mm``, ``bmm``, ``addmm``, ``baddbmm``, convolutions, attention):
  ``2 · out · k`` FLOPs from that formula, operands read and the result
  written;
* gather, index and embedding: twice the output's bytes;
* scatter and ``index_add_``/``index_copy_``/``index_put_``: FLOPs equal to
  the updates, twice the updates' bytes;
* reductions: FLOPs and bytes of the input;
* sort and top-k: ``n · log2 n`` FLOPs, twice the input's bytes;
* cumulative ops: twice the output, FLOPs and bytes;
* views, reshapes, casts, copies and constants: free;
* the port's kernels (``kernels.meta``): the formula written beside each;
* any other (elementwise) op: FLOPs and bytes of its outputs.

A step whose sizes depend on the data runs its ``meta`` path, which takes
the static bound (``core.scoring.score_batch``: every query's whole
``p_max`` budget); the cell says so (``Cell.count_bound``). A rank-local
step (a ``partitioned`` cell) is traced on one rank and its count
multiplied by the number of shards, the reference's ``shard_map_factor``.

Each op's FLOPs are also filed under its compute dtype (its first
floating-point input's, else its first output's; a kernel's ``meta`` op
may name another: K5's and K6's bf16 instantiations compute in f32), so
that the roofline can divide each share by the card's rate for that
type.

Collectives (``c10d`` ops and the functional ones, seen in the same trace)
are counted per op: the count, the payload (the result's bytes) and the
wire bytes, 2× the payload for an all-reduce and 1× for the rest, as the
reference's ``dryrun.parse_collectives`` counts them. They are what one
rank sends, so they are per device already.
"""

from __future__ import annotations

import math
import time
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

_FREE = {
    # views and reshapes (composite ops such as ``reshape`` are decomposed
    # before they are classified)
    "view", "_unsafe_view", "_reshape_alias", "expand", "permute",
    "transpose", "t", "squeeze", "unsqueeze", "slice", "select",
    "as_strided", "alias", "detach", "split", "split_with_sizes", "unbind",
    "diagonal", "view_as_real", "view_as_complex", "unfold", "lift_fresh",
    "flip", "_to_copy", "clone", "copy_", "_copy_from",
    "_copy_from_and_resize", "copy",
    # constants and allocations (a broadcast constant in the reference)
    "empty", "empty_like", "empty_strided", "new_empty",
    "new_empty_strided", "zeros", "zeros_like", "ones", "ones_like",
    "full", "full_like", "new_zeros", "new_ones", "new_full", "fill_",
    "zero_", "fill", "arange", "scalar_tensor", "lift_fresh_copy",
    "resize_", "set_", "_local_scalar_dense", "is_same_size",
}
_GATHER = {"gather", "index", "index_select", "embedding", "take",
           "masked_select"}
# scatter-like op -> the position of its updates among the arguments
_SCATTER = {"scatter": 3, "scatter_": 3, "scatter_add": 3,
            "scatter_add_": 3, "scatter_reduce": 3, "scatter_reduce_": 3,
            "index_add": 3, "index_add_": 3, "index_copy": 3,
            "index_copy_": 3, "index_reduce": 3, "index_reduce_": 3,
            "index_put": 2, "index_put_": 2, "_index_put_impl_": 2,
            "masked_scatter": 2, "masked_scatter_": 2, "slice_scatter": 1,
            "select_scatter": 1, "diagonal_scatter": 1,
            "embedding_dense_backward": 0}
_REDUCE = {"sum", "mean", "amax", "amin", "max", "min", "argmax", "argmin",
           "prod", "var", "std", "var_mean", "std_mean", "linalg_vector_norm",
           "norm", "logsumexp", "any", "all", "count_nonzero", "nansum",
           "_softmax", "_log_softmax", "segment_reduce", "aminmax"}
_SORT = {"sort", "topk", "kthvalue"}
_CUMULATIVE = {"cumsum", "cumsum_", "cumprod", "cumprod_", "cummax",
               "cummin", "logcumsumexp", "_cummax_helper", "_cummin_helper"}
# collective op -> the reference's name for it
_COLLECTIVES = {
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "all_to_all_single": "all-to-all",
    "broadcast_": "broadcast", "broadcast": "broadcast",
}


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _storage_key(t) -> int:
    """The identity of ``t``'s storage (a ``DTensor``'s: its shard's)."""
    local = getattr(t, "_local_tensor", t)
    return local.untyped_storage()._cdata


def _nbytes(t) -> float:
    return float(t.numel()) * t.element_size()


class Shape(tuple):
    """A tensor's shape, with its element size in bytes (``itemsize``)."""

    itemsize: int = 4


def _shapes(tree):
    """``tree`` with each tensor replaced by its :class:`Shape` (the
    kernels' cost formulas take shapes, and their bytes from
    ``itemsize``)."""
    if isinstance(tree, torch.Tensor):
        s = Shape(tree.shape)
        s.itemsize = tree.element_size()
        return s
    if isinstance(tree, (list, tuple)):
        return type(tree)(_shapes(x) for x in tree)
    return tree


def op_cost(func, args, kwargs, out) -> tuple[float, float]:
    """(FLOPs, bytes) of one op by the traffic model above."""
    from torch.utils.flop_counter import flop_registry

    from ..kernels.meta import COSTS

    packet = func.overloadpacket
    name = packet.__name__
    if packet in COSTS:
        return COSTS[packet](*_shapes(args), **_shapes(kwargs))
    if packet in flop_registry:
        flops = flop_registry[packet](*args, **kwargs, out_val=out)
        return float(flops), sum(_nbytes(t) for t in _tensors((args,
                                                               kwargs, out)))
    if func.namespace in ("c10d", "_c10d_functional",
                          "_c10d_functional_autograd") or name in _FREE:
        return 0.0, 0.0
    if name in _GATHER:
        return 0.0, 2.0 * sum(_nbytes(t) for t in _tensors(out))
    if name in _SCATTER:
        upd = args[_SCATTER[name]] if len(args) > _SCATTER[name] else None
        if not isinstance(upd, torch.Tensor):   # a scalar: one per index
            upd = args[2]
        return float(upd.numel()), 2.0 * _nbytes(upd)
    if name in _REDUCE:
        ins = _tensors(args[:1])
        return (float(sum(t.numel() for t in ins)),
                sum(_nbytes(t) for t in ins))
    if name in _SORT:
        ins = _tensors(args[:1])
        n = float(sum(t.numel() for t in ins))
        return (n * max(math.log2(max(n, 2.0)), 1.0),
                2.0 * sum(_nbytes(t) for t in ins))
    if name in _CUMULATIVE:
        outs = _tensors(out)
        return (2.0 * sum(t.numel() for t in outs[:1]),
                2.0 * sum(_nbytes(t) for t in outs[:1]))
    outs = _tensors(out)
    return float(sum(t.numel() for t in outs)), sum(_nbytes(t) for t in outs)


def compute_dtype(args, out) -> str:
    """The dtype an op computes in, by name (``"bfloat16"``, ``"float32"``,
    ...): its first floating-point input's, else its first output's."""
    ins = _tensors(args)
    t = next((t for t in ins if t.is_floating_point()),
             next(iter(ins + _tensors(out)), None))
    return "none" if t is None else str(t.dtype).removeprefix("torch.")


def collective_payload(func, args, out) -> tuple[str, float] | None:
    """(the reference's op name, payload bytes) of a collective op, else
    None. A ``c10d`` op's result is its first argument (the output or the
    in-place buffers); a functional one's is its return value."""
    kind = _COLLECTIVES.get(func.overloadpacket.__name__)
    if kind is None or func.namespace not in (
            "c10d", "_c10d_functional", "_c10d_functional_autograd"):
        return None
    res = args[0] if func.namespace == "c10d" else out
    return kind, sum(_nbytes(t) for t in _tensors(res))


def _DTensor():
    from torch.distributed.tensor import DTensor
    return DTensor


def _FakeTensor():
    from torch._subclasses.fake_tensor import FakeTensor
    return FakeTensor


def _any_of(cls, tree) -> bool:
    """Is ``tree`` (an op's arguments or results: tensors, scalars and
    lists, tuples and dicts of them) or a leaf of it a ``cls``?"""
    if isinstance(tree, cls):
        return True
    if isinstance(tree, (list, tuple)):
        return any(_any_of(cls, x) for x in tree)
    if isinstance(tree, dict):
        return any(_any_of(cls, x) for x in tree.values())
    return False


class CostMode(TorchDispatchMode):
    """Counts every op dispatched while it is on: FLOPs and bytes by
    :func:`op_cost` (in total, by op name, and the FLOPs by
    :func:`compute_dtype`), collectives by
    :func:`collective_payload`, and with ``track_live`` the peak bytes of
    the tensors the trace made that are alive at once (the storages of
    ``exclude``, the step's arguments, are not counted)."""

    def __init__(self, *, track_live: bool = False, exclude=()):
        super().__init__()
        self.flops = self.bytes = 0.0
        self.by_op: dict[str, dict] = {}
        self.flops_by_dtype: dict[str, float] = {}
        self.collectives: dict[str, dict] = {}
        self.track_live = track_live
        self.peak_live_b = 0.0
        self._skip = {_storage_key(t) for t in _tensors(exclude)}
        # storage -> [its bytes, the trace's tensors alive on it]
        self._live: dict[int, list] = {}
        self._live_b = 0.0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.utils.flop_counter import flop_registry

        from ..kernels.meta import COMPUTE_DTYPES, COSTS

        kwargs = kwargs or {}
        if _any_of(_DTensor(), (args, kwargs)):
            # a partitioned step's op: DTensor's own dispatch runs the
            # redistributions and the local op, which come back here
            return NotImplemented
        if _any_of(_FakeTensor(), (args, kwargs)):
            # DTensor's shape propagation (global shapes, no data): not an
            # op of the step
            return func(*args, **kwargs)
        if func.overloadpacket not in flop_registry and (
                func.overloadpacket not in COSTS):
            # a composite op (``einsum``, ``matmul``, ``softmax`` under
            # ``inference_mode``) reaches the mode whole: count the ops it
            # decomposes into instead
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if _any_of(_FakeTensor(), out):
            return out
        coll = collective_payload(func, args, out)
        if coll is not None:
            kind, payload = coll
            d = self.collectives.setdefault(
                kind, {"count": 0, "bytes": 0, "wire_bytes": 0})
            d["count"] += 1
            d["bytes"] += int(payload)
            d["wire_bytes"] += int((2 if kind == "all-reduce" else 1)
                                   * payload)
        flops, nbytes = op_cost(func, args, kwargs, out)
        self.flops += flops
        self.bytes += nbytes
        if flops:
            key = COMPUTE_DTYPES.get(func.overloadpacket) or compute_dtype(
                args, out)
            self.flops_by_dtype[key] = (self.flops_by_dtype.get(key, 0.0)
                                        + flops)
        d = self.by_op.setdefault(str(func.overloadpacket),
                                  {"count": 0, "flops": 0.0, "bytes": 0.0})
        d["count"] += 1
        d["flops"] += flops
        d["bytes"] += nbytes
        if self.track_live:
            self._note_live(out)
        return out

    def _note_live(self, out) -> None:
        for t in _tensors(out):
            key = _storage_key(t)
            if key in self._skip:
                continue
            entry = self._live.get(key)
            if entry is None:
                local = getattr(t, "_local_tensor", t)
                entry = self._live[key] = [
                    float(local.untyped_storage().nbytes()), 0]
                self._live_b += entry[0]
            entry[1] += 1
            weakref.finalize(t, self._drop, key)
        self.peak_live_b = max(self.peak_live_b, self._live_b)

    def _drop(self, key) -> None:
        """A tensor on storage ``key`` died; the storage leaves the live
        set with its last one."""
        entry = self._live.get(key)
        if entry is not None:
            entry[1] -= 1
            if entry[1] == 0:
                self._live_b -= entry[0]
                del self._live[key]


def trace(fn, args, *, track_live: bool = False) -> dict:
    """Run ``fn(*args)`` (``meta`` tensors) under one :class:`CostMode`.

    Returns ``{"flops", "bytes", "by_op", "flops_by_dtype",
    "collectives" ({op: {"count",
    "bytes", "wire_bytes"}}), "wire_bytes", "peak_live_b" (None unless
    ``track_live``), "seconds"}`` for that one run, unscaled."""
    t0 = time.perf_counter()
    with CostMode(track_live=track_live, exclude=args) as mode:
        fn(*args)
    return {"flops": mode.flops, "bytes": mode.bytes, "by_op": mode.by_op,
            "flops_by_dtype": mode.flops_by_dtype,
            "collectives": mode.collectives,
            "wire_bytes": sum(d["wire_bytes"]
                              for d in mode.collectives.values()),
            "peak_live_b": mode.peak_live_b if track_live else None,
            "seconds": time.perf_counter() - t0}


def traced_cost(fn, args, *, n_shards: int = 1) -> dict:
    """Trace ``fn(*args)`` on ``meta`` tensors and return its global
    ``{"flops", "bytes"}`` (and ``"by_op"``, the same by op name, and
    ``"flops_by_dtype"``): a rank-local step's one-rank count times
    ``n_shards``."""
    t = trace(fn, args)
    return {"flops": n_shards * t["flops"], "bytes": n_shards * t["bytes"],
            "flops_by_dtype": {k: n_shards * v
                               for k, v in t["flops_by_dtype"].items()},
            "by_op": {k: {"count": n_shards * d["count"],
                          "flops": n_shards * d["flops"],
                          "bytes": n_shards * d["bytes"]}
                      for k, d in t["by_op"].items()}}


def collective_bytes(fn, args) -> dict:
    """Every collective ``fn(*args)`` issues on this rank while it is
    traced: ``{"per_op": {op: {"count", "bytes", "wire_bytes"}},
    "wire_bytes"}``, per device."""
    t = trace(fn, args)
    return {"per_op": t["collectives"], "wire_bytes": t["wire_bytes"]}
