"""The kernels as ops that a trace on ``meta`` tensors sees.

A kernel wrapper called with ``meta`` tensors runs neither its CUDA kernel
nor its plain twin: it calls its :class:`MetaOp`, an op of the
``repro_torch`` library whose only implementation is a ``Meta`` kernel
giving the outputs' shapes and dtypes. A ``TorchDispatchMode`` (the dry
run's cost counter, ``launch/costs.py``) then sees the kernel as one op,
and reads its cost from :data:`COSTS`; ``torch.utils.flop_counter``'s
``FlopCounterMode`` reads the same FLOPs through
``register_flop_formula``. Each kernel module writes its fake and its cost
formula beside its wrapper. The op is registered at the first ``meta``
call, never at import.
"""

from __future__ import annotations

import threading
from typing import Callable

import torch

# op overload packet -> cost(*shapes and ints of the op's arguments) ->
# (flops, bytes); tensors are passed as their shapes (``launch.costs.Shape``:
# a tuple whose ``itemsize`` is the element's bytes)
COSTS: dict = {}
# op overload packet -> the dtype (by name) its arithmetic runs in, where
# that is not its first floating-point input's (the bf16 instantiations of
# K5 and K6 compare and sum in f32)
COMPUTE_DTYPES: dict = {}

_lock = threading.Lock()


class MetaOp:
    """``torch.ops.repro_torch.<name>``, defined by ``schema`` (the
    arguments and results, e.g. ``"(Tensor x, int k) -> Tensor"``), with
    ``fake`` as its ``Meta`` kernel and ``cost`` as its cost formula;
    ``compute_dtype`` names the dtype its arithmetic runs in where that is
    not its first floating-point input's."""

    def __init__(self, name: str, schema: str, fake: Callable,
                 cost: Callable, compute_dtype: str | None = None):
        self.name, self.schema, self.fake, self.cost = (name, schema, fake,
                                                        cost)
        self.compute_dtype = compute_dtype
        self._lib = None

    def op(self):
        """The op's overload packet, registered on the first call."""
        with _lock:
            if self._lib is None:
                from torch.utils.flop_counter import register_flop_formula

                lib = torch.library.Library("repro_torch", "FRAGMENT")
                lib.define(self.name + self.schema)
                lib.impl(self.name, self.fake, "Meta")
                packet = getattr(torch.ops.repro_torch, self.name)
                cost = self.cost

                def flops(*args, out_shape=None, **kwargs):
                    return cost(*args, **kwargs)[0]

                register_flop_formula(packet)(flops)
                COSTS[packet] = cost
                if self.compute_dtype is not None:
                    COMPUTE_DTYPES[packet] = self.compute_dtype
                self._lib = lib          # keeps the registration alive
        return getattr(torch.ops.repro_torch, self.name)

    def __call__(self, *args):
        return self.op()(*args)
