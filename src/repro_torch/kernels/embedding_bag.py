"""K8: EmbeddingBag, the weighted gather-and-sum of table rows.

Port of ``repro.kernels.embedding_bag.embedding_bag_kernel``. The CUDA
kernel is ``csrc/embedding_bag.cu`` (its header note gives the design and
the bound); this module holds its wrapper, its plain torch twin and its
launch counter.

Contract: a ``[V, D]`` f32 table, ``[B, F]`` i32 indices (``-1`` = pad)
and ``[B, F]`` f32 weights give ``out[b] = Σ_f weights[b, f] ·
table[indices[b, f]]`` over the valid slots in fanout order, ``[B, D]``
f32, each product and sum rounded separately. A pad is skipped; the
reference multiplies row 0 by 0 instead, which gives the same sums for a
finite table (a row 0 holding inf or NaN is out of contract). Indices
must lie in ``[-1, V)``: the twin raises outside that range, the kernel
does not check (a check would cost a synchronisation).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

LAUNCHES = _build.LaunchCounter("embedding_bag")


def _check(table, indices, weights) -> None:
    if table.dtype != torch.float32 or weights.dtype != torch.float32:
        raise TypeError(f"table and weights must be torch.float32, got "
                        f"{table.dtype} and {weights.dtype}")
    if indices.dtype != torch.int32:
        raise TypeError(f"indices must be torch.int32, got {indices.dtype}")
    if (table.dim() != 2 or indices.dim() != 2
            or weights.shape != indices.shape):
        raise ValueError(f"need table [V, D], indices and weights [B, F], "
                         f"got {tuple(table.shape)}, "
                         f"{tuple(indices.shape)}, {tuple(weights.shape)}")
    if not table.device == indices.device == weights.device:
        raise ValueError("table, indices and weights must share a device")


def embedding_bag_plain(table, indices, weights) -> torch.Tensor:
    """The kernel's plain torch twin (same operands, same result): one
    row gather, product and add a fanout slot, in fanout order, a pad
    leaving the sum as it was. Raises ``IndexError`` for an index outside
    ``[-1, V)``."""
    _check(table, indices, weights)
    if indices.numel() and (int(indices.min()) < -1
                            or int(indices.max()) >= table.shape[0]):
        raise IndexError(f"indices must lie in [-1, {table.shape[0]})")
    b, f = indices.shape
    valid = indices >= 0
    safe = torch.where(valid, indices, 0).long()
    out = torch.zeros((b, table.shape[1]), dtype=torch.float32,
                      device=table.device)
    for j in range(f):
        term = table[safe[:, j]] * weights[:, j, None]
        out = torch.where(valid[:, j, None], out + term, out)
    return out


def load_width(table_ptr: int, out_ptr: int, d: int) -> int:
    """Floats a lane of the kernel loads at once (its template ``W``): 4
    (16-byte loads) where the table and the output both start 16-byte
    aligned and ``D % 4 == 0``, 2 where both start 8-byte aligned and
    ``D`` is even, else 1. Every row then starts as aligned as its base,
    so the kernel assumes nothing the wrapper did not check."""
    if table_ptr % 16 == 0 and out_ptr % 16 == 0 and d % 4 == 0:
        return 4
    if table_ptr % 8 == 0 and out_ptr % 8 == 0 and d % 2 == 0:
        return 2
    return 1


def column_slices(d: int, width: int) -> int:
    """Warps a bag takes: one a slice of ``32 * width`` columns (a float
    or a vector of ``width`` a lane), the last one partial."""
    return -(-d // (32 * width))


def _fn(lib):
    f = lib.embedding_bag_launch
    if f.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        f.argtypes = [p, p, p, p, ctypes.c_longlong, i, i, i, p]
        f.restype = ctypes.c_int
    return f


def embedding_bag(table, indices, weights) -> torch.Tensor:
    """``[V, D]`` table + ``[B, F]`` indices (``-1`` pad) + ``[B, F]``
    weights -> ``[B, D]`` weighted bag sums.

    A CPU tensor runs the plain twin; a CUDA tensor launches the kernel
    (and raises if it cannot): there is no fall-back between the two.
    """
    _check(table, indices, weights)
    dev = table.device
    if dev.type == "cpu":
        return embedding_bag_plain(table, indices, weights)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    b, f = indices.shape
    d = table.shape[1]
    out = torch.empty((b, d), dtype=torch.float32, device=dev)
    if b == 0 or d == 0:
        return out
    tc, ic, wc = table.contiguous(), indices.contiguous(), weights.contiguous()
    width = load_width(tc.data_ptr(), out.data_ptr(), d)
    if -(-b * column_slices(d, width) // 8) >= 2 ** 31:
        raise ValueError(f"{b} bags of {d} columns exceed the grid")
    launch = _fn(_build.load("embedding_bag"))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = launch(tc.data_ptr(), ic.data_ptr(), wc.data_ptr(),
                     out.data_ptr(), b, f, d, width, stream)
    _build.check(err, "embedding_bag")
    LAUNCHES.add()
    return out
