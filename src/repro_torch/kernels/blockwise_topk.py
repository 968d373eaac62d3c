"""K5: per-segment top-k of a dense score matrix (stage 1 of ``ops.topk``).

Port of ``repro.kernels.blockwise_topk.blockwise_topk_kernel``. The CUDA
kernel is ``csrc/blockwise_topk.cu`` (its header note gives the design and
the bound); this module holds its wrapper, its plain torch twin and its
launch counter.

Contract: row ``r`` of ``x`` (``[R, n]`` f32 or bf16) is cut into ``nb =
ceil(n / block)`` segments of ``block`` entries; the last holds only the
``n - (nb - 1) · block`` entries that exist, and positions past them are
absent, never selected. Output row ``r · nb + j`` lists segment ``j``'s
best ``k`` entries in (value desc, position asc) order, as values ``[R·nb,
k]`` in ``x``'s dtype and segment-local positions ``[R·nb, k]`` i32
(a bf16 row is compared as its exact f32 widening); slots past a
segment's length hold ``(-inf, -1)``. With ``n == block`` this is the
reference's ``[nb, block] -> [nb, k]``. The positions of a segment are
always distinct, also in rows of ``-inf`` or ``-FLT_MAX``, where the
reference's mask-by-minimum can repeat one. ``+0.0`` and ``-0.0`` rank as
equal (the lower position first) and keep their own bits in the output,
as :func:`~repro_torch.core.retrieval.rank_order` ranks them. NaN input
is out of contract:
the BM25 paths never produce it and the serving ladder's finite check
covers boards, so the hot path does not look for it.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from ..core.retrieval import rank_order
from . import _build
from .meta import MetaOp

LAUNCHES = _build.LaunchCounter("blockwise_topk")
LAUNCHES_BF16 = _build.LaunchCounter("blockwise_topk_bf16")

_ENTRIES_PER_STEP = 1 << 24    # twin: segment entries ranked a step


def _check(x, k: int, block: int) -> None:
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be torch.float32 or torch.bfloat16, got "
                        f"{x.dtype}")
    if x.dim() != 2 or x.shape[1] < 1:
        raise ValueError(f"x must be [R, n] with n >= 1, got "
                         f"{tuple(x.shape)}")
    if not 1 <= k <= block:
        raise ValueError(f"need 1 <= k <= block, got k={k}, block={block}")


def blockwise_topk_plain(x, *, k: int, block: int | None = None
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's plain torch twin (same operands, same result).

    The ragged tail is padded with ``-inf`` at positions past the
    segment's length, which :func:`~repro_torch.core.retrieval.rank_order`
    puts after every real entry (equal value, larger position); each
    segment is ranked with one sort, cut to ``k``, and padding slots that
    reach the cut become ``(-inf, -1)``. Segments are ranked
    ``_ENTRIES_PER_STEP`` entries at a time to bound memory. A bf16 ``x``
    is ranked as its exact f32 widening (the order is kept) and the
    values come back bf16: the bf16 kernel's result.
    """
    block = x.shape[-1] if block is None else block
    _check(x, k, block)
    if x.dtype == torch.bfloat16:
        v, i = blockwise_topk_plain(x.float(), k=k, block=block)
        return v.to(torch.bfloat16), i
    r, n = x.shape
    nb = -(-n // block)
    seg = F.pad(x, (0, nb * block - n), value=float("-inf")).reshape(
        r * nb, block)
    pos = torch.arange(block, device=x.device).expand(seg.shape[0], block)
    tail = n - (nb - 1) * block         # entries of each row's last segment
    out_v = torch.empty((r * nb, k), dtype=torch.float32, device=x.device)
    out_i = torch.empty((r * nb, k), dtype=torch.int32, device=x.device)
    step = max(1, _ENTRIES_PER_STEP // block)
    for s0 in range(0, r * nb, step):
        s1 = min(r * nb, s0 + step)
        order = rank_order(seg[s0:s1], pos[s0:s1])[:, :k]
        out_v[s0:s1] = torch.gather(seg[s0:s1], 1, order)
        out_i[s0:s1] = order.to(torch.int32)
    last = out_i.view(r, nb, k)[:, -1]
    absent = last >= tail
    last.masked_fill_(absent, -1)
    out_v.view(r, nb, k)[:, -1].masked_fill_(absent, float("-inf"))
    return out_v, out_i


def _fake(x, k: int, block: int):
    r, n = x.shape
    nb = -(-n // block)
    return (x.new_empty((r * nb, k)),
            x.new_empty((r * nb, k), dtype=torch.int32))


def cost(x_shape, k: int, block: int) -> tuple[float, float]:
    """A call's (operations, bytes) for the dry run, by the reference's
    top-k rule (``repro/launch/costs.py``, so that the two dry runs
    compare): ``n · log2 n`` over the ``n`` entries of ``x``, and twice
    their bytes (``x_shape.itemsize`` bytes an entry where the trace
    gives it, else 4)."""
    n = float(math.prod(x_shape))
    size = getattr(x_shape, "itemsize", 4)
    return n * max(math.log2(max(n, 2.0)), 1.0), 2.0 * size * n


META = MetaOp("blockwise_topk",
              "(Tensor x, int k, int block) -> (Tensor, Tensor)", _fake,
              cost, compute_dtype="float32")


def _fn(lib, dtype=torch.float32):
    f = (lib.blockwise_topk_bf16_launch if dtype == torch.bfloat16
         else lib.blockwise_topk_launch)
    if f.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        f.argtypes = [p, ctypes.c_longlong, i, i, i, p, p, p]
        f.restype = ctypes.c_int
        s = lib.blockwise_topk_smem
        s.argtypes = [i, i]
        s.restype = ctypes.c_longlong
    return f


def blockwise_topk(x, *, k: int, block: int | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """``[R, n]`` f32 or bf16 → per-segment (values in ``x``'s dtype,
    i32 positions) ``[R·nb, k]``, descending, segments of ``block``
    entries (default ``n``).

    A CPU tensor runs the plain twin; a CUDA tensor launches the kernel
    of its dtype (and raises if it cannot): there is no fall-back between
    the two, and a bf16 row never goes through the f32 kernel. A ``meta``
    tensor (a trace) runs neither: :data:`META` gives the outputs'
    shapes.
    """
    block = x.shape[-1] if block is None else block
    _check(x, k, block)
    dev = x.device
    if dev.type == "cpu":
        return blockwise_topk_plain(x, k=k, block=block)
    if dev.type == "meta":
        return META(x, k, block)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    r, n = x.shape
    nb = -(-n // block)
    if r * nb >= 2 ** 31:
        raise ValueError(f"{r * nb} segments exceed the grid's 2^31 - 1")
    lib = _build.load("blockwise_topk")
    launch = _fn(lib, x.dtype)
    if lib.blockwise_topk_smem(block, k) > _build.SMEM_LIMIT - 1024:
        raise ValueError(f"block={block} with k={k} does not fit a CTA's "
                         "shared memory")
    xc = x.contiguous()
    out_v = torch.empty((r * nb, k), dtype=x.dtype, device=dev)
    out_i = torch.empty((r * nb, k), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = launch(xc.data_ptr(), r, n, block, k, out_v.data_ptr(),
                     out_i.data_ptr(), stream)
    _build.check(err, "blockwise_topk")
    (LAUNCHES_BF16 if x.dtype == torch.bfloat16 else LAUNCHES).add()
    return out_v, out_i
