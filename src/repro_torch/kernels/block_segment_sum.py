"""K7: blocked segment sum (the sparse substrate's per-block scatter-add).

Port of ``repro.kernels.block_segment_sum.block_segment_sum``. The CUDA
kernel is ``csrc/block_segment_sum.cu`` (its header note gives the design
and the bound); this module holds its wrapper, its plain torch twin and
its launch counter.

Contract: ``values`` ``[nb, P, D]`` (f32 or f16) and local ids
``segment_ids`` ``[nb, P]`` (i32) give ``out[b, s] = Σ values[b, p]`` over
the postings ``p`` of block ``b`` with ``segment_ids[b, p] == s``, for
``s < num_segments``, as ``[nb, num_segments, D]`` in the values' dtype.
An id outside ``[0, num_segments)`` adds nothing (the reference's one-hot
row of such an id is all zeros). Sums run in posting order in f32 and are
rounded once to the output dtype: for f16 the reference accumulates in
the f16 output tile by tile, so the two agree within its test's 2e-2.
The reference's precondition ``P % tile_p == 0`` is kept as a
``ValueError``; the kernel itself takes any ``P`` and any ``S`` (past
7,056 segments a block's CTAs split ``S`` into ranges, :func:`column_tile`).
Where one CTA holds a whole block and the bulk copy's alignment holds,
the postings stream through a TMA ring (:func:`ring_stages`); every other
plan takes the staged path.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

LAUNCHES = _build.LaunchCounter("block_segment_sum")

_DTYPES = {torch.float32: 0, torch.float16: 1}
_CHUNK = 128                # postings staged a step (csrc: kChunk)
_D_TILES = (64, 32, 16, 8)  # the kernel's instantiated column tiles
_RING_N = 64                # postings a ring stage holds (csrc: kRingN)
_RING_MAX_STAGES = 8        # csrc: kRingMaxStages


def _check(values, segment_ids, num_segments: int, tile_p: int) -> None:
    if values.dtype not in _DTYPES:
        raise TypeError(f"values must be float32 or float16, got "
                        f"{values.dtype}")
    if segment_ids.dtype != torch.int32:
        raise TypeError(f"segment_ids must be torch.int32, got "
                        f"{segment_ids.dtype}")
    if values.dim() != 3 or tuple(segment_ids.shape) != tuple(
            values.shape[:2]):
        raise ValueError(f"need values [nb, P, D] and segment_ids [nb, P], "
                         f"got {tuple(values.shape)} and "
                         f"{tuple(segment_ids.shape)}")
    if segment_ids.device != values.device:
        raise ValueError("values and segment_ids must share a device")
    if num_segments < 1:
        raise ValueError(f"num_segments must be >= 1, got {num_segments}")
    if tile_p < 1 or values.shape[1] % tile_p:
        raise ValueError(f"P={values.shape[1]} must be a multiple of "
                         f"tile_p={tile_p}")


def smem_bytes(s_tile: int, d_tile: int) -> int:
    """Shared memory of one CTA: the ``[s_tile, d_tile]`` f32 accumulator,
    the staged ``[128, d_tile]`` tile, its 128 ids and two buffers of 128
    row flags (csrc: ``block_segment_sum_smem``)."""
    return (s_tile * d_tile + _CHUNK * d_tile + 3 * _CHUNK) * 4


def column_tile(num_segments: int, d: int) -> tuple[int, int]:
    """The kernel's tile plan ``(d_tile, s_tile)``: a CTA holds the
    ``[s_tile, d_tile]`` accumulator of one block's segments ``[s0, s0 +
    s_tile)`` and columns ``[d0, d0 + d_tile)``.

    ``d_tile`` is at most ``D`` rounded up to a power of two and at least
    8. The plan takes the widest ``d_tile`` whose accumulator holds all
    ``S`` segments (``s_tile = S``). Where none does (``S`` > 7,056), every
    CTA of a block still reads all of its postings, so the plan takes the
    fewest segment ranges, which 8 columns give, and cuts ``S`` into equal
    ranges. Raises ``ValueError`` for ``S >= 2^31`` or ``S < 1``.
    """
    if not 1 <= num_segments < 2 ** 31:
        raise ValueError(f"num_segments={num_segments} must be in "
                         f"[1, 2^31)")
    want = max(8, 1 << max(0, d - 1).bit_length())
    room = _build.SMEM_LIMIT - 1024
    for t in _D_TILES:
        if t <= want and smem_bytes(num_segments, t) <= room:
            return t, num_segments
    t = _D_TILES[-1]
    most = (room // 4 - _CHUNK * t - 3 * _CHUNK) // t
    n_ranges = -(-num_segments // most)
    return t, -(-num_segments // n_ranges)


def ring_smem_bytes(num_segments: int, d_tile: int, d: int, elt: int,
                    stages: int) -> int:
    """Shared memory of one ring CTA: the ``[S, d_tile]`` f32 accumulator
    and, a stage, ``[64, D]`` values, 64 ids, 64 row flags and three
    mbarriers (csrc: ``block_segment_sum_ring_smem``)."""
    return (num_segments * d_tile * 4
            + stages * (_RING_N * d * elt + 2 * _RING_N * 4 + 3 * 8))


def ring_stages(values_ptr: int, p: int, d: int, num_segments: int,
                elt: int) -> int:
    """Stages of the kernel's TMA ring, or 0 where the plan takes the
    staged path.

    The ring needs one CTA to hold a block's ``S`` segments and ``D``
    columns (:func:`column_tile` gives ``d_tile >= D`` and ``s_tile ==
    S``), so that postings ``[p0, p0 + n)`` are one contiguous run of
    bytes; and the bulk copy needs every run to start 16-byte aligned and
    to be a multiple of 16 bytes long: a 16-byte aligned ``values`` and
    ``P * D * elt % 16 == 0`` (a stage of 64 postings is always a multiple
    of 16 bytes). It takes as many 64-posting stages as fit beside the
    accumulator, at most 8, and at least 2.
    """
    d_tile, s_tile = column_tile(num_segments, d)
    if d_tile < d or s_tile < num_segments:
        return 0
    if values_ptr % 16 or (p * d * elt) % 16:
        return 0
    room = _build.SMEM_LIMIT - 1024 - ring_smem_bytes(num_segments, d_tile,
                                                      d, elt, 0)
    stages = min(_RING_MAX_STAGES, room // ring_smem_bytes(0, d_tile, d,
                                                           elt, 1))
    return stages if stages >= 2 else 0


def block_segment_sum_plain(values, segment_ids, *, num_segments: int,
                            tile_p: int = 512) -> torch.Tensor:
    """The kernel's plain torch twin (same operands, same result).

    Each block gets a sentinel row ``num_segments`` that takes every
    out-of-range id and is cut off; one ``index_add_`` in f32 over the
    flattened blocks adds the postings in order (serially on the CPU,
    where the result equals the kernel's bit for bit), and the sums are
    rounded once to the values' dtype.
    """
    _check(values, segment_ids, num_segments, tile_p)
    nb, _, d = values.shape
    s = num_segments
    ids = segment_ids.long()
    ids = torch.where((ids >= 0) & (ids < s), ids, s)
    gid = (ids + torch.arange(nb, device=ids.device)[:, None] * (s + 1))
    acc = torch.zeros((nb * (s + 1), d), dtype=torch.float32,
                      device=values.device)
    acc.index_add_(0, gid.reshape(-1), values.reshape(-1, d).float())
    return acc.view(nb, s + 1, d)[:, :s].to(values.dtype).contiguous()


def _fns(lib):
    staged = lib.block_segment_sum_launch
    ring = lib.block_segment_sum_ring_launch
    if staged.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        staged.argtypes = [p, p, p, ll, i, i, i, i, i, i, p]
        staged.restype = ctypes.c_int
        ring.argtypes = [p, p, p, ll, i, i, i, i, i, i, p]
        ring.restype = ctypes.c_int
        lib.block_segment_sum_smem.argtypes = [i, i]
        lib.block_segment_sum_smem.restype = ll
        lib.block_segment_sum_ring_smem.argtypes = [i, i, i, i, i]
        lib.block_segment_sum_ring_smem.restype = ll
    return staged, ring


def block_segment_sum(values, segment_ids, *, num_segments: int,
                      tile_p: int = 512) -> torch.Tensor:
    """``[nb, P, D]`` values + ``[nb, P]`` local ids -> ``[nb,
    num_segments, D]`` per-block sums.

    A CPU tensor runs the plain twin; a CUDA tensor launches the kernel
    (and raises if it cannot): there is no fall-back between the two.
    """
    _check(values, segment_ids, num_segments, tile_p)
    dev = values.device
    if dev.type == "cpu":
        return block_segment_sum_plain(values, segment_ids,
                                       num_segments=num_segments,
                                       tile_p=tile_p)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    nb, p, d = values.shape
    out = torch.empty((nb, num_segments, d), dtype=values.dtype, device=dev)
    if nb == 0 or d == 0:
        return out
    d_tile, s_tile = column_tile(num_segments, d)
    ctas = nb * -(-d // d_tile) * -(-num_segments // s_tile)
    if ctas >= 2 ** 31 or p >= 2 ** 31:
        raise ValueError(f"{nb} blocks of {p} postings exceed the grid")
    lib = _build.load("block_segment_sum")
    staged, ring = _fns(lib)
    vc, ic = values.contiguous(), segment_ids.contiguous()
    elt = vc.element_size()
    stages = ring_stages(vc.data_ptr(), p, d, num_segments, elt)
    want = (ring_smem_bytes(num_segments, d_tile, d, elt, stages) if stages
            else smem_bytes(s_tile, d_tile))
    got = (lib.block_segment_sum_ring_smem(num_segments, d_tile, d, elt,
                                           stages) if stages
           else lib.block_segment_sum_smem(s_tile, d_tile))
    if got != want:
        raise RuntimeError("block_segment_sum: the library's shared memory "
                           "layout differs from the wrapper's")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if stages:
            err = ring(vc.data_ptr(), ic.data_ptr(), out.data_ptr(), nb, p, d,
                       num_segments, d_tile, stages, _DTYPES[values.dtype],
                       stream)
        else:
            err = staged(vc.data_ptr(), ic.data_ptr(), out.data_ptr(), nb, p,
                         d, num_segments, d_tile, s_tile,
                         _DTYPES[values.dtype], stream)
    _build.check(err, "block_segment_sum")
    LAUNCHES.add()
    return out
