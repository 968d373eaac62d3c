"""K7 and the segment reductions against the JAX package.

On the CPU the K7 wrapper (``kernels.block_segment_sum.block_segment_sum``)
runs its plain torch twin. These tests hold the twin, and
``kernels.ops.segment_sum_blocked`` built on it, against the live
reference kernel ``repro.kernels.block_segment_sum.block_segment_sum``
(Pallas in interpret mode, which runs under the installed jax) and its
oracle ``repro.kernels.ref.block_segment_sum_ref`` on the same seeded
inputs, at the reference test's tolerances: rtol/atol 1e-5 for f32 and
2e-2 for f16 (the reference sums f16 tiles in the f16 output, the port in
f32 and rounds once). Every function of ``sparse/segment_ops.py`` is held
against ``repro.sparse.segment_ops`` at 1e-6, sentinel and out-of-range
ids included.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro.kernels import ref  # noqa: E402
from repro.kernels.block_segment_sum import \
    block_segment_sum as ref_k7  # noqa: E402
from repro.sparse import segment_ops as ref_seg  # noqa: E402

from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import block_segment_sum as k7  # noqa: E402
from repro_torch.sparse import segment_ops as seg  # noqa: E402

TOL = {np.float32: 1e-5, np.float16: 2e-2}
SEG_TOL = 1e-6


def _inputs(rng, nb, p, d, s, dtype, drop=False):
    vals = rng.normal(size=(nb, p, d)).astype(dtype)
    ids = rng.integers(0, s, size=(nb, p)).astype(np.int32)
    if drop:                    # ids outside [0, S) add nothing
        ids[:, ::7] = -1
        ids[:, 3::11] = s
    return vals, ids


# the reference's sweep (tests/test_kernels.py), one with eight tiles a
# block, dropped ids in it, and one with 10,000 segments (the kernel cuts
# them into two ranges on the card)
@pytest.mark.parametrize("dtype", [np.float32, np.float16])
@pytest.mark.parametrize("nb,p,d,s,tile_p,drop", [
    (2, 128, 8, 16, 64, False), (4, 256, 32, 64, 128, False),
    (3, 512, 16, 40, 64, True), (1, 256, 8, 10_000, 128, True)])
def test_k7_twin_matches_live_reference_and_oracle(nb, p, d, s, tile_p,
                                                   drop, dtype):
    rng = np.random.default_rng(nb * p + d)
    vals, ids = _inputs(rng, nb, p, d, s, dtype, drop)
    want_k = np.asarray(ref_k7(jnp.asarray(vals), jnp.asarray(ids),
                               num_segments=s, tile_p=tile_p))
    want_o = np.asarray(ref.block_segment_sum_ref(
        jnp.asarray(vals), jnp.asarray(ids), num_segments=s))
    want_op = np.asarray(ref_ops.segment_sum_blocked(
        jnp.asarray(vals), jnp.asarray(ids), num_segments=s, tile_p=tile_p))
    vt, it = torch.as_tensor(vals), torch.as_tensor(ids)
    for got in (k7.block_segment_sum(vt, it, num_segments=s, tile_p=tile_p),
                ops.segment_sum_blocked(vt, it, num_segments=s,
                                        tile_p=tile_p)):
        assert got.dtype == vt.dtype and got.shape == (nb, s, d)
        for want in (want_k, want_o, want_op):
            np.testing.assert_allclose(got.float().numpy(),
                                       want.astype(np.float32),
                                       rtol=TOL[dtype], atol=TOL[dtype])


def test_k7_dropped_ids_add_nothing_and_pads_add_zero():
    rng = np.random.default_rng(3)
    vals, ids = _inputs(rng, 2, 64, 4, 8, np.float32)
    base = k7.block_segment_sum_plain(torch.as_tensor(vals),
                                      torch.as_tensor(ids), num_segments=8,
                                      tile_p=64)
    # postings of id -1 or S with any value, and zero-valued pads of id 0
    extra_v = rng.normal(size=(2, 64, 4)).astype(np.float32)
    extra_i = np.where(rng.random((2, 64)) < 0.5, -1, 8).astype(np.int32)
    extra_v[:, :16] = 0.0
    extra_i[:, :16] = 0
    got = k7.block_segment_sum(
        torch.as_tensor(np.concatenate([vals, extra_v], 1)),
        torch.as_tensor(np.concatenate([ids, extra_i], 1)), num_segments=8,
        tile_p=64)
    assert torch.equal(got, base)


def test_k7_twin_equals_segment_ops_block_by_block():
    """The twin is ``segment_sum`` of each block, bit for bit (the same
    serial ``index_add_`` order)."""
    rng = np.random.default_rng(5)
    vals, ids = _inputs(rng, 3, 128, 6, 20, np.float32, drop=True)
    vt, it = torch.as_tensor(vals), torch.as_tensor(ids)
    got = k7.block_segment_sum(vt, it, num_segments=20, tile_p=32)
    for b in range(3):
        assert torch.equal(got[b], seg.segment_sum(vt[b], it[b], 20))


@pytest.mark.parametrize("bad", [
    dict(tile_p=48), dict(tile_p=0), dict(num_segments=0)])
def test_k7_rejects_what_the_reference_asserts(bad):
    vt = torch.zeros((2, 64, 4))
    it = torch.zeros((2, 64), dtype=torch.int32)
    kw = dict(num_segments=8, tile_p=64) | bad
    with pytest.raises(ValueError):
        k7.block_segment_sum(vt, it, **kw)
    with pytest.raises(ValueError):
        ops.segment_sum_blocked(vt, it, **kw)


def test_k7_rejects_other_dtypes_and_shapes():
    it = torch.zeros((2, 64), dtype=torch.int32)
    with pytest.raises(TypeError):
        k7.block_segment_sum(torch.zeros((2, 64, 4), dtype=torch.float64),
                             it, num_segments=8, tile_p=64)
    with pytest.raises(TypeError):
        k7.block_segment_sum(torch.zeros((2, 64, 4)), it.long(),
                             num_segments=8, tile_p=64)
    with pytest.raises(ValueError):
        k7.block_segment_sum(torch.zeros((2, 32, 4)), it, num_segments=8,
                             tile_p=32)


@pytest.mark.parametrize("s", [16, 512, 3_000, 7_056, 7_057, 10_000,
                               100_000])
def test_k7_column_tile_fits_shared_memory(s):
    """The kernel's plan ``(d_tile, s_tile)``: ``D`` rounded up to a power
    of two within 8..64, narrowed until the ``[S, d_tile]`` accumulator
    fits a CTA; past 7,056 segments, 8 columns and the fewest equal
    segment ranges that fit. The ranges cover ``[0, S)`` disjointly and
    every CTA's shared memory fits."""
    room = _build.SMEM_LIMIT - 1024
    for d in (3, 20, 64, 602):
        d_tile, s_tile = k7.column_tile(s, d)
        n_ranges = -(-s // s_tile)
        starts = [r * s_tile for r in range(n_ranges)]
        ends = [min(s, a + s_tile) for a in starts]
        assert starts[0] == 0 and ends[-1] == s
        assert all(e == a for e, a in zip(ends, starts[1:]))   # disjoint
        assert all(e > a for a, e in zip(starts, ends))          # non-empty
        assert k7.smem_bytes(s_tile, d_tile) <= room
        want = max(8, 1 << max(0, d - 1).bit_length())
        assert d_tile <= want and d_tile in (8, 16, 32, 64)
        if s_tile < s:                 # split only where 8 columns fail
            assert d_tile == 8 and k7.smem_bytes(s, 8) > room
            assert k7.smem_bytes(-(-s // (n_ranges - 1)), 8) > room
    assert k7.column_tile(512, 64) == (64, 512)   # 165,376 bytes a CTA
    assert k7.column_tile(512, 602) == (64, 512)  # ten column tiles
    assert k7.column_tile(512, 20) == (32, 512)
    assert k7.column_tile(16, 3) == (8, 16)
    assert k7.column_tile(2048, 64) == (16, 2048)
    assert k7.column_tile(7_056, 64) == (8, 7_056)
    assert k7.column_tile(10_000, 64) == (8, 5_000)
    assert k7.column_tile(50_000, 64) == (8, 6_250)
    assert k7.smem_bytes(512, 64) == 165_376
    with pytest.raises(ValueError):
        k7.column_tile(2 ** 31, 64)


# (values address, P, D, S, element bytes) -> the kernel's route: stages of
# the TMA ring, or 0 for the staged path
@pytest.mark.parametrize("ptr,p,d,s,elt,want", [
    (0, 38_912, 64, 512, 4, 5),       # ogb_products: 5 stages of 16 KB
    (256, 1, 64, 512, 4, 5),          # any P while P * D * elt % 16 == 0
    (0, 63, 64, 512, 4, 5), (0, 65, 64, 512, 4, 5),
    (0, 96, 20, 40, 4, 8),            # D = 20: rows of 80 bytes, d_tile 32
    (0, 64, 1, 16, 4, 8),             # D = 1: P % 4 == 0
    (0, 63, 1, 16, 4, 0),             # D = 1, P * 4 not a multiple of 16
    (0, 96, 64, 512, 2, 8),           # f16: 8 KB stages, 8 of them
    (0, 33, 3, 16, 2, 0),             # f16, P * D odd
    (4, 128, 64, 512, 4, 0),          # an odd storage offset: not 16-aligned
    (8, 128, 64, 512, 4, 0),
    (0, 64, 16, 2_048, 4, 8),
    (0, 64, 8, 7_056, 4, 2),          # the widest S at 8 columns: 2 stages
    (0, 512, 64, 3_000, 4, 0),        # d_tile 16 < D: rows strided
    (0, 768, 200, 64, 4, 0),          # D > 64: four D-tiles
    (0, 512, 64, 10_000, 4, 0),       # S split into ranges
    (0, 256, 20, 50_000, 4, 0),
])
def test_k7_ring_route_and_stages(ptr, p, d, s, elt, want):
    """The ring takes a block a CTA (``column_tile`` gives ``d_tile >= D``
    and ``s_tile == S``) whose postings are 16-byte aligned runs (a
    16-byte aligned base and ``P * D * elt % 16 == 0``); every stage that
    fits beside the accumulator, 2 to 8. Every other plan is staged."""
    stages = k7.ring_stages(ptr, p, d, s, elt)
    assert stages == want
    if stages:
        d_tile, s_tile = k7.column_tile(s, d)
        assert d_tile >= d and s_tile == s
        room = _build.SMEM_LIMIT - 1024
        assert k7.ring_smem_bytes(s, d_tile, d, elt, stages) <= room
        if stages < 8:              # one more stage would not fit
            assert k7.ring_smem_bytes(s, d_tile, d, elt, stages + 1) > room


def test_k7_ring_smem_layout():
    """The ring CTA's shared memory: the ``[S, d_tile]`` f32 accumulator,
    then a stage of ``[64, D]`` values, 64 ids, 64 flags and three 8-byte
    mbarriers each (``csrc: block_segment_sum_ring_smem``)."""
    assert k7.ring_smem_bytes(512, 64, 64, 4, 5) == (
        131_072 + 5 * (16_384 + 256 + 256 + 24))
    assert k7.ring_smem_bytes(512, 64, 64, 4, 0) == 131_072
    assert k7.ring_smem_bytes(40, 32, 20, 2, 1) == 40 * 32 * 4 + 64 * 40 + 536


# -- sparse/segment_ops.py against repro.sparse.segment_ops ----------------

def _seg_inputs(rng, n=200, s=17, tail=(5,)):
    vals = rng.normal(size=(n, *tail)).astype(np.float32)
    ids = rng.integers(0, s, size=n).astype(np.int32)
    ids[::9] = s                        # the sentinel: dropped
    ids[4::23] = -1                     # out of range: dropped
    ids[6::31] = s + 3
    return vals, ids


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=SEG_TOL, atol=SEG_TOL)


@pytest.mark.parametrize("tail", [(), (5,), (2, 3)])
@pytest.mark.parametrize("fn", ["segment_sum", "segment_mean",
                                "segment_max",
                                "one_hot_matmul_segment_sum"])
def test_segment_reductions_match_reference(fn, tail):
    rng = np.random.default_rng(len(tail) + len(fn))
    vals, ids = _seg_inputs(rng, tail=tail)
    if fn == "one_hot_matmul_segment_sum":
        ids = np.clip(ids, -1, 17)      # the one-hot form: no sentinel row
    got = getattr(seg, fn)(torch.as_tensor(vals), torch.as_tensor(ids), 17)
    want = getattr(ref_seg, fn)(jnp.asarray(vals), jnp.asarray(ids), 17)
    _close(got, want)


def test_segment_max_of_an_empty_segment_is_minus_inf():
    vals = torch.tensor([1.0, 2.0, 3.0])
    ids = torch.tensor([0, 0, 3], dtype=torch.int32)
    got = seg.segment_max(vals, ids, 3)
    want = np.asarray(ref_seg.segment_max(jnp.asarray(vals.numpy()),
                                          jnp.asarray(ids.numpy()), 3))
    assert np.array_equal(got.numpy(), want)
    assert got[1] == float("-inf") and got[2] == float("-inf")
    ints = seg.segment_max(torch.tensor([1, 2], dtype=torch.int32),
                           torch.tensor([0, 5], dtype=torch.int32), 2)
    assert ints.tolist() == [1, torch.iinfo(torch.int32).min]


def test_segment_softmax_matches_reference_with_sentinel_ids():
    rng = np.random.default_rng(11)
    logits, ids = _seg_inputs(rng, tail=())
    got = seg.segment_softmax(torch.as_tensor(logits), torch.as_tensor(ids),
                              17)
    want = ref_seg.segment_softmax(jnp.asarray(logits), jnp.asarray(ids), 17)
    _close(got, want)


@pytest.mark.parametrize("tail", [(), (4,)])
def test_scatter_add_drops_like_mode_drop(tail):
    rng = np.random.default_rng(13)
    acc = rng.normal(size=(10, *tail)).astype(np.float32)
    idx = rng.integers(-14, 14, size=60).astype(np.int32)
    vals = rng.normal(size=(60, *tail)).astype(np.float32)
    before = acc.copy()
    got = seg.scatter_add(torch.as_tensor(acc), torch.as_tensor(idx),
                          torch.as_tensor(vals))
    want = ref_seg.scatter_add(jnp.asarray(before), jnp.asarray(idx),
                               jnp.asarray(vals))
    _close(got, want)
    assert np.array_equal(acc, before)          # the input is not written
