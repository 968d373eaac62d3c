"""K5 (``kernels.blockwise_topk``) and ``kernels.ops.topk`` against the JAX
package's top-k.

On the CPU the K5 wrapper runs its plain torch twin. The reference's
Pallas K5 does not run under the installed jax (ROADMAP R1), so the twin
and ``ops.topk`` are held against the reference's jnp oracles:
``repro.kernels.ref.blockwise_topk_ref`` (per block),
``repro.core.retrieval.blockwise_topk`` (two-stage) and
``jax.lax.top_k``. Values must be equal exactly (selection does no
arithmetic). Positions are compared tie-aware: each returned position
holds its value and no position repeats; where values tie, the port's
order is position ascending, checked against a numpy lexsort. Cases: a
ragged ``n`` (not a multiple of the block), ``n <= block``, ``k`` of 1
and of the whole block, duplicates, rows of ``-inf`` and of
``-FLT_MAX``, and ``k > n``, which raises.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.core.retrieval import blockwise_topk as ref_blockwise  # noqa: E402
from repro.kernels.ref import blockwise_topk_ref  # noqa: E402

from repro_torch.core.retrieval import blockwise_topk  # noqa: E402
from repro_torch.kernels import blockwise_topk as k5  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

NEG = np.finfo(np.float32).min


def _order_oracle(x: np.ndarray, k: int):
    """(values, indices) of each row's top k, value desc then index asc."""
    n = x.shape[-1]
    idx = np.lexsort((np.broadcast_to(np.arange(n), x.shape), -x.astype(
        np.float64)), axis=-1)[..., :k]
    return np.take_along_axis(x, idx, -1), idx


def _check_positions(x, vals, idx):
    """Tie-aware: each position holds its value, none repeats."""
    np.testing.assert_array_equal(np.take_along_axis(x, idx, -1), vals)
    assert (np.diff(np.sort(idx, -1), axis=-1) != 0).all()


@pytest.mark.parametrize("n,block,k", [(4096, 512, 7), (8192, 1024, 50),
                                       (1024, 256, 1), (1024, 256, 256)])
def test_k5_twin_matches_reference_per_block(n, block, k):
    rng = np.random.default_rng(n + k)
    x = rng.normal(size=n).astype(np.float32)
    vals, pos = k5.blockwise_topk(torch.as_tensor(x)[None], k=k, block=block)
    rv, ri = blockwise_topk_ref(jnp.asarray(x), k=k, block=block)
    nb = n // block
    gidx = pos.numpy() + (np.arange(nb) * block)[:, None]
    np.testing.assert_array_equal(vals.numpy(), np.asarray(rv))
    np.testing.assert_array_equal(gidx, np.asarray(ri))
    assert k5.LAUNCHES.n == 0             # the twin is not a launch


@pytest.mark.parametrize("shape,block,k", [
    ((2, 4096), 512, 7),      # n a multiple of the block
    ((3, 5000), 1024, 50),    # ragged: last segment holds 904
    ((2, 4097), 4096, 100),   # ragged: last segment holds 1
    ((2, 700), 4096, 10),     # n <= block
    ((1, 300), 256, 256),     # k = block, ragged
    ((4, 256), 256, 1),       # k = 1, n = block
])
def test_topk_matches_lax_and_reference(shape, block, k):
    rng = np.random.default_rng(shape[1] + k)
    x = rng.normal(size=shape).astype(np.float32)
    vals, idx = ops.topk(torch.as_tensor(x), k, block=block)
    rv, ri = jax.lax.top_k(jnp.asarray(x), k)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(rv))
    _check_positions(x, vals.numpy(), idx.numpy().astype(np.int64))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ri))
    pi, pv = blockwise_topk(torch.as_tensor(x), k, block)
    np.testing.assert_array_equal(pv.numpy(), vals.numpy())
    np.testing.assert_array_equal(pi.numpy(), idx.numpy())
    if shape[1] % block == 0:
        ri2, rv2 = ref_blockwise(jnp.asarray(x), k, block)
        np.testing.assert_array_equal(np.asarray(rv2), vals.numpy())
        _check_positions(x, np.asarray(rv2), np.asarray(ri2))


def test_k5_takes_strided_rows():
    """A query-fastest ``[B, n]`` view (what a permuted dense block layout
    gives) ranks as its row-major copy does."""
    x = np.random.default_rng(9).normal(size=(8192, 3)).astype(np.float32)
    t = torch.as_tensor(x).T                   # [3, 8192], strides (1, 3)
    assert not t.is_contiguous()
    for a, b in zip(k5.blockwise_topk(t, k=9, block=4096),
                    k5.blockwise_topk(t.contiguous(), k=9, block=4096)):
        assert torch.equal(a, b)
    for a, b in zip(ops.topk(t, 9), ops.topk(t.contiguous(), 9)):
        assert torch.equal(a, b)


def test_topk_one_dimensional_input():
    x = np.random.default_rng(3).normal(size=9000).astype(np.float32)
    vals, idx = ops.topk(torch.as_tensor(x), 20, block=1024)
    assert vals.shape == (20,) and idx.shape == (20,)
    rv, ri = jax.lax.top_k(jnp.asarray(x), 20)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(rv))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ri))


@pytest.mark.parametrize("fill", [0.0, -np.inf, NEG])
@pytest.mark.parametrize("n,block,k", [(4096, 1024, 5), (4096, 512, 512),
                                       (3000, 1024, 1024), (500, 1024, 100)])
def test_topk_constant_rows_give_distinct_positions(fill, n, block, k):
    """The reference's own contract (``test_topk_with_duplicates``): equal
    entries give k distinct positions — also in rows of ``-inf`` or the
    float minimum, where masking by the minimum would repeat one."""
    x = np.full((2, n), fill, np.float32)
    x[1, ::7] = 1.0                       # a second row with a few winners
    vals, idx = ops.topk(torch.as_tensor(x), k, block=block)
    ov, oi = _order_oracle(x, k)
    np.testing.assert_array_equal(vals.numpy(), ov)
    np.testing.assert_array_equal(idx.numpy(), oi)
    _check_positions(x, vals.numpy(), idx.numpy().astype(np.int64))


@pytest.mark.parametrize("fill", [-np.inf, NEG])
def test_k5_twin_ragged_tail_is_absent(fill):
    """Positions past the row's end are never selected: a last segment
    shorter than k pads with (-inf, -1), whatever the row holds."""
    x = np.full((2, 1030), fill, np.float32)
    vals, pos = k5.blockwise_topk(torch.as_tensor(x), k=10, block=512)
    v, p = vals.view(2, 3, 10).numpy(), pos.view(2, 3, 10).numpy()
    np.testing.assert_array_equal(p[:, :2], np.broadcast_to(np.arange(10),
                                                            (2, 2, 10)))
    np.testing.assert_array_equal(p[:, 2], np.broadcast_to(
        [0, 1, 2, 3, 4, 5, -1, -1, -1, -1], (2, 10)))
    assert (v[:, 2, 6:] == -np.inf).all() and (v[:, :, :6] == fill).all()


def test_topk_mixed_ties_follow_index_order():
    rng = np.random.default_rng(11)
    x = rng.integers(-3, 4, size=(3, 9000)).astype(np.float32)
    x[0, rng.integers(0, 9000, 50)] = -np.inf
    x[2, :] = np.where(x[2] > 0, np.inf, x[2])
    vals, idx = ops.topk(torch.as_tensor(x), 300, block=1024)
    ov, oi = _order_oracle(x, 300)
    np.testing.assert_array_equal(vals.numpy(), ov)
    np.testing.assert_array_equal(idx.numpy(), oi)


def test_topk_k_larger_than_n_raises():
    x = torch.zeros((2, 100))
    with pytest.raises(ValueError):
        ops.topk(x, 101)
    with pytest.raises(ValueError):
        blockwise_topk(x, 101, 64)
    with pytest.raises(ValueError):
        k5.blockwise_topk(x, k=65, block=64)


def test_k5_rejects_bad_operands():
    with pytest.raises(TypeError):
        k5.blockwise_topk(torch.zeros((2, 64), dtype=torch.float64), k=1)
    with pytest.raises(ValueError):
        k5.blockwise_topk(torch.zeros(64), k=1)
    # a meta tensor (the dry run's trace) gets the outputs' shapes, and
    # is checked as any other operand
    v, i = k5.blockwise_topk(torch.zeros((2, 64), device="meta"), k=3,
                             block=16)
    assert v.shape == i.shape == (8, 3) and i.dtype == torch.int32
    assert v.device.type == i.device.type == "meta"
    with pytest.raises(TypeError):
        k5.blockwise_topk(torch.zeros((2, 64), dtype=torch.float64,
                                      device="meta"), k=1)
