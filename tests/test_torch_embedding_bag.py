"""K8 and the embedding-bag substrate against the JAX package.

On the CPU the K8 wrapper (``kernels.embedding_bag.embedding_bag``) runs
its plain torch twin. These tests hold the twin, and
``kernels.ops.embedding_bag`` built on it, against the live reference
kernel ``repro.kernels.embedding_bag.embedding_bag_kernel`` (Pallas in
interpret mode, which runs under the installed jax), the reference's
``ops.embedding_bag`` and its oracle ``ref.embedding_bag_ref`` on the same
seeded inputs, at the reference test's rtol/atol 1e-4. The jnp substrate
``sparse/embedding_bag.py`` (three combiners, two lookups) is held against
``repro.sparse.embedding_bag`` at 1e-5.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro.kernels import ref  # noqa: E402
from repro.kernels.embedding_bag import \
    embedding_bag_kernel as ref_k8  # noqa: E402
from repro.sparse import embedding_bag as ref_eb  # noqa: E402

from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.embedding_bag import (  # noqa: E402
    column_slices, embedding_bag as k8, embedding_bag_plain, load_width)
from repro_torch.sparse import embedding_bag as eb  # noqa: E402

TOL = 1e-4
SUB_TOL = 1e-5


def _bags(rng, v, d, b, f):
    table = rng.normal(size=(v, d)).astype(np.float32)
    idx = rng.integers(-1, v, size=(b, f)).astype(np.int32)
    w = rng.normal(size=(b, f)).astype(np.float32)
    return table, idx, w


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol)


# the reference's sweep (tests/test_kernels.py)
@pytest.mark.parametrize("v,d,b,f,tile_b", [
    (100, 16, 32, 4, 16), (500, 64, 64, 9, 32)])
def test_k8_twin_matches_live_reference_and_oracle(v, d, b, f, tile_b):
    rng = np.random.default_rng(v + f)
    table, idx, w = _bags(rng, v, d, b, f)
    jt, ji, jw = jnp.asarray(table), jnp.asarray(idx), jnp.asarray(w)
    wants = (ref_k8(jt, ji, jw, tile_b=tile_b),
             ref.embedding_bag_ref(jt, ji, jw),
             ref_ops.embedding_bag(jt, ji, jw, tile_b=tile_b))
    tt, it, wt = (torch.as_tensor(a) for a in (table, idx, w))
    for got in (k8(tt, it, wt), ops.embedding_bag(tt, it, wt, tile_b=tile_b)):
        assert got.shape == (b, d) and got.dtype == torch.float32
        for want in wants:
            _close(got, want)


def test_k8_any_batch_and_default_weights():
    """B = 13 with ``tile_b`` = 8: the reference pads B to 16 and cuts the
    result; the port takes any B. ``weights=None`` means ones."""
    rng = np.random.default_rng(7)
    table = rng.normal(size=(50, 8)).astype(np.float32)
    idx = rng.integers(0, 50, size=(13, 3)).astype(np.int32)
    idx[2, 1] = -1
    want = ref_ops.embedding_bag(jnp.asarray(table), jnp.asarray(idx),
                                 tile_b=8)
    got = ops.embedding_bag(torch.as_tensor(table), torch.as_tensor(idx),
                            tile_b=8)
    _close(got, want, 1e-5)
    ones = embedding_bag_plain(torch.as_tensor(table), torch.as_tensor(idx),
                               torch.ones((13, 3)))
    assert torch.equal(got, ones)
    with pytest.raises(ValueError, match="tile_b"):
        ops.embedding_bag(torch.as_tensor(table), torch.as_tensor(idx),
                          tile_b=0)


def test_k8_all_pad_bags_give_zero_and_pads_are_skipped():
    rng = np.random.default_rng(9)
    table, idx, w = _bags(rng, 30, 5, 6, 4)
    idx[1] = -1
    idx[4] = -1
    got = k8(*(torch.as_tensor(a) for a in (table, idx, w)))
    assert torch.equal(got[1], torch.zeros(5))
    assert torch.equal(got[4], torch.zeros(5))
    # a pad is skipped: row 0 never enters a bag through one, even when it
    # is not finite (out of the reference's contract, where 0 * inf = NaN)
    table[0] = np.inf
    idx[idx == 0] = 1
    got_inf = k8(*(torch.as_tensor(a) for a in (table, idx, w)))
    assert torch.isfinite(got_inf).all()
    _close(got_inf, ref.embedding_bag_ref(
        jnp.asarray(np.where(np.isinf(table), 0, table)), jnp.asarray(idx),
        jnp.asarray(w)))


def test_k8_reddit_width():
    """D = 602 (Reddit's features): a row starts only 8-byte aligned."""
    rng = np.random.default_rng(602)
    table, idx, w = _bags(rng, 300, 602, 24, 10)
    jt, ji, jw = jnp.asarray(table), jnp.asarray(idx), jnp.asarray(w)
    got = ops.embedding_bag(*(torch.as_tensor(a) for a in (table, idx, w)))
    _close(got, ref.embedding_bag_ref(jt, ji, jw))
    _close(got, ref_k8(jt, ji, jw, tile_b=8))


def test_k8_twin_is_fanout_ordered_product_then_sum():
    """The twin rounds each product and each sum, in fanout order: the
    exact arithmetic the kernel does with ``__fmul_rn`` / ``__fadd_rn``."""
    rng = np.random.default_rng(21)
    table, idx, w = _bags(rng, 40, 7, 9, 6)
    got = k8(*(torch.as_tensor(a) for a in (table, idx, w))).numpy()
    want = np.zeros((9, 7), np.float32)
    for b in range(9):
        for f in range(6):
            if idx[b, f] >= 0:
                want[b] = want[b] + np.float32(w[b, f]) * table[idx[b, f]]
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("bad", [-2, 40])
def test_k8_twin_raises_outside_the_index_range(bad):
    table = torch.zeros((40, 3))
    idx = torch.zeros((2, 2), dtype=torch.int32)
    idx[1, 1] = bad
    with pytest.raises(IndexError):
        k8(table, idx, torch.ones((2, 2)))


def test_k8_rejects_other_dtypes_and_shapes():
    table = torch.zeros((10, 3))
    idx = torch.zeros((2, 2), dtype=torch.int32)
    w = torch.ones((2, 2))
    with pytest.raises(TypeError):
        k8(table.double(), idx, w)
    with pytest.raises(TypeError):
        k8(table, idx.long(), w)
    with pytest.raises(ValueError):
        k8(table, idx, torch.ones((2, 3)))


# (table address, output address, D) -> floats a lane loads at once
@pytest.mark.parametrize("table_ptr,out_ptr,d,want", [
    (0, 0, 1024, 4), (0, 0, 4, 4),
    (0, 0, 602, 2),                   # Reddit: rows 8-byte aligned
    (8, 0, 1024, 2),                  # an 8-byte aligned view
    (0, 8, 1024, 2),
    (4, 0, 602, 1),                   # first row only 4-byte aligned
    (0, 4, 602, 1),
    (0, 0, 601, 1), (0, 0, 3, 1), (0, 0, 1, 1),
    (0, 0, 2, 2), (16, 32, 6, 2),
])
def test_k8_load_width(table_ptr, out_ptr, d, want):
    """16-byte loads only where both bases are 16-byte aligned and ``D %
    4 == 0``; 8-byte where both are 8-byte aligned and ``D`` is even;
    4-byte otherwise. The width then divides ``D`` and keeps every row as
    aligned as its base."""
    w = load_width(table_ptr, out_ptr, d)
    assert w == want
    assert d % w == 0
    assert (table_ptr + 4 * d) % (4 * w) == 0 and out_ptr % (4 * w) == 0


@pytest.mark.parametrize("d,width,want", [
    (602, 2, 10), (1024, 4, 8), (1, 1, 1), (32, 1, 1), (33, 1, 2),
    (601, 1, 19), (64, 2, 1), (65, 1, 3), (128, 4, 1), (132, 4, 2)])
def test_k8_column_slices(d, width, want):
    """A warp takes a bag's slice of ``32 * width`` columns; the slices
    cover ``D`` and only the last is partial. At hop-1 (1,024 bags, D =
    602) that is 10,240 warps, ten times a warp a bag."""
    n = column_slices(d, width)
    assert n == want
    assert (n - 1) * 32 * width < d <= n * 32 * width


# -- sparse/embedding_bag.py against repro.sparse.embedding_bag ------------

@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("combiner", ["sum", "mean", "max"])
@pytest.mark.parametrize("lead", [(12,), (3, 4)])
def test_embedding_bag_combiners_match_reference(combiner, weighted, lead):
    rng = np.random.default_rng(len(lead) * 10 + weighted)
    table = rng.normal(size=(60, 6)).astype(np.float32)
    idx = rng.integers(-1, 60, size=(*lead, 5)).astype(np.int32)
    idx.reshape(-1, 5)[0] = -1                  # an all-pad bag
    w = rng.random(size=(*lead, 5)).astype(np.float32) if weighted else None
    got = eb.embedding_bag(torch.as_tensor(table), torch.as_tensor(idx),
                           None if w is None else torch.as_tensor(w),
                           combiner=combiner)
    want = ref_eb.embedding_bag(jnp.asarray(table), jnp.asarray(idx),
                                None if w is None else jnp.asarray(w),
                                combiner=combiner)
    assert got.shape == (*lead, 6)
    _close(got, want, SUB_TOL)
    assert torch.equal(got.reshape(-1, 6)[0], torch.zeros(6))


def test_embedding_bag_rejects_an_unknown_combiner():
    with pytest.raises(ValueError, match="combiner"):
        eb.embedding_bag(torch.zeros((3, 2)), torch.zeros((1, 2),
                                                          dtype=torch.int32),
                         combiner="median")


def test_table_lookups_match_reference():
    rng = np.random.default_rng(31)
    tables = [rng.normal(size=(n, 4)).astype(np.float32) for n in (7, 11, 5)]
    idx = np.stack([rng.integers(0, n, size=9) for n in (7, 11, 5)],
                   1).astype(np.int32)
    got = eb.multi_table_lookup([torch.as_tensor(t) for t in tables],
                                torch.as_tensor(idx))
    want = ref_eb.multi_table_lookup([jnp.asarray(t) for t in tables],
                                     jnp.asarray(idx))
    assert got.shape == (9, 3, 4)
    _close(got, want, 0.0)
    stacked = np.concatenate(tables)
    offsets = np.array([0, 7, 18], np.int32)
    got = eb.stacked_table_lookup(torch.as_tensor(stacked),
                                  torch.as_tensor(offsets),
                                  torch.as_tensor(idx))
    want = ref_eb.stacked_table_lookup(jnp.asarray(stacked),
                                       jnp.asarray(offsets),
                                       jnp.asarray(idx))
    _close(got, want, 0.0)
