"""The port's procedural graphs equal the JAX package's, array for array.

``repro_torch.data.graphs`` is a numpy copy of ``repro.data.graphs`` (the
port imports nothing of the reference), so for one seed every array must
be byte-identical: the graph, its in-neighbour CSR, a neighbour sample
drawn with the same generator state, and a batch of molecules.
"""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")          # the reference's data package needs it

from repro.data import graphs as ref_graphs  # noqa: E402
from repro_torch.data import graphs  # noqa: E402


def _same(a, b):
    assert type(a) is type(b)
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    else:
        assert a == b


@pytest.mark.parametrize("n,deg,d_feat,n_classes,seed", [
    (50, 4, 8, 3, 0), (300, 7, 13, 5, 11), (1, 3, 2, 2, 4)])
def test_random_graph_and_csr_are_byte_identical(n, deg, d_feat, n_classes,
                                                 seed):
    kw = dict(d_feat=d_feat, n_classes=n_classes, seed=seed)
    g = graphs.random_graph(n, deg, **kw)
    r = ref_graphs.random_graph(n, deg, **kw)
    for f in dataclasses.fields(ref_graphs.Graph):
        _same(getattr(g, f.name), getattr(r, f.name))
    for a, b in zip(g.csr(), r.csr()):
        _same(a, b)
    indptr, src = g.csr()
    assert indptr[-1] == n * deg and src.size == n * deg


@pytest.mark.parametrize("fanouts", [(3,), (4, 2), (15, 10)])
def test_neighbor_sample_is_byte_identical(fanouts):
    g = graphs.random_graph(400, 6, d_feat=5, n_classes=4, seed=2)
    r = ref_graphs.random_graph(400, 6, d_feat=5, n_classes=4, seed=2)
    seeds = np.random.default_rng(8).choice(400, size=16, replace=False)
    got = graphs.neighbor_sample(g, seeds, fanouts,
                                 rng=np.random.default_rng(5))
    want = ref_graphs.neighbor_sample(r, seeds, fanouts,
                                      rng=np.random.default_rng(5))
    assert got.keys() == want.keys()
    for k in want:
        _same(got[k], want[k])
    n_max = 16 * (1 + int(np.cumsum(np.cumprod(fanouts))[-1]))
    assert got["node_feat"].shape == (n_max, 5)


@pytest.mark.parametrize("fanouts", [(3,), (15, 10)])
def test_fanout_bags_follow_neighbor_sample_rule(fanouts):
    g = graphs.random_graph(400, 6, d_feat=5, n_classes=4, seed=2)
    r = ref_graphs.random_graph(400, 6, d_feat=5, n_classes=4, seed=2)
    indptr, src_idx = g.csr()
    deg = np.diff(indptr)
    seeds = np.random.default_rng(8).choice(400, size=16, replace=False)
    seeds = np.concatenate([seeds, [-1, int(np.flatnonzero(deg == 0)[0])]])
    rng = np.random.default_rng(5)
    frontier = seeds
    for f in fanouts:
        bags = graphs.fanout_bags(indptr, src_idx, frontier, f, rng=rng)
        assert bags.shape == (frontier.size, f) and bags.dtype == np.int32
        for u, bag in zip(frontier.tolist(), bags):
            k = min(f, int(deg[u])) if u >= 0 else 0
            assert (bag[k:] == -1).all() and (bag[:k] >= 0).all()
            # k distinct slots of u's row (a multi-edge repeats an id)
            ids, n = np.unique(bag[:k], return_counts=True)
            row_ids, row_n = np.unique(src_idx[indptr[u]:indptr[u + 1]],
                                       return_counts=True)
            pos = np.searchsorted(row_ids, ids)
            assert (row_ids[pos] == ids).all() and (n <= row_n[pos]).all()
        frontier = bags.reshape(-1)
    # the same draws as the reference's sampler: its generator ends in the
    # same state (a -1 or an isolated node draws nothing in either)
    want = np.random.default_rng(5)
    ref_graphs.neighbor_sample(r, seeds[seeds >= 0], fanouts, rng=want)
    assert rng.bit_generator.state == want.bit_generator.state


def test_batched_molecules_are_byte_identical():
    got = graphs.batched_molecules(6, n_nodes=9, n_edges=14, d_feat=4,
                                   seed=3)
    want = ref_graphs.batched_molecules(6, n_nodes=9, n_edges=14, d_feat=4,
                                        seed=3)
    assert got.keys() == want.keys()
    for k in want:
        _same(got[k], want[k])
