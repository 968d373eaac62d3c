"""The bm25s cells (``repro_torch.configs.bm25s``) against the reference's
(``repro.configs.bm25s``).

At full width: the constants, ``CONFIG``, ``SMOKE``, the cells' keys,
kinds, ``model_flops`` and their arguments' shapes and dtypes (the
blocked cell here, ``score_2m`` on a one-rank gloo mesh in a
subprocess). At a reduced size, the module constants monkeypatched in
both packages (nothing in ``src/repro`` is edited; the port's in its
subprocesses), the same seeded Zipf corpus and queries (numpy, made here)
go through both cells' functions: ``score_2m`` at world size 1 (the port's
index arrays as ``DTensor`` shards) with queries over ``P_MAX``, whose
truncated scores must match too, and ``score_blocked_2m`` (K6's and K5's
twins on the CPU, the reference's jnp oracles): scores within atol 1e-4,
ids tie-aware. ``sharded_topk=True`` at world sizes 1 and 2 (gloo ranks)
gives the default variant's board bit for bit; ``core.retrieval.shard_id`` is
a rank's row-major mesh coordinate.
"""

import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
import repro_torch.configs as configs
from repro.configs import bm25s as ref_bm25s
from repro.core import build_index as ref_build_index
from repro.core import pad_queries
from repro.launch.mesh import make_test_mesh
from repro_torch.configs import bm25s
from repro_torch.core import build_index
from repro_torch.sparse.block_csr import (block_postings_from_index,
                                          pack_query_batch)

ROOT = Path(__file__).resolve().parents[1]
ATOL = 1e-4
CONSTS = ("N_DOCS", "N_VOCAB", "AVG_UNIQUE_TOKENS", "QUERY_BATCH", "Q_MAX",
          "P_MAX", "TOP_K", "DOC_BLOCK", "U_MAX")
# reduced: 8,192 docs (past K5's 4,096-entry segment), blocks of 64
SMALL = dict(N_DOCS=8192, N_VOCAB=300, AVG_UNIQUE_TOKENS=8, QUERY_BATCH=16,
             Q_MAX=8, P_MAX=64, TOP_K=10, DOC_BLOCK=64, U_MAX=128)
DTYPES = {"torch.int32": jnp.int32, "torch.float32": jnp.float32}


def test_constants_and_configs_equal_the_reference():
    for name in CONSTS:
        assert getattr(bm25s, name) == getattr(ref_bm25s, name), name
    assert (bm25s.N_DOCS, bm25s.N_VOCAB, bm25s.P_MAX, bm25s.U_MAX) == (
        2_097_152, 200_000, 16_384, 2048)
    for mod, ref in ((bm25s.CONFIG, ref_bm25s.CONFIG),
                     (bm25s.SMOKE, ref_bm25s.SMOKE)):
        assert {k: v for k, v in mod.items() if k != "params"} == {
            k: v for k, v in ref.items() if k != "params"}
        p, r = mod["params"], ref["params"]
        assert (p.method, p.k1, p.b) == (r.method, r.k1, r.b) == (
            "lucene", 1.5, 0.75)
    assert bm25s.FAMILY == ref_bm25s.FAMILY == "bm25s"
    assert configs.get_module("bm25s") is bm25s


def test_cells_equal_the_reference():
    cells, ref = bm25s.cells(), ref_bm25s.cells()
    assert [c.key for c in cells] == [c.key for c in ref] == [
        "bm25s/score_2m", "bm25s/score_blocked_2m"]
    for c, r in zip(cells, ref):
        assert (c.kind, c.model_flops, c.note) == (r.kind, r.model_flops,
                                                   r.note)
        assert c.remesh is None and r.remesh is None
    assert "p_max" in cells[0].count_bound and not cells[1].count_bound


def test_blocked_arguments_equal_the_reference_at_full_width():
    _, args = bm25s._score_blocked_cell().build(None)
    _, ref = ref_bm25s._score_blocked_cell().build(make_test_mesh())
    assert [tuple(a.shape) for a in args] == [tuple(r.shape) for r in ref]
    assert [tuple(a.shape) for a in args] == [
        (4096, 61_440), (4096, 61_440), (4096, 61_440), (2048,),
        (2048, 256)]
    assert [DTYPES[str(a.dtype)] for a in args] == [r.dtype for r in ref]
    assert all(a.device.type == "meta" for a in args)


def test_blocked_cell_reads_the_module_constants_when_made(monkeypatch):
    full = bm25s._score_blocked_cell()
    for name, v in SMALL.items():
        monkeypatch.setattr(bm25s, name, v)
    small = bm25s._score_blocked_cell()
    _, args = small.build(None)
    p = -(-SMALL["AVG_UNIQUE_TOKENS"] * SMALL["DOC_BLOCK"] // 512) * 512
    n_blocks = SMALL["N_DOCS"] // SMALL["DOC_BLOCK"]
    assert [tuple(a.shape) for a in args] == [
        (n_blocks, p), (n_blocks, p), (n_blocks, p), (SMALL["U_MAX"],),
        (SMALL["U_MAX"], SMALL["QUERY_BATCH"])]
    assert small.model_flops < full.model_flops
    assert tuple(full.build(None)[1][0].shape) == (4096, 61_440)


@pytest.mark.parametrize("shape,coord", [((1, 1), (0, 0)), ((2, 4), (1, 2)),
                                         ((16, 16), (15, 3))])
def test_shard_id_is_the_row_major_coordinate(shape, coord):
    from types import SimpleNamespace

    from repro_torch.core.retrieval import shard_id
    mesh = SimpleNamespace(mesh_dim_names=("data", "model"), shape=shape,
                           get_coordinate=lambda: list(coord))
    assert shard_id(mesh, ("data", "model")) == coord[0] * shape[1] + coord[1]
    assert shard_id(mesh, ("model",)) == coord[1]


# -- reduced size: the port's cells (subprocesses) against the reference ---

def _corpus(rng, n_docs, n_vocab):
    """Zipf tokens (a few with thousands of postings, a long tail), at
    most 8 a document."""
    p = 1.0 / np.arange(1, n_vocab + 1) ** 1.1
    cdf = np.cumsum(p / p.sum())
    return [np.minimum(np.searchsorted(cdf, rng.random(rng.integers(1, 9))),
                       n_vocab - 1).astype(np.int32) for _ in range(n_docs)]


def _data():
    s = SMALL
    rng = np.random.default_rng(28)
    docs = _corpus(rng, s["N_DOCS"], s["N_VOCAB"])
    idx = build_index(docs, s["N_VOCAB"])
    ref_idx = ref_build_index(docs, s["N_VOCAB"])
    for a in ("indptr", "doc_ids", "scores", "nonoccurrence"):
        np.testing.assert_array_equal(getattr(idx, a), getattr(ref_idx, a))
    # half the queries from the head (over P_MAX), half from the tail
    qs = [rng.integers(0, 12, size=rng.integers(1, 6)).astype(np.int32)
          if i % 2 else rng.integers(150, s["N_VOCAB"], size=rng.integers(
              1, 4)).astype(np.int32) for i in range(s["QUERY_BATCH"])]
    toks, wts = pad_queries(qs, s["Q_MAX"])
    nnz_pad = -(-s["N_DOCS"] * s["AVG_UNIQUE_TOKENS"] // 1024) * 1024
    assert idx.nnz <= nnz_pad

    def pad(a, n, fill):
        out = np.full(n, fill, a.dtype)
        out[:a.size] = a
        return out[None]

    idx_arrays = (idx.indptr.astype(np.int32)[None],
                  pad(idx.doc_ids.astype(np.int32), nnz_pad, 0),
                  pad(idx.scores.astype(np.float32), nnz_pad, 0),
                  idx.nonoccurrence.astype(np.float32)[None],
                  np.zeros((1, 1), np.int32),
                  np.full((1, 1), s["N_DOCS"], np.int32))
    bp = block_postings_from_index(idx, block_size=s["DOC_BLOCK"])
    p_cell = -(-s["AVG_UNIQUE_TOKENS"] * s["DOC_BLOCK"] // 512) * 512
    assert bp.token_ids.shape[1] <= p_cell
    blocked = tuple(np.pad(a, ((0, 0), (0, p_cell - a.shape[1])),
                           constant_values=fill)
                    for a, fill in ((bp.token_ids, -1), (bp.local_doc, 0),
                                    (bp.scores, 0)))
    uniq, weights = pack_query_batch(toks, wts, u_max=s["U_MAX"])
    df = np.diff(idx.indptr)
    demand = np.where(toks >= 0, df[np.maximum(toks, 0)], 0).sum(1)
    return dict(consts=SMALL, q_tokens=toks, q_weights=wts,
                idx_arrays=idx_arrays, blocked=blocked, uniq=uniq,
                weights=weights, demand=demand)


SCRIPT = textwrap.dedent("""
    import pickle, sys
    import torch
    import torch.distributed as tdist
    from torch.distributed.tensor import DTensor, Shard

    rank, world, rdv, inp, outp = (int(sys.argv[1]), int(sys.argv[2]),
                                   sys.argv[3], sys.argv[4], sys.argv[5])
    tdist.init_process_group("gloo", init_method="file://" + rdv,
                             rank=rank, world_size=world)
    from repro_torch.configs import bm25s
    from repro_torch.launch.mesh import make_mesh_from

    data = pickle.load(open(inp, "rb"))
    mesh = make_mesh_from(device_type="cpu")
    out = {}

    def shard(a):
        # this rank's rows of dim 0, sharded over every mesh axis
        per = a.shape[0] // world
        local = torch.from_numpy(a[rank * per:(rank + 1) * per].copy())
        return DTensor.from_local(local, mesh, [Shard(0)] * mesh.ndim,
                                  run_check=False)

    def board(res):
        return tuple(t.numpy() for t in res)

    if world == 1:                      # full width: the arguments' specs
        _, args = bm25s._score_2m_cell().build(mesh)
        out["full_2m"] = [(tuple(t.shape), str(t.dtype), t.device.type)
                          for t in (*args[0], args[1], args[2])]
    for name, v in data["consts"].items():
        setattr(bm25s, name, v)
    toks, wts = (torch.from_numpy(data[k]) for k in ("q_tokens",
                                                     "q_weights"))
    uniq, w = (torch.from_numpy(data[k]) for k in ("uniq", "weights"))
    if world == 1:
        fn, _ = bm25s._score_2m_cell().build(mesh)
        out["score_2m"] = board(fn([shard(a) for a in data["idx_arrays"]],
                                   toks, wts))
        fn, _ = bm25s._score_blocked_cell().build(mesh)
        out["blocked"] = board(fn(*(torch.from_numpy(a)
                                    for a in data["blocked"]), uniq, w))
    fn, _ = bm25s._score_blocked_cell(sharded_topk=True).build(mesh)
    out["sharded"] = board(fn(*(shard(a) for a in data["blocked"]), uniq,
                              w))
    if rank == 0:
        pickle.dump(out, open(outp, "wb"))
    tdist.destroy_process_group()
""")


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """The port's boards: world size 1 (both cells, the sharded variant)
    and world size 2 (the sharded variant), gloo ranks in subprocesses."""
    tmp = tmp_path_factory.mktemp("bm25s")
    data = _data()
    inp = tmp / "in.pkl"
    inp.write_bytes(pickle.dumps(data))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = []
    for world in (1, 2):
        for rank in range(world):
            procs.append(subprocess.Popen(
                [sys.executable, "-c", SCRIPT, str(rank), str(world),
                 str(tmp / f"rdv{world}"), str(inp),
                 str(tmp / f"out{world}.pkl")], cwd=ROOT, env=env,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-3000:]
    return data, {w: pickle.loads((tmp / f"out{w}.pkl").read_bytes())
                  for w in (1, 2)}


@pytest.fixture(scope="module")
def reference(port):
    """The reference's cell functions on the same data, its module
    constants patched for the call (the reference is not edited)."""
    data = port[0]
    saved = {k: getattr(ref_bm25s, k) for k in CONSTS}
    try:
        for k, v in SMALL.items():
            setattr(ref_bm25s, k, v)
        mesh = make_test_mesh()
        fn, _ = ref_bm25s._score_2m_cell().build(mesh)
        s2m = fn(tuple(jnp.asarray(a) for a in data["idx_arrays"]),
                 jnp.asarray(data["q_tokens"]), jnp.asarray(data["q_weights"]))
        fn, _ = ref_bm25s._score_blocked_cell(
            doc_block=SMALL["DOC_BLOCK"], batch=SMALL["QUERY_BATCH"],
            u_max=SMALL["U_MAX"]).build(mesh)
        blk = fn(*(jnp.asarray(a) for a in data["blocked"]),
                 jnp.asarray(data["uniq"]), jnp.asarray(data["weights"]))
    finally:
        for k, v in saved.items():
            setattr(ref_bm25s, k, v)
    return {"score_2m": tuple(np.asarray(t) for t in s2m),
            "blocked": tuple(np.asarray(t) for t in blk)}


def _tie_equal(got, want):
    """Boards ``(ids, scores)`` equal up to ties: scores within ATOL
    position by position; in every row the ids scoring more than ATOL
    above the k-th score the same set."""
    (gi, gv), (wi, wv) = got, want
    np.testing.assert_allclose(gv, wv, rtol=0, atol=ATOL)
    for a_ids, a_v, b_ids, b_v in zip(gi, gv, wi, wv):
        cut = min(a_v[-1], b_v[-1]) + ATOL
        assert set(a_ids[a_v > cut].tolist()) == set(
            b_ids[b_v > cut].tolist())


def test_score_2m_arguments_equal_the_reference_at_full_width(port):
    _, args = ref_configs.get_cells("bm25s")[0].build(make_test_mesh())
    ref = [*args[0], args[1], args[2]]
    got = port[1][1]["full_2m"]
    assert [g[0] for g in got] == [tuple(r.shape) for r in ref]
    assert [DTYPES[g[1]] for g in got] == [r.dtype for r in ref]
    assert all(g[2] == "meta" for g in got)
    assert got[1][0] == (1, 251_658_240)     # nnz_pad at one shard


def test_score_2m_equals_the_reference(port, reference):
    data, out = port
    over = data["demand"] > SMALL["P_MAX"]
    assert over.any() and not over.all()     # truncated queries included
    ids, vals = out[1]["score_2m"]
    assert ids.shape == (SMALL["QUERY_BATCH"], SMALL["TOP_K"])
    assert ids.dtype == np.int32 and vals.dtype == np.float32
    assert (vals[:, 0] > 0).all()            # every query matches
    _tie_equal((ids, vals), reference["score_2m"])


def test_blocked_equals_the_reference(port, reference):
    ids, vals = port[1][1]["blocked"]
    assert ids.shape == (SMALL["QUERY_BATCH"], SMALL["TOP_K"])
    assert (vals[:, 0] > 0).all()
    _tie_equal((ids, vals), reference["blocked"])


@pytest.mark.parametrize("world", [1, 2])
def test_sharded_topk_is_the_default_board_bitwise(port, world):
    want = port[1][1]["blocked"]
    got = port[1][world]["sharded"]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1].view(np.int32),
                                  want[1].view(np.int32))
