"""The bf16 instantiations of K6 (``bm25_block_score``) and K5
(``blockwise_topk``), their twins, ``ops.topk``'s and the sharded merge's
bf16 values, the ``meta`` ops' bytes, and the bf16 blocked cells.

* K6-bf16's twin is ``bf16(K6_f32 twin(widen(scores), widen(weights)))``
  bit for bit, and within 2^-6 × the block column's largest |score| of
  the reference's live K6 in interpret mode on the same bf16 operands (the
  reference rounds each product and each 512-posting tile to bf16; the
  port rounds once). The f32 path gives the bits it gave.
* K5-bf16's twin is the f32 twin on the widened rows, its values narrowed
  back, bit for bit; its values equal the reference's ``blockwise_topk_ref``
  (``lax.top_k``) on the bf16 rows, its positions tie-aware. The live
  reference K5 does not run under the installed jax (ROADMAP R1).
* ``ops.topk`` and ``core.retrieval._all_gather_merge`` carry bf16 values.
* The cells: ``_score_blocked_cell(score_dtype=torch.bfloat16)`` takes
  bf16 scores and weights; its board, at world size 1 and with
  ``sharded_topk`` at world sizes 1 and 2 (gloo ranks), has the values of
  ``torch.topk`` of the bf16 K6 output bit for bit, and each id carries
  its value there.
* ``cuda``-marked: each bf16 kernel bitwise against its twin on the card
  (they skip without a GPU).
"""

import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from conftest import make_corpus
from repro_torch.core import BM25Params, build_index
from repro_torch.kernels import blockwise_topk as k5
from repro_torch.kernels import bm25_block_score as k6
from repro_torch.kernels import ops
from repro_torch.sparse.block_csr import DeviceIndex

ROOT = Path(__file__).resolve().parents[1]
BF16 = torch.bfloat16
REF_REL = 2.0 ** -6


def _bits(a):
    a = a.detach().cpu()
    if a.dtype == torch.float32:
        return a.view(torch.int32)
    if a.dtype == BF16:
        return a.view(torch.int16)
    return a


def _k6_operands(seed, b, layout="sorted", block_size=64, n_uniq=300):
    rng = np.random.default_rng(seed)
    corpus = make_corpus(rng, n_docs=900, n_vocab=1000, max_len=40)
    idx = build_index(corpus, 1000, params=BM25Params(method="lucene"))
    di = DeviceIndex.build(idx, device="cpu", block_size=block_size,
                           tile=64, frag=8)
    tok, loc, sc = (t.clone() for t in (di.blk_tok, di.blk_loc, di.blk_sc))
    if layout == "shuffled":
        perm = torch.as_tensor(np.stack([rng.permutation(tok.shape[1])
                                         for _ in range(tok.shape[0])]))
        tok, loc, sc = (torch.gather(t, 1, perm) for t in (tok, loc, sc))
    uniq = torch.as_tensor(np.sort(rng.choice(1000, n_uniq, replace=False))
                           .astype(np.int32))
    w = torch.as_tensor(rng.uniform(0.0, 3.0, size=(n_uniq, b)).astype(
        np.float32))
    return tok, loc, sc.to(BF16), uniq, w.to(BF16)


@pytest.mark.parametrize("layout", ["sorted", "shuffled"])
@pytest.mark.parametrize("b", [8, 100])
def test_k6_bf16_twin_is_the_f32_twin_rounded_once(b, layout):
    tok, loc, sc, uniq, w = _k6_operands(b, b, layout)
    got = k6.bm25_block_score(tok, loc, sc, uniq, w, block_size=64)
    assert got.dtype == BF16 and got.shape == (tok.shape[0], 64, b)
    f32 = k6.bm25_block_score(tok, loc, sc.float(), uniq, w.float(),
                              block_size=64)
    assert f32.dtype == torch.float32
    assert torch.equal(_bits(got), _bits(f32.to(BF16)))
    # the f32 path: the twin's bits as before
    assert torch.equal(_bits(f32), _bits(k6.block_accumulate(
        tok, loc, sc.float(), uniq, w.float(), block_size=64)))
    assert int((got != 0).sum()) > 0


def test_k6_refuses_mixed_dtypes():
    tok, loc, sc, uniq, w = _k6_operands(0, 8)
    with pytest.raises(TypeError):
        k6.bm25_block_score(tok, loc, sc.float(), uniq, w, block_size=64)
    with pytest.raises(TypeError):
        k6.bm25_block_score(tok, loc, sc, uniq, w.half(), block_size=64)
    with pytest.raises(TypeError):        # K2 stays f32
        k6.bm25_block_score_topk(tok, loc, sc, uniq, w, block_size=64,
                                 k=4, n_docs=900)


@pytest.mark.parametrize("b", [8, 64])
def test_k6_bf16_near_the_reference_live_kernel(b):
    """The reference's K6 (live, interpret mode) on the same bf16 operands,
    its postings padded to whole 512-posting tiles: every element within
    2^-6 × its block column's largest |score|."""
    import jax.numpy as jnp

    from repro.kernels.bm25_block_score import bm25_block_score as ref_k6

    tok, loc, sc, uniq, w = _k6_operands(7 + b, b)
    pad = -tok.shape[1] % 512
    tp, lp, sp = (torch.nn.functional.pad(t, (0, pad), value=v)
                  for t, v in ((tok, -1), (loc, 0), (sc.float(), 0.0)))
    got = k6.bm25_block_score(tok, loc, sc, uniq, w, block_size=64).float()
    ref = ref_k6(jnp.asarray(tp.numpy()), jnp.asarray(lp.numpy()),
                 jnp.asarray(sp.numpy()).astype(jnp.bfloat16),
                 jnp.asarray(uniq.numpy()),
                 jnp.asarray(w.float().numpy()).astype(jnp.bfloat16),
                 block_size=64)
    assert ref.dtype == jnp.bfloat16
    ref = torch.as_tensor(np.array(ref.astype(jnp.float32)))
    top = ref.abs().amax(dim=1, keepdim=True)          # a block's column
    assert bool(((got - ref).abs() <= REF_REL * top).all())


def _k5_rows(rng, kind, r, n):
    if kind == "normal":
        x = rng.normal(size=(r, n))
    elif kind == "ties":                 # bf16 makes many more
        x = rng.normal(size=(r, n)) * 0.01 + 1.0
    elif kind == "signed_zeros":
        x = np.where(rng.random((r, n)) < 0.5, 0.0, -0.0)
        x[:, ::97] = 1.0
    else:
        x = np.full((r, n), -np.inf)
        x[-1, ::13] = 1.0
    return torch.as_tensor(x.astype(np.float32)).to(BF16)


@pytest.mark.parametrize("kind", ["normal", "ties", "signed_zeros",
                                  "neg_inf"])
@pytest.mark.parametrize("n,block,k", [(2048, 512, 7), (9000, 4096, 100),
                                       (700, 512, 300)])
def test_k5_bf16_twin_is_the_f32_twin_narrowed(kind, n, block, k):
    x = _k5_rows(np.random.default_rng(n + k), kind, 3, n)
    v, i = k5.blockwise_topk(x, k=k, block=block)
    assert v.dtype == BF16 and i.dtype == torch.int32
    fv, fi = k5.blockwise_topk(x.float(), k=k, block=block)
    assert torch.equal(_bits(v), _bits(fv.to(BF16)))
    assert torch.equal(i, fi)


@pytest.mark.parametrize("kind", ["normal", "ties"])
def test_k5_bf16_values_equal_the_reference_oracle(kind):
    """The reference's ``blockwise_topk_ref`` (``lax.top_k`` a block) on
    the same bf16 row: values bit for bit; positions tie-aware (each the
    position of an entry holding its value, all distinct)."""
    import jax.numpy as jnp

    from repro.kernels.ref import blockwise_topk_ref

    x = _k5_rows(np.random.default_rng(5), kind, 1, 8192)
    v, i = k5.blockwise_topk(x, k=50, block=1024)
    rv, _ = blockwise_topk_ref(
        jnp.asarray(x[0].float().numpy()).astype(jnp.bfloat16), k=50,
        block=1024)
    rv = torch.as_tensor(np.array(rv.astype(jnp.float32)))
    assert torch.equal(v.float(), rv)
    seg = x[0].reshape(8, 1024)
    assert torch.equal(_bits(torch.gather(seg, 1, i.long())), _bits(v))
    assert all(len(set(row.tolist())) == 50 for row in i)


def test_topk_and_the_merge_carry_bf16():
    x = _k5_rows(np.random.default_rng(3), "ties", 4, 20_000)
    v, i = ops.topk(x, 64, block=4096)
    assert v.dtype == BF16 and i.dtype == torch.int32
    tv, _ = torch.topk(x.float(), 64, dim=1)
    assert torch.equal(v.float(), tv)
    assert torch.equal(_bits(torch.gather(x, 1, i.long())), _bits(v))


def test_meta_ops_take_bf16_and_count_its_bytes():
    from repro_torch.launch import costs

    def meta(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")

    nb, p, u, b = 16, 512, 128, 64

    def k6_call(dt):
        return costs.traced_cost(
            lambda *a: k6.bm25_block_score(*a, block_size=64),
            (meta(nb, p, dtype=torch.int32), meta(nb, p, dtype=torch.int32),
             meta(nb, p, dtype=dt), meta(u, dtype=torch.int32),
             meta(u, b, dtype=dt)))

    f32, bf = k6_call(torch.float32), k6_call(BF16)
    assert f32["flops"] == bf["flops"] == 2.0 * nb * p * b
    assert f32["bytes"] == 12.0 * nb * p + 4 * u + 4 * u * b \
        + 4 * nb * 64 * b
    assert bf["bytes"] == 10.0 * nb * p + 4 * u + 2 * u * b \
        + 2 * nb * 64 * b
    out = k6.bm25_block_score(meta(nb, p, dtype=torch.int32),
                              meta(nb, p, dtype=torch.int32),
                              meta(nb, p, dtype=BF16),
                              meta(u, dtype=torch.int32),
                              meta(u, b, dtype=BF16), block_size=64)
    assert out.dtype == BF16 and out.shape == (nb, 64, b)
    v, i = k5.blockwise_topk(meta(4, 8192, dtype=BF16), k=10, block=4096)
    assert v.dtype == BF16 and i.dtype == torch.int32 and v.shape == (8, 10)
    t32 = costs.traced_cost(lambda x: k5.blockwise_topk(x, k=10, block=4096),
                            (meta(4, 8192),))
    t16 = costs.traced_cost(lambda x: k5.blockwise_topk(x, k=10, block=4096),
                            (meta(4, 8192, dtype=BF16),))
    assert t16["flops"] == t32["flops"] and t16["bytes"] * 2 == t32["bytes"]


SMALL = dict(N_DOCS=8192, N_VOCAB=300, AVG_UNIQUE_TOKENS=8, QUERY_BATCH=16,
             Q_MAX=8, P_MAX=64, TOP_K=10, DOC_BLOCK=64, U_MAX=128)

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
    for name, v in data["consts"].items():
        setattr(bm25s, name, v)
    mesh = make_mesh_from(device_type="cpu")
    bf = torch.bfloat16
    blocked = [torch.from_numpy(a) for a in data["blocked"]]
    blocked[2] = blocked[2].to(bf)
    uniq = torch.from_numpy(data["uniq"])
    w = torch.from_numpy(data["weights"]).to(bf)

    def shard(a):
        per = a.shape[0] // world
        return DTensor.from_local(a[rank * per:(rank + 1) * per].clone(),
                                  mesh, [Shard(0)] * mesh.ndim,
                                  run_check=False)

    out = {}
    cell = bm25s._score_blocked_cell(sharded_topk=True, score_dtype=bf)
    fn, specs = cell.build(mesh)
    out["specs"] = [str(s.dtype) for s in specs]
    out["sharded"] = fn(*(shard(a) for a in blocked), uniq, w)
    if world == 1:
        fn, _ = bm25s._score_blocked_cell(score_dtype=bf).build(mesh)
        out["blocked"] = fn(*blocked, uniq, w)
        from repro_torch.kernels import bm25_block_score as k6
        out["dense"] = k6.bm25_block_score(*blocked, uniq, w,
                                           block_size=bm25s.DOC_BLOCK)
    if rank == 0:
        pickle.dump(out, open(outp, "wb"))
    tdist.destroy_process_group()
""")


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    """The bf16 blocked cells on gloo ranks: world size 1 (the default and
    the sharded variant, and K6's bf16 output) and 2 (sharded)."""
    from repro_torch.core.scoring import pad_queries
    from repro_torch.sparse.block_csr import (block_postings_from_index,
                                              pack_query_batch)

    tmp = tmp_path_factory.mktemp("bf16_cells")
    s = SMALL
    rng = np.random.default_rng(29)
    docs = [rng.integers(0, s["N_VOCAB"], size=rng.integers(1, 9)).astype(
        np.int32) for _ in range(s["N_DOCS"])]
    idx = build_index(docs, s["N_VOCAB"])
    qs = [rng.integers(0, s["N_VOCAB"], size=rng.integers(1, 5)).astype(
        np.int32) for _ in range(s["QUERY_BATCH"])]
    toks, wts = pad_queries(qs, s["Q_MAX"])
    bp = block_postings_from_index(idx, block_size=s["DOC_BLOCK"])
    p_cell = -(-s["AVG_UNIQUE_TOKENS"] * s["DOC_BLOCK"] // 512) * 512
    blocked = tuple(np.pad(a, ((0, 0), (0, p_cell - a.shape[1])),
                           constant_values=fill)
                    for a, fill in ((bp.token_ids, -1), (bp.local_doc, 0),
                                    (bp.scores, 0)))
    uniq, weights = pack_query_batch(toks, wts, u_max=s["U_MAX"])
    inp = tmp / "in.pkl"
    inp.write_bytes(pickle.dumps(dict(consts=s, blocked=blocked, uniq=uniq,
                                      weights=weights)))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen(
        [sys.executable, "-c", SCRIPT, str(r), str(world),
         str(tmp / f"rdv{world}"), str(inp), str(tmp / f"out{world}.pkl")],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for world in (1, 2) for r in range(world)]
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-3000:]
    return {w: pickle.loads((tmp / f"out{w}.pkl").read_bytes())
            for w in (1, 2)}


def test_bf16_cell_takes_bf16_scores_and_weights(cells):
    assert cells[1]["specs"] == ["torch.int32", "torch.int32",
                                 "torch.bfloat16", "torch.int32",
                                 "torch.bfloat16"]


@pytest.mark.parametrize("which", ["blocked", "sharded1", "sharded2"])
def test_bf16_cell_board_is_torch_topk_of_k6(cells, which):
    dense = cells[1]["dense"]
    assert dense.dtype == BF16
    b = SMALL["QUERY_BATCH"]
    flat = dense.permute(2, 0, 1).reshape(b, -1)
    ids, vals = (cells[1]["blocked"] if which == "blocked" else
                 cells[int(which[-1])]["sharded"])
    assert vals.dtype == BF16 and ids.dtype == torch.int32
    tv, _ = torch.topk(flat.float(), SMALL["TOP_K"], dim=1)
    assert torch.equal(vals.float(), tv)
    assert torch.equal(_bits(torch.gather(flat, 1, ids.long())), _bits(vals))
    assert all(len(set(r.tolist())) == SMALL["TOP_K"] for r in ids)
    if which == "sharded2":
        want = cells[1]["sharded"]
        assert torch.equal(ids, want[0]) and torch.equal(_bits(vals),
                                                         _bits(want[1]))


# -- on the card ---------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["sorted", "shuffled"])
@pytest.mark.parametrize("b,n_uniq", [(8, 300), (100, 300), (256, 900)])
def test_k6_bf16_bitwise_equal_twin_on_the_card(cuda_device, b, n_uniq,
                                                 layout):
    ops_t = _k6_operands(b, b, layout, n_uniq=n_uniq)
    n0 = k6.LAUNCHES_DENSE_BF16.n
    n32 = k6.LAUNCHES_DENSE.n
    ref = k6.bm25_block_score(*ops_t, block_size=64)
    got = k6.bm25_block_score(*(t.to(cuda_device) for t in ops_t),
                              block_size=64)
    assert k6.LAUNCHES_DENSE_BF16.n == n0 + 1 and k6.LAUNCHES_DENSE.n == n32
    assert got.dtype == BF16
    assert torch.equal(_bits(got), _bits(ref))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["normal", "ties", "signed_zeros",
                                  "neg_inf"])
@pytest.mark.parametrize("n,block,k", [(2048, 512, 7), (9000, 4096, 100),
                                       (4096, 4096, 4096), (700, 512, 300)])
def test_k5_bf16_bitwise_equal_twin_on_the_card(cuda_device, kind, n, block,
                                                k):
    x = _k5_rows(np.random.default_rng(n + k), kind, 3, n)
    n0, n32 = k5.LAUNCHES_BF16.n, k5.LAUNCHES.n
    ref = k5.blockwise_topk(x, k=k, block=block)
    got = k5.blockwise_topk(x.to(cuda_device), k=k, block=block)
    assert k5.LAUNCHES_BF16.n == n0 + 1 and k5.LAUNCHES.n == n32
    assert got[0].dtype == BF16
    for a, b in zip(got, ref):
        assert torch.equal(_bits(a), _bits(b))
