"""The dry run's cost counter (``repro_torch.launch.costs``) against hand
counts and against the reference's ``dot_general`` FLOPs.

The counterparts of ``tests/test_costs_and_cells.py``'s cost tests: a
Python loop of 10 matmuls counts 10×, nested loops 3 × 4 count 12×, an
einsum's contraction is exact, a grad counts more than twice its forward,
each op's FLOPs are filed under its compute dtype;
in a subprocess over a ``fake`` process group of 8 ranks (kept out of
this process, whose xdist worker may hold gloo groups of other tests), a
loop of 7 all-gathers counts 7 and an all-reduce's wire is twice its
payload, and ``bm25s/score_2m``'s index scatter is B · p_max slots a
shard. K5's and K6's cost formulas against a hand count on ``meta``
tensors (which run neither the kernel nor its twin). The cells' matmul
FLOPs (``mm``/``bmm``/``addmm``/``baddbmm``) equal the reference's
``dot_general`` FLOPs (a walk of ``jax.make_jaxpr`` of the reference's
cell, scan lengths multiplied) exactly for ``sasrec/serve_p99``,
``gemma3-1b/decode_32k`` and ``dlrm-mlperf/train_batch``; for
``egnn/molecule`` the test names the products that differ. The four
``retrieval_cand`` cells trace, K5 among their ops.
"""

import json
import math
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import repro.configs as ref_configs
import repro_torch.configs as configs
from repro_torch.kernels import blockwise_topk as k5
from repro_torch.kernels import bm25_block_score as k6
from repro_torch.kernels import ops
from repro_torch.launch.costs import trace, traced_cost

ROOT = Path(__file__).resolve().parents[1]
MATMULS = ("aten.mm", "aten.bmm", "aten.addmm", "aten.baddbmm")


def meta(*shape, dtype=torch.float32, grad=False):
    return torch.empty(shape, dtype=dtype, device="meta", requires_grad=grad)


def test_loop_flops_multiplied():
    def f(x, w):
        for _ in range(10):
            x = torch.tanh(x @ w)
        return x

    c = traced_cost(f, (meta(64, 64), meta(64, 64)))
    matmul = 2 * 64 ** 3
    assert c["flops"] >= 10 * matmul                 # every trip counted
    assert c["flops"] < 10 * matmul * 1.5            # not wildly over
    assert c["by_op"]["aten.mm"]["count"] == 10


def test_nested_loops_multiply():
    def f(x, w):
        for _ in range(3):
            for _ in range(4):
                x = x @ w
        return x

    c = traced_cost(f, (meta(32, 32), meta(32, 32)))
    assert c["flops"] == 12 * 2 * 32 ** 3            # 3 x 4 trips


def test_dot_flops_from_contraction():
    c = traced_cost(lambda a, b: torch.einsum("bik,bkj->bij", a, b),
                    (meta(4, 8, 16), meta(4, 16, 32)))
    assert c["flops"] == 2 * 4 * 8 * 16 * 32


def test_flops_are_filed_by_compute_dtype():
    def f(a, b, x, w):
        return (a @ b).float().sum() + torch.tanh(x @ w).sum()

    c = traced_cost(f, (meta(8, 16, dtype=torch.bfloat16),
                        meta(16, 32, dtype=torch.bfloat16), meta(4, 8),
                        meta(8, 8)), n_shards=2)
    by = c["flops_by_dtype"]
    assert by["bfloat16"] == 2 * (2 * 8 * 16 * 32)
    assert by["float32"] >= 2 * (2 * 4 * 8 * 8)
    assert sum(by.values()) == c["flops"]


def test_grad_counts_backward_flops():
    def loss(w, x):
        return ((x @ w) ** 2).sum()

    w, x = meta(32, 32, grad=True), meta(8, 32)
    fwd = traced_cost(loss, (w, x))["flops"]
    bwd = traced_cost(lambda w, x: torch.autograd.grad(loss(w, x), w),
                      (w, x))["flops"]
    assert bwd > 2 * fwd                             # fwd + 2 transposed mms


def test_shards_multiply_a_rank_local_count():
    one = traced_cost(lambda a, b: a @ b, (meta(8, 16), meta(16, 4)))
    many = traced_cost(lambda a, b: a @ b, (meta(8, 16), meta(16, 4)),
                       n_shards=16)
    assert many["flops"] == 16 * one["flops"] == 16 * 2 * 8 * 16 * 4
    assert many["bytes"] == 16 * one["bytes"]


def test_k5_formula_against_a_hand_count(monkeypatch):
    """``ops.topk`` on ``meta`` rows: K5 is one op whose cost is the
    reference's top-k rule, n · log2 n and twice the input's bytes, and
    neither the kernel nor its twin runs."""
    def never(*a, **k):
        raise AssertionError("a meta call ran the kernel or its twin")

    monkeypatch.setattr(k5, "blockwise_topk_plain", never)
    monkeypatch.setattr(k5._build, "load", never)
    before = k5.LAUNCHES.n
    x = meta(4, 10_000)
    t = trace(lambda x: ops.topk(x, 100, block=4096), (x,))
    assert k5.LAUNCHES.n == before
    d = t["by_op"]["repro_torch.blockwise_topk"]
    n = 4 * 10_000
    assert d["count"] == 1
    assert d["flops"] == n * math.log2(n)
    assert d["bytes"] == 2 * 4 * n
    vals, idx = ops.topk(x, 100, block=4096)
    assert vals.shape == idx.shape == (4, 100) and idx.dtype == torch.int32
    with FlopCounterMode(display=False) as fc:       # the same formula
        ops.topk(x, 100, block=4096)
    assert fc.get_flop_counts()["Global"][
        torch.ops.repro_torch.blockwise_topk] == n * math.log2(n)


def test_k6_formula_against_a_hand_count(monkeypatch):
    """K6 on ``meta`` operands: 12 bytes a slot, the table, the weights
    and the f32 output once; 2 · B operations a slot."""
    def never(*a, **k):
        raise AssertionError("a meta call ran the kernel or its twin")

    monkeypatch.setattr(k6, "block_accumulate", never)
    monkeypatch.setattr(k6._build, "load", never)
    before = k6.LAUNCHES_DENSE.n
    nb, p, u, b, bs = 3, 16, 8, 5, 32
    args = (meta(nb, p, dtype=torch.int32), meta(nb, p, dtype=torch.int32),
            meta(nb, p), meta(u, dtype=torch.int32), meta(u, b))
    t = trace(lambda *a: k6.bm25_block_score(*a, block_size=bs), args)
    d = t["by_op"]["repro_torch.bm25_block_score"]
    assert d["flops"] == 2 * nb * p * b
    assert d["bytes"] == 12 * nb * p + 4 * u + 4 * u * b + 4 * nb * bs * b
    out = k6.bm25_block_score(*args, block_size=bs)
    assert out.shape == (nb, bs, b) and out.dtype == torch.float32
    assert k6.LAUNCHES_DENSE.n == before


# -- the port's matmul FLOPs against the reference's dot_general ------------

def _ref_dot_flops(jaxpr, acc, scale=1.0):
    """``{(lhs shape, rhs shape): FLOPs}`` of every ``dot_general`` of a
    jaxpr, ``scan`` bodies multiplied by their length (the reference's
    ``costs.py`` rule for dots)."""
    for eqn in jaxpr.eqns:
        p = eqn.params
        if eqn.primitive.name == "dot_general":
            (lc, _), _ = p["dimension_numbers"]
            lhs, out = eqn.invars[0].aval, eqn.outvars[0].aval
            k = float(np.prod([lhs.shape[i] for i in lc])) if lc else 1.0
            key = (tuple(lhs.shape), tuple(eqn.invars[1].aval.shape))
            acc[key] = acc.get(key, 0.0) + scale * 2.0 * np.prod(
                out.shape) * k
        elif eqn.primitive.name == "scan":
            _ref_dot_flops(p["jaxpr"].jaxpr, acc, scale * p["length"])
        else:
            for key in ("jaxpr", "call_jaxpr", "fun_jaxpr", "closed_jaxpr"):
                if p.get(key) is not None:
                    _ref_dot_flops(getattr(p[key], "jaxpr", p[key]), acc,
                                   scale)
    return acc


def _cell(mod, arch, shape):
    return [c for c in mod.get_cells(arch) if c.shape == shape][0]


def _both(arch, shape):
    fn, args = _cell(ref_configs, arch, shape).build(None)
    ref = _ref_dot_flops(jax.make_jaxpr(fn)(*args).jaxpr, {})
    fn, args = _cell(configs, arch, shape).build(None)
    t = trace(fn, args)
    port = sum(d["flops"] for k, d in t["by_op"].items() if k in MATMULS)
    return ref, port


@pytest.mark.parametrize("arch,shape", [("sasrec", "serve_p99"),
                                        ("gemma3-1b", "decode_32k"),
                                        ("dlrm-mlperf", "train_batch")])
def test_matmul_flops_equal_the_reference(arch, shape):
    ref, port = _both(arch, shape)
    assert port == pytest.approx(sum(ref.values()), rel=1e-3)


def test_egnn_molecule_differs_by_the_last_coordinate_head():
    """EGNN's ``molecule`` step: the port's matmul FLOPs are the
    reference's plus one ``[E, d] × [d, d]`` and two ``[E, d] × [d, 1]``
    products (E = 8,192 padded edges, d = 64), +1.25 %. They are the
    coordinate head ``phi_x`` of the last layer, whose output (the final
    coordinates) the loss never reads: JAX's dead-code elimination drops
    that work from the reference's ``jax.checkpoint``-ed layer, while the
    port's forward computes it and ``torch.utils.checkpoint`` recomputes
    the whole layer in the backward."""
    ref, port = _both("egnn", "molecule")
    e, d = 8192, 64
    extra = 1 * (2 * e * d * d) + 2 * (2 * e * d * 1)
    assert port == sum(ref.values()) + extra
    assert extra / sum(ref.values()) == pytest.approx(0.0125, abs=5e-4)


@pytest.mark.parametrize("arch", ["autoint", "mind", "dlrm-mlperf",
                                  "sasrec"])
def test_retrieval_cand_cells_trace(arch):
    """K5 on ``meta`` tensors: the four ``retrieval_cand`` cells, whose
    top-k is ``ops.topk``, trace (K5's wrapper refused ``meta`` before)."""
    fn, args = _cell(configs, arch, "retrieval_cand").build(None)
    t = trace(fn, args)
    assert t["flops"] > 0
    n = 2 ** 20
    assert t["by_op"]["repro_torch.blockwise_topk"]["flops"] == \
        n * math.log2(n)


# -- collectives and score_2m over a fake group (a subprocess) --------------

SCRIPT = textwrap.dedent("""
    import json
    import torch
    import torch.distributed as tdist
    from repro_torch.configs import get_cells
    from repro_torch.launch.costs import collective_bytes, trace
    from repro_torch.launch.dryrun import fake_group, lay_out
    from repro_torch.launch.mesh import make_mesh_from

    out = {}
    with fake_group(8):
        x = torch.empty(128, 256, device="meta")

        def gathers(x):
            for _ in range(7):
                parts = [torch.empty_like(x) for _ in range(8)]
                tdist.all_gather(parts, x)
            return parts

        def reduce(x):
            tdist.all_reduce(x)
            return x

        out["gathers"] = collective_bytes(gathers, (x,))
        out["reduce"] = collective_bytes(reduce, (torch.empty(
            64, device="meta"),))
        mesh = make_mesh_from(device_type="cpu")
        cell = get_cells("bm25s")[0]
        fn, args = cell.build(mesh)
        t = trace(fn, lay_out(args, cell.shardings(mesh, args), mesh))
        out["score_2m"] = {"by_op": t["by_op"],
                           "collectives": t["collectives"],
                           "mesh": list(mesh.shape)}
    print("RESULT" + json.dumps(out))
""")


@pytest.fixture(scope="module")
def fake_results():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("RESULT")][-1]
    return json.loads(line[len("RESULT"):])


def test_collectives_loop_multiplied(fake_results):
    ag = fake_results["gathers"]["per_op"]["all-gather"]
    payload = 8 * 128 * 256 * 4                      # the gathered result
    assert ag["count"] == 7
    assert ag["bytes"] == ag["wire_bytes"] == 7 * payload
    ar = fake_results["reduce"]["per_op"]["all-reduce"]
    assert ar["count"] == 1
    assert ar["wire_bytes"] == 2 * ar["bytes"] == 2 * 64 * 4
    assert fake_results["reduce"]["wire_bytes"] == 2 * 64 * 4


def test_score_2m_counts_its_budget_a_shard(fake_results):
    """One shard's scatter is every query's whole budget, B · p_max slots
    (the bound of ``score_batch``'s data-dependent size), and its one
    collective is the merge's all-gather."""
    from repro_torch.configs import bm25s
    r = fake_results["score_2m"]
    slots = bm25s.QUERY_BATCH * bm25s.P_MAX
    add = r["by_op"]["aten.index_add_"]
    assert add["flops"] == slots and add["bytes"] == 2 * 4 * slots
    gathers = r["by_op"]["aten.index"]
    assert gathers["bytes"] >= 2 * 2 * 4 * slots     # doc ids and scores
    assert list(r["collectives"]) == ["all-gather"]
    assert r["collectives"]["all-gather"]["count"] == 1
