"""The sharded retrieval step on ``torch.distributed`` against the
reference's ``shard_map`` step.

One module fixture runs, side by side and once each:

* the reference (``repro.core.retrieval.make_sharded_retrieve`` and
  friends) in a subprocess with 16 fake XLA CPU devices, as
  ``tests/test_distributed.py`` runs it: meshes over the first 1, 2 and 8
  devices, and ``make_mesh_from``'s shape for 1-16 devices;
* the port on 8 gloo CPU processes (``file://`` rendezvous in the test's
  temporary directory): meshes over ranks ``[0]``, ``[0, 1]`` and all
  eight (the ranks a mesh leaves out get no coordinate), ``[0..5]`` for
  a (3, 2) mesh and ``max_model=4`` for a (2, 4) one.

The same seeded corpora and queries (numpy, made here) go through both.
At world sizes 1, 2 and 8, the five BM25 variants across the cases, the
classic and the gathered local step: ids tie-aware, scores within atol
1e-4, overflow flags equal at the case's budget and at a small one, every
board also against ``dense_oracle_scores``, and the same board on every
rank. The uneven-shard cases ([3, 4] documents at n = 2) are the
reference's and one under robertson's negative IDF, where an unmasked
padding document would outrank real ones. ``sharded_retrieve_adaptive`` gives the reference's ``p_used`` and
bucket trail. ``dist.sharding`` resolves batch and parameter placements as
the reference's ``PartitionSpec``s over (1, 8), (2, 4) and (3, 2) meshes,
and ``constrain`` redistributes a ``DTensor`` to them; on the same meshes
the recsys, LM and GNN cells' placements (train cells included) equal
the reference cells' (an LM placement split model-major over both axes is
a strided shard). qwen3-8b's smoke trains one step on the (2, 4) mesh
with its params placed by ``lm_param_shardings`` and the batch split over
the data axis, within 1e-2 of world size 1 (the reference's bound).

In-process: ``_device_gathered_topk`` against the reference's on the CPU
and bitwise run to run; the adaptive wrapper's trail, cap and
``PlanOverflowError`` with a monkeypatched step; a mesh over a group of
the wrong backend raises. The ``cuda``-marked tests (world size 1 on the
card, bitwise equal to the CPU) skip without a GPU.
"""

import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.core import (BM25Params, build_sharded_indexes,
                              dense_oracle_scores, pad_queries,
                              suggest_p_max)
from repro_torch.core import retrieval as rmod
from repro_torch.serve.errors import PlanOverflowError

ROOT = Path(__file__).resolve().parents[1]
WORLD = 8
ATOL = 1e-4
TIMEOUT_S = 420


def _corpus(seed, n_docs, n_vocab, max_len, dup=False):
    rng = np.random.default_rng(seed)
    docs = [rng.integers(0, n_vocab, size=rng.integers(1, max_len)
                         ).astype(np.int32) for _ in range(n_docs)]
    if dup:                         # every document twice: tied scores
        docs = [d for d in docs for _ in range(2)]
    return docs


def _queries(seed, n, n_vocab, max_len):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, n_vocab, size=rng.integers(1, max_len)
                         ).astype(np.int32) for _ in range(n)]


def _uneven():
    """The reference's uneven-shard case (tests/test_gathered_retrieval.py:
    two shards of 3 and 4 documents, k = every document)."""
    rng = np.random.default_rng(0)
    return [rng.integers(0, 12, size=rng.integers(1, 8)).astype(np.int32)
            for _ in range(7)]


CASES = [
    dict(name="n1_robertson", n=1, variant="robertson", k=6, q_max=8,
         corpus=_corpus(10, 80, 40, 25), queries=_queries(11, 6, 40, 8),
         p_small=16),
    dict(name="n1_atire_ties", n=1, variant="atire", k=10, q_max=8,
         corpus=_corpus(12, 30, 30, 12, dup=True),
         queries=_queries(13, 5, 30, 6), p_small=10),
    dict(name="n2_bm25l_uneven", n=2, variant="bm25l", k=7, q_max=8,
         corpus=_uneven(), queries=[np.array([0], np.int32),
                                    np.arange(8, dtype=np.int32)],
         p_max=64, p_small=4, k_too_large=9),
    # robertson's negative IDF: a padding document (raw score 0) would
    # outrank every real one holding token 0, so it must be masked
    dict(name="n2_robertson_uneven_negative", n=2, variant="robertson", k=7,
         q_max=4, corpus=[np.array(d, np.int32) for d in (
             [0, 1], [0, 2], [0], [0, 3], [0, 1, 2], [4], [0, 5])],
         queries=[np.array([0], np.int32), np.arange(4, dtype=np.int32)],
         p_max=64, p_small=4),
    dict(name="n2_lucene_ties", n=2, variant="lucene", k=5, q_max=8,
         corpus=_corpus(14, 25, 20, 10, dup=True),
         queries=_queries(15, 4, 20, 6), p_small=5),
    dict(name="n8_bm25plus", n=8, variant="bm25+", k=5, q_max=8,
         corpus=_corpus(0, 64, 80, 30), queries=_queries(16, 4, 80, 8),
         p_small=8),
    dict(name="n8_robertson_wide_k", n=8, variant="robertson", k=20,
         q_max=8, corpus=_corpus(17, 70, 50, 20),
         queries=_queries(18, 5, 50, 8), p_small=9),
]

# (``p_small`` is at least each shard's kk: the reference's gathered step
# ranks ``p_max`` candidate slots and cannot take more)

# sharded_retrieve_adaptive: tests/test_gathered_retrieval.py's tiny-vocab
# case (huge df; its floor of 16 overflows), at 1 and at 8 shards
ADAPTIVE = [
    dict(name="n1_adaptive", n=1, variant="lucene", k=5, q_max=8,
         corpus=_corpus(0, 60, 10, 30),
         queries=[np.arange(8, dtype=np.int32)], p_floor=16),
    dict(name="n8_adaptive", n=8, variant="bm25+", k=5, q_max=8,
         corpus=_corpus(19, 96, 12, 30),
         queries=_queries(20, 3, 12, 8), p_floor=16),
]

# dist.sharding: (ranks, max_model) -> the (data, model) mesh the rule gives
SHARDING_MESHES = {"1x8": (8, 16), "2x4": (8, 4), "3x2": (6, 16)}
BATCH_SHAPES = [(16, 5), (6, 3), (7,), (3, 2, 2), ()]
PARAM_SHAPES = {"w": (16, 12), "b": (12,), "odd": (7, 5), "v": (5, 6, 8),
                "s": ()}


REF_SCRIPT = textwrap.dedent("""
    import os
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=16"
    import pickle, sys
    import numpy as np
    import jax
    from repro.core import (BM25Params, build_sharded_indexes, pad_queries,
                            suggest_p_max)
    from repro.core import retrieval as rmod
    from repro.launch.mesh import make_mesh_from

    cases, adaptive, out_path = pickle.load(open(sys.argv[1], "rb"))
    out = {"mesh": {}, "cases": {}, "adaptive": {}}
    for m in (16, 4, 2):
        for n in range(1, 17):
            mesh = make_mesh_from(jax.devices()[:n], max_model=m)
            out["mesh"][m, n] = dict(mesh.shape)
    for c in cases:
        mesh = make_mesh_from(jax.devices()[:c["n"]])
        axes = tuple(mesh.shape.keys())
        shards = build_sharded_indexes(
            c["corpus"], c["n_vocab"], c["n"],
            params=BM25Params(method=c["variant"]))
        arrs, ndoc = rmod.stack_shard_arrays(shards, mesh, axes)
        toks, wts = pad_queries(c["queries"], c["q_max"])
        res = {"ndoc": ndoc}
        for gathered in (False, True):
            for tag, p in (("fit", c["p_max"]), ("small", c["p_small"])):
                fn = rmod.make_sharded_retrieve(
                    mesh, axes, p_max=p, k=c["k"], n_docs_per_shard=ndoc,
                    return_overflow=True, gathered=gathered)
                ids, vals, over = fn(arrs, toks, wts)
                res[gathered, tag] = (np.asarray(ids), np.asarray(vals),
                                      np.asarray(over))
            if c.get("k_too_large"):
                fn = rmod.make_sharded_retrieve(
                    mesh, axes, p_max=c["p_max"], k=c["k_too_large"],
                    n_docs_per_shard=ndoc, gathered=gathered)
                try:
                    fn(arrs, toks, wts)
                    res[gathered, "too_large"] = None
                except Exception as e:
                    res[gathered, "too_large"] = type(e).__name__
        out["cases"][c["name"]] = res
    real = rmod.make_sharded_retrieve
    for c in adaptive:
        trail = []

        def recording(*a, **kw):
            fn = real(*a, **kw)

            def call(*args):
                trail.append(kw["p_max"])
                return fn(*args)
            return call

        rmod.make_sharded_retrieve = recording
        mesh = make_mesh_from(jax.devices()[:c["n"]])
        axes = tuple(mesh.shape.keys())
        shards = build_sharded_indexes(
            c["corpus"], c["n_vocab"], c["n"],
            params=BM25Params(method=c["variant"]))
        arrs, ndoc = rmod.stack_shard_arrays(shards, mesh, axes)
        toks, wts = pad_queries(c["queries"], c["q_max"])
        fn = rmod.sharded_retrieve_adaptive(
            mesh, axes, k=c["k"], n_docs_per_shard=ndoc,
            p_floor=c["p_floor"])
        ids, vals, p = fn(arrs, toks, wts)
        first = list(trail)
        trail.clear()
        _, _, p2 = fn(arrs, toks, wts)
        out["adaptive"][c["name"]] = dict(
            ids=np.asarray(ids), vals=np.asarray(vals), p=p, trail=first,
            p2=p2, trail2=list(trail))
        rmod.make_sharded_retrieve = real
    pickle.dump(out, open(out_path, "wb"))
""")


PORT_SCRIPT = textwrap.dedent("""
    import os, pickle, sys
    import numpy as np
    import torch
    import torch.distributed as tdist
    torch.set_num_threads(1)
    rank, world, rdv, in_path, out_dir = (int(sys.argv[1]),
                                          int(sys.argv[2]), *sys.argv[3:])
    tdist.init_process_group("gloo", init_method="file://" + rdv,
                             rank=rank, world_size=world)
    from repro_torch.core import (BM25Params, build_sharded_indexes,
                                  pad_queries)
    from repro_torch.core import retrieval as rmod
    from repro_torch.dist import activation_sharding, constrain
    from repro_torch.dist.sharding import batch_pspec, param_pspecs
    from repro_torch.launch.mesh import make_mesh_from
    from torch.distributed.tensor import DTensor, Replicate

    (cases, adaptive, sharding_meshes, batch_shapes,
     param_shapes) = pickle.load(open(in_path, "rb"))
    out = {"cases": {}, "adaptive": {}, "sharding": {}, "mesh": {}}
    meshes = {}
    for n in sorted({c["n"] for c in cases + adaptive}):
        meshes[n] = make_mesh_from(list(range(n)), device_type="cpu")
        out["mesh"][n] = (tuple(meshes[n].shape),
                          meshes[n].get_coordinate())

    def enc(placements):
        return [("SS", p.dim, p.split_factor)
                if type(p).__name__ == "_StridedShard"
                else ("S", p.dim) if p.is_shard() else ("R",)
                for p in placements]

    # {path: encoded placements} of a tree whose leaves are placement
    # lists (the cells' shardings)
    def flat_placements(tree, path=()):
        if isinstance(tree, (list, tuple)) and tree and all(
                hasattr(p, "is_shard") for p in tree):
            return {path: enc(tree)}
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        return {k: v for key, sub in items
                for k, v in flat_placements(sub, path + (key,)).items()}

    def board(fn, arrs, toks, wts):
        return tuple(np.asarray(x) for x in fn(arrs, toks, wts))

    for c in cases:
        mesh = meshes[c["n"]]
        axes = tuple(mesh.mesh_dim_names)
        shards = build_sharded_indexes(
            c["corpus"], c["n_vocab"], c["n"],
            params=BM25Params(method=c["variant"]))
        ndoc = max(s.doc_lens.size for s in shards)
        fns = {(g, tag): rmod.make_sharded_retrieve(
                   mesh, axes, p_max=p, k=c["k"], n_docs_per_shard=ndoc,
                   return_overflow=True, gathered=g)
               for g in (False, True)
               for tag, p in (("fit", c["p_max"]), ("small", c["p_small"]))}
        if c.get("k_too_large"):
            for g in (False, True):
                fns[g, "too_large"] = rmod.make_sharded_retrieve(
                    mesh, axes, p_max=c["p_max"], k=c["k_too_large"],
                    n_docs_per_shard=ndoc, gathered=g)
        if mesh.get_coordinate() is None:
            continue
        arrs, ndoc2 = rmod.stack_shard_arrays(shards, mesh, axes)
        toks, wts = pad_queries(c["queries"], c["q_max"])
        res = {"ndoc": ndoc2,
               "local": [tuple(x.to_local().shape) for x in arrs],
               "placements": enc(arrs[0].placements),
               "global": tuple(arrs[1].shape)}
        for key, fn in fns.items():
            if key[1] == "too_large":
                try:
                    fn(arrs, toks, wts)
                    res[key] = None
                except ValueError as e:
                    res[key] = "ValueError"
            else:
                res[key] = board(fn, arrs, toks, wts)
        # twice, and once with tensor queries: the same bits
        res["again"] = board(fns[True, "fit"], arrs, toks, wts)
        res["tensor_queries"] = board(fns[False, "fit"], arrs,
                                      torch.as_tensor(toks),
                                      torch.as_tensor(wts))
        out["cases"][c["name"]] = res

    for c in adaptive:
        mesh = meshes[c["n"]]
        axes = tuple(mesh.mesh_dim_names)
        shards = build_sharded_indexes(
            c["corpus"], c["n_vocab"], c["n"],
            params=BM25Params(method=c["variant"]))
        ndoc = max(s.doc_lens.size for s in shards)
        fn = rmod.sharded_retrieve_adaptive(
            mesh, axes, k=c["k"], n_docs_per_shard=ndoc,
            p_floor=c["p_floor"])
        if mesh.get_coordinate() is None:
            continue
        arrs, _ = rmod.stack_shard_arrays(shards, mesh, axes)
        toks, wts = pad_queries(c["queries"], c["q_max"])
        ids, vals, p = fn(arrs, toks, wts)
        first = list(fn.trail)
        _, _, p2 = fn(arrs, toks, wts)
        out["adaptive"][c["name"]] = dict(
            ids=np.asarray(ids), vals=np.asarray(vals), p=p, trail=first,
            p2=p2, trail2=list(fn.trail))

    for name, (n, max_model) in sharding_meshes.items():
        mesh = make_mesh_from(list(range(n)), max_model=max_model,
                              device_type="cpu")
        if mesh.get_coordinate() is None:
            continue
        names = mesh.mesh_dim_names
        res = {"shape": tuple(mesh.shape),
               "batch": [enc(batch_pspec(s, mesh)) for s in batch_shapes],
               "params": {key: enc(v) for key, v in
                          param_pspecs({key: torch.empty(s, device="meta")
                                        for key, s in param_shapes.items()},
                                       mesh).items()}}
        x = torch.arange(16 * 12, dtype=torch.float32).reshape(16, 12)
        dx = DTensor.from_local(x, mesh, [Replicate()] * len(names),
                                run_check=False)
        res["outside"] = constrain(dx, "dp", "model") is dx
        with activation_sharding(mesh):
            y = constrain(dx, "dp", "model")
            z = constrain(dx, None, "dp")
            try:
                constrain(dx, "dp")
                res["rank_mismatch"] = None
            except ValueError:
                res["rank_mismatch"] = "ValueError"
            res["plain"] = constrain(x, "dp", "model") is x
        res["constrain"] = (enc(y.placements), enc(z.placements))
        res["constrain_equal"] = bool(
            torch.equal(y.full_tensor(), x) and torch.equal(z.full_tensor(),
                                                            x))
        res["local"] = (tuple(y.to_local().shape),
                        tuple(z.to_local().shape))
        from repro_torch import configs as port_configs
        res["recsys"], res["lm"], res["gnn"] = {}, {}, {}
        for arch in port_configs.list_archs():
            family = port_configs.get_module(arch).FAMILY
            for cell in port_configs.get_cells(arch):
                _, args = cell.build(mesh)
                res[family][cell.key] = flat_placements(
                    cell.shardings(mesh, args))
        out["sharding"][name] = res
    # the LM train step on the (2, 4) mesh: params placed by
    # lm_param_shardings (DTensors), gathered for the step, the batch's
    # data shard on each rank, every microbatch's grads averaged over the
    # data axis, AdamW on the gathered params on every rank
    import functools
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.configs import get_smoke
    from repro_torch.configs.common import lm_param_shardings
    from repro_torch.models import transformer
    from repro_torch.models.common import tree_map
    from repro_torch.train import AdamW, init_train_state, make_train_step
    cfg = get_smoke("qwen3-8b")
    params = transformer.init_params(torch.Generator().manual_seed(0), cfg,
                                     device="cpu")
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(8, 16)).astype(np.int32))
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
    opt = AdamW(lr=1e-3)
    full_step = make_train_step(functools.partial(transformer.loss_fn, cfg),
                                opt, n_microbatches=2)
    _, _, m1 = full_step(params, init_train_state(params, opt), batch)
    m8 = make_mesh_from(list(range(8)), max_model=4, device_type="cpu")
    specs = lm_param_shardings(cfg, params, m8)
    flat = lambda t, pre=(): ([(pre, t)] if not isinstance(t, dict) else
                              [x for k in sorted(t)
                               for x in flat(t[k], pre + (k,))])
    placed = {path: distribute_tensor(p, m8, dict(flat(specs))[path])
              for path, p in flat(params)}
    data_group = m8.get_group("data")
    n_data = dict(zip(m8.mesh_dim_names, m8.shape))["data"]

    class DataMean(torch.autograd.Function):
        @staticmethod
        def forward(ctx, p):
            return p.view_as(p)

        @staticmethod
        def backward(ctx, g):
            g = g.clone()
            tdist.all_reduce(g, group=data_group)
            return g / n_data

    def dp_loss(p, b):
        return transformer.loss_fn(cfg, tree_map(DataMean.apply, p), b)

    gathered = tree_map(lambda x: x, params)
    for path, d in placed.items():
        node = gathered
        for k in path[:-1]:
            node = node[k]
        node[path[-1]] = d.full_tensor()
    rows = 8 // n_data
    coord = m8.get_coordinate()[0]
    local = {k: v[coord * rows:(coord + 1) * rows] for k, v in batch.items()}
    step = make_train_step(dp_loss, opt, n_microbatches=2)
    p2, s2, m2 = step(gathered, init_train_state(gathered, opt), local)
    loss = m2["loss"].clone()
    tdist.all_reduce(loss, group=data_group)
    out["lm_train"] = dict(
        loss=float(loss) / n_data, single=float(m1["loss"]),
        placements={"/".join(p): enc(d.placements)
                    for p, d in placed.items()},
        finite=all(bool(torch.isfinite(x).all()) for _, x in flat(p2)),
        grad_norm=float(m2["grad_norm"]), single_norm=float(
            m1["grad_norm"]))
    out["foreign"] = sorted(m for m in sys.modules
                            if m.split(".")[0] in ("jax", "jaxlib", "repro"))
    pickle.dump(out, open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb"))
    tdist.destroy_process_group()
""")


def _payload(case):
    c = dict(case)
    c["n_vocab"] = 1 + max(int(d.max()) for d in c["corpus"])
    c.setdefault("p_max", max(
        suggest_p_max(s, c["q_max"]) for s in build_sharded_indexes(
            c["corpus"], c["n_vocab"], c["n"],
            params=BM25Params(method=c["variant"]))))
    return c


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both sides, started together: the reference in one process with
    16 fake devices, the port on 8 gloo ranks."""
    tmp = tmp_path_factory.mktemp("sharded")
    cases = [_payload(c) for c in CASES]
    adaptive = [_payload(c) for c in ADAPTIVE]
    ref_in, ref_out = tmp / "ref_in.pkl", tmp / "ref_out.pkl"
    pickle.dump((cases, adaptive, str(ref_out)), open(ref_in, "wb"))
    port_in = tmp / "port_in.pkl"
    pickle.dump((cases, adaptive, SHARDING_MESHES, BATCH_SHAPES,
                 PARAM_SHAPES), open(port_in, "wb"))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen([sys.executable, "-c", REF_SCRIPT,
                               str(ref_in)], env=env, cwd=ROOT,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)]
    for r in range(WORLD):
        procs.append(subprocess.Popen(
            [sys.executable, "-c", PORT_SCRIPT, str(r), str(WORLD),
             str(tmp / "rdv"), str(port_in), str(tmp)], env=env, cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    errors = []
    for i, p in enumerate(procs):
        try:
            _, err = p.communicate(timeout=TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        if p.returncode != 0:
            errors.append(f"{'reference' if i == 0 else f'rank {i - 1}'}: "
                          f"{err[-3000:]}")
    assert not errors, "\n".join(errors)
    port = [pickle.load(open(tmp / f"rank{r}.pkl", "rb"))
            for r in range(WORLD)]
    return SimpleNamespace(ref=pickle.load(open(ref_out, "rb")), port=port,
                           cases={c["name"]: c for c in cases},
                           adaptive={c["name"]: c for c in adaptive})


def _same_board(a, b) -> bool:
    return all(np.array_equal(x, y) for x, y in zip(a, b))


def _tie_aware(ids_a, vals_a, ids_b, vals_b, oracle_rows):
    """Scores within ATOL position by position, and every id carrying its
    own oracle score (so tied documents may come in either order)."""
    np.testing.assert_allclose(vals_a, vals_b, atol=ATOL)
    for q, row in enumerate(oracle_rows):
        np.testing.assert_allclose(row[ids_a[q]], vals_a[q], atol=ATOL)
        np.testing.assert_allclose(row[ids_b[q]], vals_b[q], atol=ATOL)


def _oracle_rows(case):
    p = BM25Params(method=case["variant"])
    return [dense_oracle_scores(case["corpus"], case["n_vocab"], q, p)
            for q in case["queries"]]


def _members(runs, n):
    return [runs.port[r] for r in range(n)]


@pytest.mark.parametrize("gathered", [False, True],
                         ids=["classic", "gathered"])
@pytest.mark.parametrize("name", [c["name"] for c in CASES])
def test_sharded_step_matches_reference(runs, name, gathered):
    case = runs.cases[name]
    ref = runs.ref["cases"][name]
    mine = runs.port[0]["cases"][name]
    assert mine["ndoc"] == ref["ndoc"]
    rows = _oracle_rows(case)
    for tag in ("fit", "small"):
        r_ids, r_vals, r_over = ref[gathered, tag]
        ids, vals, over = mine[gathered, tag]
        assert ids.shape == r_ids.shape == (len(case["queries"]), case["k"])
        assert ids.dtype == np.int32 and vals.dtype == np.float32
        np.testing.assert_array_equal(over, r_over)
        if tag == "fit":
            assert not over.any()
            _tie_aware(ids, vals, r_ids, r_vals, rows)
            for q in range(len(rows)):
                assert len(set(ids[q].tolist())) == case["k"]
                assert (ids[q] < len(case["corpus"])).all()
                top = np.sort(rows[q])[::-1][:case["k"]]
                np.testing.assert_allclose(vals[q], top, atol=ATOL)
        else:
            assert over.any(), "the small budget must overflow somewhere"
    # the same board on every rank of the mesh
    for other in _members(runs, case["n"])[1:]:
        for tag in ("fit", "small"):
            assert _same_board(other["cases"][name][gathered, tag],
                               mine[gathered, tag])


@pytest.mark.parametrize("name", [c["name"] for c in CASES])
def test_both_steps_agree_and_repeat_bitwise(runs, name):
    """The classic and gathered steps give the same scores; the gathered
    step twice and the classic step on tensor queries give the same
    bits."""
    mine = runs.port[0]["cases"][name]
    np.testing.assert_allclose(mine[True, "fit"][1], mine[False, "fit"][1],
                               atol=ATOL)
    assert _same_board(mine["again"], mine[True, "fit"])
    assert _same_board(mine["tensor_queries"], mine[False, "fit"])


def test_uneven_shards_and_dtensor_layout(runs):
    """[3, 4] documents at n = 2: padded to 4 a shard, no phantom ids
    (checked above); each rank holds a leading-dim-1 block of a
    ``Shard(0)`` DTensor over both mesh axes."""
    case = runs.cases["n2_bm25l_uneven"]
    sizes = [s.doc_lens.size for s in build_sharded_indexes(
        case["corpus"], case["n_vocab"], 2,
        params=BM25Params(method="bm25l"))]
    assert sorted(sizes) == [3, 4]
    for r in range(2):
        got = runs.port[r]["cases"]["n2_bm25l_uneven"]
        assert got["ndoc"] == 4
        assert all(shape[0] == 1 for shape in got["local"])
        assert got["global"][0] == 2
        assert got["placements"] == [("S", 0), ("S", 0)]


def test_k_past_the_candidates_raises_as_the_reference(runs):
    ref = runs.ref["cases"]["n2_bm25l_uneven"]
    mine = runs.port[0]["cases"]["n2_bm25l_uneven"]
    for gathered in (False, True):
        assert ref[gathered, "too_large"] is not None
        assert mine[gathered, "too_large"] == "ValueError"


@pytest.mark.parametrize("name", [c["name"] for c in ADAPTIVE])
def test_adaptive_gives_the_reference_bucket_trail(runs, name):
    case = runs.adaptive[name]
    ref = runs.ref["adaptive"][name]
    for r in range(case["n"]):
        mine = runs.port[r]["adaptive"][name]
        assert mine["p"] == ref["p"] > case["p_floor"]
        assert mine["trail"] == ref["trail"]
        assert mine["trail"][0] == case["p_floor"]
        assert mine["p2"] == ref["p2"] == ref["p"]
        assert mine["trail2"] == ref["trail2"] == [ref["p"]]
        _tie_aware(mine["ids"], mine["vals"], ref["ids"], ref["vals"],
                   _oracle_rows(case))


def test_the_ranks_import_neither_jax_nor_repro(runs):
    assert all(r["foreign"] == [] for r in runs.port)


def test_mesh_shapes_match_the_reference(runs):
    from repro_torch.launch.mesh import mesh_shape
    for (max_model, n), shape in runs.ref["mesh"].items():
        assert mesh_shape(n, max_model=max_model) == (
            shape["data"], shape["model"]), (n, max_model)
    assert mesh_shape(6) == (3, 2)
    # the port's meshes on the gloo ranks: members get a coordinate
    for n in (1, 2, 8):
        for r in range(WORLD):
            shape, coord = runs.port[r]["mesh"][n]
            assert shape == mesh_shape(n)
            assert (coord is not None) == (r < n)


def _spec_dims(placements, names, ndim):
    """Encoded DTensor placements -> per tensor dim, its mesh axes, major
    first (a strided shard is minor to its dim's plain shards)."""
    dims = [() for _ in range(ndim)]
    minor = [() for _ in range(ndim)]
    for name, p in zip(names, placements):
        if p[0] == "S":
            dims[p[1]] = dims[p[1]] + (name,)
        elif p[0] == "SS":
            minor[p[1]] = minor[p[1]] + (name,)
        else:
            assert p == ("R",), p
    return [d + m for d, m in zip(dims, minor)]


def _ref_dims(spec, ndim):
    dims = []
    for i in range(ndim):
        e = spec[i] if i < len(spec) else None
        dims.append(() if e is None else (e,) if isinstance(e, str)
                    else tuple(e))
    return dims


@pytest.mark.parametrize("mesh_name", list(SHARDING_MESHES))
def test_sharding_resolution_matches_the_reference(runs, mesh_name):
    from repro.dist import sharding as ref_sharding

    from repro_torch.launch.mesh import mesh_shape
    n, max_model = SHARDING_MESHES[mesh_name]
    data, model = mesh_shape(n, max_model=max_model)
    assert mesh_name == f"{data}x{model}"
    fake = SimpleNamespace(shape={"data": data, "model": model})
    names = ("data", "model")
    for r in range(n):
        got = runs.port[r]["sharding"][mesh_name]
        assert got["shape"] == (data, model)
        for shape, pl in zip(BATCH_SHAPES, got["batch"]):
            ref = ref_sharding.batch_pspec(shape, fake)
            assert _spec_dims(pl, names, len(shape)) == _ref_dims(
                ref, len(shape)), shape
        ref_params = ref_sharding.param_pspecs(
            {k: np.zeros(s, np.float32) for k, s in PARAM_SHAPES.items()},
            fake)
        for key, shape in PARAM_SHAPES.items():
            assert _spec_dims(got["params"][key], names, len(shape)) == \
                _ref_dims(ref_params[key], len(shape)), key
        # constrain: "dp" over (16, 12) shards dim 0 by data when it divides
        # 16, "model" dim 1 when it divides 12
        y_pl, z_pl = got["constrain"]
        ref_y = [ref_sharding._resolve(fake, 16, "dp"),
                 ref_sharding._resolve(fake, 12, "model")]
        ref_z = [None, ref_sharding._resolve(fake, 12, "dp")]
        assert _spec_dims(y_pl, names, 2) == _ref_dims(ref_y, 2)
        assert _spec_dims(z_pl, names, 2) == _ref_dims(ref_z, 2)
        assert got["constrain_equal"] and got["outside"] and got["plain"]
        assert got["rank_mismatch"] == "ValueError"


def _check_cell_placements(runs, mesh_name, family, archs):
    """The cells' placements of ``archs`` (``configs.common``'s
    ``shardings``, at full ``CONFIG``) on the ranks' real ``DeviceMesh``es
    equal the reference cells' ``NamedSharding``s on an ``AbstractMesh``
    of the same shape, each dim's axes in their order."""
    import jax
    from jax.sharding import AbstractMesh

    import repro.configs as ref_configs
    from repro_torch.launch.mesh import mesh_shape
    n, max_model = SHARDING_MESHES[mesh_name]
    shape = mesh_shape(n, max_model=max_model)
    ref_mesh = AbstractMesh(shape, ("data", "model"))
    want = {}
    for arch in archs:
        for c in ref_configs.get_cells(arch):
            _, args = c.build(ref_mesh)
            ndim = {tuple(getattr(k, "key", getattr(k, "idx", None))
                          for k in kp): len(a.shape)
                    for kp, a in jax.tree_util.tree_leaves_with_path(args)}
            want[c.key] = {
                path: _ref_dims(sh.spec, ndim[path])
                for path, sh in (
                    (tuple(getattr(k, "key", getattr(k, "idx", None))
                           for k in kp), sh)
                    for kp, sh in jax.tree_util.tree_leaves_with_path(
                        c.shardings(ref_mesh, args)))}
            assert len(want[c.key]) == len(ndim)
    for r in range(n):
        got = runs.port[r]["sharding"][mesh_name][family]
        assert set(got) == set(want)
        for key, paths in want.items():
            assert set(got[key]) == set(paths), key
            for path, dims in paths.items():
                assert _spec_dims(got[key][path], ("data", "model"),
                                  len(dims)) == dims, (key, path)


@pytest.mark.parametrize("mesh_name", list(SHARDING_MESHES))
def test_recsys_cell_placements_on_the_gloo_meshes(runs, mesh_name):
    _check_cell_placements(runs, mesh_name, "recsys",
                           ("autoint", "mind", "dlrm-mlperf", "sasrec"))


@pytest.mark.parametrize("mesh_name", list(SHARDING_MESHES))
def test_lm_cell_placements_on_the_gloo_meshes(runs, mesh_name):
    """The LM cells' params, optimizer state, tokens and decode caches:
    the weight-gathered MoEs' (and every train cell's) K/V projections
    split d_model model-major over both axes, a ``_StridedShard`` on the
    data dim."""
    _check_cell_placements(runs, mesh_name, "lm",
                           ("h2o-danube3-4b", "gemma3-1b", "qwen3-8b",
                            "mixtral-8x22b", "mixtral-8x7b"))


@pytest.mark.parametrize("mesh_name", list(SHARDING_MESHES))
def test_gnn_cell_placements_on_the_gloo_meshes(runs, mesh_name):
    """EGNN's train cells: params and optimizer state replicated, the
    edges over every mesh axis."""
    _check_cell_placements(runs, mesh_name, "gnn", ("egnn",))


def test_lm_train_step_runs_sharded(runs):
    """The counterpart of ``tests/test_distributed.py::
    test_lm_train_step_runs_sharded``: qwen3-8b's smoke with two
    microbatches on the 8-rank (2, 4) mesh, its params placed by
    ``lm_param_shardings`` (K/V projections model-major over both axes),
    the batch split over the data axis: the loss is within the
    reference's 1e-2 of world size 1, and every rank's params finite."""
    for r in range(WORLD):
        got = runs.port[r]["lm_train"]
        assert got["loss"] > 0 and got["finite"]
        assert abs(got["loss"] - got["single"]) < 1e-2
        assert abs(got["grad_norm"] - got["single_norm"]) < 1e-2 * max(
            1.0, got["single_norm"])
        pl = got["placements"]
        assert pl["layers/wk"][0][0] == "SS"        # data: strided, minor
        assert pl["layers/wk"][1] == ("S", 1)      # model: major on d
        assert pl["layers/wq"] == [("S", 1), ("S", 2)]
        assert pl["embed"] == [("R",), ("S", 0)]
        assert got["loss"] == runs.port[0]["lm_train"]["loss"]


# -- in process ---------------------------------------------------------------

def _ref_gathered(idx, toks, wts, *, p_max, k):
    import jax.numpy as jnp
    from repro.core.retrieval import _device_gathered_topk as ref_fn
    n = int(idx.doc_lens.size)
    ids, vals, over = ref_fn(
        jnp.asarray(idx.indptr.astype(np.int32)), jnp.asarray(idx.doc_ids),
        jnp.asarray(idx.scores), jnp.asarray(idx.nonoccurrence),
        jnp.asarray(toks), jnp.asarray(wts), jnp.int32(n), p_max=p_max, k=k,
        n_docs=n)
    return np.asarray(ids), np.asarray(vals), bool(over)


def _port_gathered(idx, toks, wts, *, p_max, k, n_docs=None):
    n = int(idx.doc_lens.size)
    ids, vals, over = rmod._device_gathered_topk(
        torch.as_tensor(idx.indptr.astype(np.int64)),
        torch.as_tensor(idx.doc_ids), torch.as_tensor(idx.scores),
        torch.as_tensor(idx.nonoccurrence), toks, wts, n, p_max=p_max, k=k,
        n_docs=n if n_docs is None else n_docs)
    return ids.numpy(), vals.numpy(), bool(over)


@pytest.mark.parametrize("method", ["robertson", "lucene", "bm25l", "bm25+",
                                    "atire"])
def test_device_gathered_topk_matches_the_reference(method):
    from repro_torch.core import build_index
    corpus = _corpus(21, 120, 60, 30)
    queries = _queries(22, 7, 60, 10) + [np.zeros(0, np.int32)]
    p = BM25Params(method=method)
    idx = build_index(corpus, 60, params=p)
    toks, wts = pad_queries(queries, 8)
    rows = [dense_oracle_scores(corpus, 60, q, p) for q in queries]
    for p_max in (4096, 64):
        r_ids, r_vals, r_over = _ref_gathered(idx, toks, wts, p_max=p_max,
                                              k=9)
        ids, vals, over = _port_gathered(idx, toks, wts, p_max=p_max, k=9)
        assert over == r_over == (p_max == 64)
        assert ids.dtype == np.int32 and ids.shape == (len(queries), 9)
        if not over:
            _tie_aware(ids, vals, r_ids, r_vals, rows)
        else:               # the same truncated postings: the same sums
            np.testing.assert_allclose(vals, r_vals, atol=ATOL)
        again = _port_gathered(idx, toks, wts, p_max=p_max, k=9)
        assert np.array_equal(again[0], ids)
        assert np.array_equal(again[1].view(np.int32), vals.view(np.int32))


def test_device_gathered_topk_sums_duplicate_tokens_and_pads():
    """A token repeated in a query adds once with its summed weight (the
    reference's weight table); k past the candidates splices defaults;
    docs at or past the real count never surface."""
    from repro_torch.core import build_index
    corpus = _corpus(23, 40, 15, 10)
    p = BM25Params(method="bm25+")
    idx = build_index(corpus, 15, params=p)
    toks = np.array([[3, 5, 3, -1], [7, -1, -1, -1]], np.int32)
    wts = np.array([[1, 2, 1.5, 0], [1, 0, 0, 0]], np.float32)
    r_ids, r_vals, _ = _ref_gathered(idx, toks, wts, p_max=1024, k=40)
    ids, vals, _ = _port_gathered(idx, toks, wts, p_max=1024, k=40)
    np.testing.assert_allclose(vals, r_vals, atol=ATOL)
    assert sorted(ids[0].tolist()) == list(range(40))
    # padded to 48 documents: the 8 phantoms take the float minimum
    pids, pvals, _ = _port_gathered(idx, toks, wts, p_max=1024, k=48,
                                    n_docs=48)
    assert (pids[:, :40] < 40).all()
    assert (pvals[:, 40:] <= np.finfo(np.float32).min / 2).all()


def test_the_gathered_step_never_sizes_a_buffer_by_p_max(monkeypatch):
    """At a budget of 2^24 slots no tensor the step makes is sized by it:
    they follow the postings gathered and the candidates."""
    from repro_torch.core import build_index
    corpus = _corpus(24, 50, 20, 12)
    idx = build_index(corpus, 20, params=BM25Params())
    toks, wts = pad_queries(_queries(25, 4, 20, 6), 8)
    seen = []

    def recording(make):
        def call(*a, **kw):
            t = make(*a, **kw)
            seen.append(t.numel())
            return t
        return call

    for name in ("zeros", "empty", "full", "arange"):
        monkeypatch.setattr(torch, name, recording(getattr(torch, name)))
    ids, vals, over = _port_gathered(idx, toks, wts, p_max=1 << 24, k=5)
    monkeypatch.undo()
    assert not over and seen
    assert max(seen) <= max(idx.nnz, toks.shape[0] * idx.doc_lens.size)


def _fake_make(calls, clears_at=None):
    def fake_make(mesh, shard_axes, *, p_max, k, n_docs_per_shard,
                  return_overflow, gathered):
        def fn(idx_arrays, q_tokens, q_weights):
            calls.append(p_max)
            b = q_tokens.shape[0]
            over = torch.full((b,), clears_at is None or p_max < clears_at)
            return (torch.zeros((b, k), dtype=torch.int32),
                    torch.zeros((b, k)), over)
        return fn
    return fake_make


def test_adaptive_cap_raises_plan_overflow(monkeypatch):
    calls = []
    monkeypatch.setattr(rmod, "make_sharded_retrieve", _fake_make(calls))
    retrieve = rmod.sharded_retrieve_adaptive(
        None, ("shards",), k=3, n_docs_per_shard=8, p_floor=8)
    idx_arrays = (None, np.zeros((1, 64)), None, None, None, None)
    q = torch.zeros((2, 4), dtype=torch.int32)
    w = torch.zeros((2, 4))
    with pytest.raises(PlanOverflowError, match="attempted") as ei:
        retrieve(idx_arrays, q, w)
    assert calls == [8, 16, 32, 64]                # pow2 regrowth to cap
    assert ei.value.attempted == calls and ei.value.cap == 64
    assert retrieve.trail == calls


def test_adaptive_returns_the_bucket_that_clears(monkeypatch):
    calls = []
    monkeypatch.setattr(rmod, "make_sharded_retrieve",
                        _fake_make(calls, clears_at=32))
    retrieve = rmod.sharded_retrieve_adaptive(
        None, ("shards",), k=3, n_docs_per_shard=8, p_floor=8)
    idx_arrays = (None, np.zeros((1, 64)), None, None, None, None)
    ids, vals, p = retrieve(idx_arrays, torch.zeros((2, 4), dtype=torch.int32),
                            torch.zeros((2, 4)))
    assert p == 32 and calls == [8, 16, 32]
    calls.clear()
    assert retrieve(idx_arrays, torch.zeros((2, 4), dtype=torch.int32),
                    torch.zeros((2, 4)))[2] == 32
    assert calls == [32]               # the next call starts where it fit


def _one_rank_group(tmp_path, backend):
    import torch.distributed as tdist
    tdist.init_process_group(backend, init_method=f"file://{tmp_path}/rdv",
                             rank=0, world_size=1)
    return tdist


def test_a_cuda_mesh_over_a_gloo_group_raises(tmp_path):
    """No fall-back hides the device: a cuda mesh over gloo is refused
    before any CUDA work (also on a machine without a GPU)."""
    from repro_torch.launch.mesh import check_mesh_backend, make_mesh_from
    tdist = _one_rank_group(tmp_path, "gloo")
    try:
        with pytest.raises(ValueError, match="nccl"):
            make_mesh_from(device_type="cuda")
        with pytest.raises(ValueError, match="nccl"):
            check_mesh_backend("cuda")
        check_mesh_backend("cpu")
        mesh = make_mesh_from(device_type="cpu")
        assert tuple(mesh.shape) == (1, 1)
        assert mesh.mesh_dim_names == ("data", "model")
    finally:
        tdist.destroy_process_group()


# -- on the card ---------------------------------------------------------------

def _world_one_boards(tmp_path, backend, device_type):
    """The classic and gathered steps at world size 1 on one device."""
    from repro_torch.launch.mesh import make_mesh_from
    case = _payload(CASES[0])
    tdist = _one_rank_group(tmp_path, backend)
    try:
        mesh = make_mesh_from(device_type=device_type)
        axes = ("data", "model")
        shards = build_sharded_indexes(
            case["corpus"], case["n_vocab"], 1,
            params=BM25Params(method=case["variant"]))
        arrs, ndoc = rmod.stack_shard_arrays(shards, mesh, axes)
        toks, wts = pad_queries(case["queries"], case["q_max"])
        out = {}
        for g in (False, True):
            fn = rmod.make_sharded_retrieve(
                mesh, axes, p_max=case["p_max"], k=case["k"],
                n_docs_per_shard=ndoc, return_overflow=True, gathered=g)
            out[g] = tuple(x.cpu() for x in fn(arrs, toks, wts))
        return out
    finally:
        tdist.destroy_process_group()


@pytest.mark.cuda
def test_world_size_one_on_the_card_bitwise_equals_the_cpu(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: NCCL and the CUDA kernels")
    (tmp_path / "cpu").mkdir()
    (tmp_path / "cuda").mkdir()
    cpu = _world_one_boards(tmp_path / "cpu", "gloo", "cpu")
    card = _world_one_boards(tmp_path / "cuda", "nccl", "cuda")
    for g in (False, True):
        for a, b in zip(cpu[g], card[g]):
            assert a.dtype == b.dtype and torch.equal(
                a.view(torch.int32) if a.dtype == torch.float32 else a,
                b.view(torch.int32) if b.dtype == torch.float32 else b)


@pytest.mark.cuda
def test_a_cuda_mesh_over_gloo_raises_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from repro_torch.launch.mesh import make_mesh_from
    tdist = _one_rank_group(tmp_path, "gloo")
    try:
        with pytest.raises(ValueError, match="nccl"):
            make_mesh_from(device_type="cuda")
    finally:
        tdist.destroy_process_group()
