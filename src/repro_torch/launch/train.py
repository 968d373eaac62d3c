"""Production training launcher on the port.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-8b \\
        --smoke --steps 50 --ckpt-dir /tmp/ckpt [--device cuda]

Selects the architecture from the registry (``--arch``), builds the mesh
over the ranks of the process group (``launch/mesh.py::make_mesh_from``;
with no group up, a group of one rank is started on a rendezvous file in
a temporary directory and torn down at the end), applies the family's
sharding rules, and runs the fault-tolerant loop with checkpoint /
auto-resume. ``--smoke`` swaps in the reduced config. Training runs on
``--device`` (default ``cuda``; with no GPU that raises
``ResidencyError``, pass ``--device cpu`` to train on the host). The
printed ``[train]`` lines are the reference's.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import os
import shutil
import tempfile

# the reference's archs the port's registry does not hold, by family:
# they serve and do not train
_SERVING_ONLY = {"bm25s": "bm25s"}


@contextlib.contextmanager
def _process_group(backend: str):
    """The default process group: the one already up, one from the
    launcher's environment (``RANK``/``WORLD_SIZE``/``MASTER_ADDR``), or
    else one rank on a rendezvous file, destroyed on exit."""
    import torch.distributed as tdist
    if tdist.is_initialized():
        yield
        return
    rdv = None
    if "WORLD_SIZE" in os.environ:
        tdist.init_process_group(backend)
    else:
        rdv = tempfile.mkdtemp(prefix="train-rdv-")
        tdist.init_process_group(backend, init_method=f"file://{rdv}/rdv",
                                 rank=0, world_size=1)
    try:
        yield
    finally:
        tdist.destroy_process_group()
        if rdv is not None:
            shutil.rmtree(rdv, ignore_errors=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--compress", action="store_true",
                    help="int8 gradient compression w/ error feedback")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default=None,
                    help="device to train on (default cuda)")
    args = ap.parse_args(argv)

    import torch

    from ..configs import _norm, get_config, get_module, get_smoke
    from ..device import resolve_device
    from ..dist.sharding import activation_sharding
    from ..models.common import count_params, tree_map
    from ..train import AdamW, cosine_schedule, init_train_state, \
        make_train_step
    from ..train.loop import LoopConfig, run_training
    from .mesh import make_mesh_from

    if _norm(args.arch) in _SERVING_ONLY:
        raise SystemExit(f"--arch {args.arch} is not trainable "
                         f"(family={_SERVING_ONLY[_norm(args.arch)]}); "
                         f"use launch/serve.py")
    mod = get_module(args.arch)
    family = mod.FAMILY
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    dev = resolve_device(args.device)

    with _process_group("nccl" if dev.type == "cuda" else "gloo"):
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        mesh = make_mesh_from(device_type=dev.type)
        sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
        print(f"[train] arch={args.arch} family={family} "
              f"mesh={sizes} smoke={args.smoke}")

        opt = AdamW(lr=cosine_schedule(peak_lr=args.lr, warmup_steps=20,
                                       total_steps=args.steps))
        gen = torch.Generator(device=dev).manual_seed(0)

        if family == "lm":
            from ..data.lm import lm_batches
            from ..models import transformer
            params = transformer.init_params(gen, cfg, device=dev)
            loss_fn = functools.partial(transformer.loss_fn, cfg)
            data = lm_batches(vocab_size=cfg.vocab_size, batch=args.batch,
                              seq_len=args.seq_len)
        elif family == "recsys":
            from ..data.clicklogs import ctr_batches, seq_rec_batches
            from ..models import recsys
            params = recsys.init_params(gen, cfg, device=dev)
            loss_fn = functools.partial(recsys.loss_fn, cfg)
            if cfg.model in ("dlrm", "autoint"):
                data = ctr_batches(vocab_sizes=cfg.vocab_sizes,
                                   n_dense=cfg.n_dense, batch=args.batch)
            else:
                data = seq_rec_batches(n_items=cfg.vocab_sizes[0],
                                       seq_len=cfg.seq_len, batch=args.batch,
                                       per_position=cfg.model == "sasrec")
        elif family == "gnn":
            from ..data.graphs import random_graph
            from ..models import egnn
            params = egnn.init_params(gen, cfg, device=dev)
            loss_fn = functools.partial(egnn.loss_fn, cfg)
            g = random_graph(200, 6, d_feat=cfg.d_feat, n_classes=cfg.n_out)

            def _gen():
                batch = {"node_feat": g.node_feat, "coords": g.coords,
                         "edges": g.edges.astype("int32"),
                         "labels": g.labels.astype("int32")}
                while True:
                    yield batch
            data = _gen()
        else:
            raise SystemExit(f"--arch {args.arch} is not trainable "
                             f"(family={family}); use launch/serve.py")

        print(f"[train] {count_params(params) / 1e6:.2f}M params")
        step = make_train_step(loss_fn, opt,
                               n_microbatches=args.microbatches,
                               compress=args.compress)
        state = init_train_state(params, opt, compress=args.compress)
        batches = (tree_map(lambda x: torch.as_tensor(x, device=dev), b)
                   for b in data)

        def log(s, m):
            print(f"[train] step {s:5d} loss {m['loss']:.4f} "
                  f"lr {m.get('lr', 0):.2e}", flush=True)

        loop = LoopConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                          ckpt_dir=args.ckpt_dir, metrics_cb=log,
                          log_every=10)
        with activation_sharding(mesh):
            run_training(step, (params, state), batches, loop)
    print("[train] done")


if __name__ == "__main__":
    main()
