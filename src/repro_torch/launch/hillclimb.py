"""The hillclimb: named variants of the three chosen cells.

The port's counterpart of ``repro.launch.hillclimb``. Each variant encodes
one hypothesis (sharding scheme, microbatch count, dtype, top-k
structure) and is a cell of its own: ``launch.dryrun.run_cell`` traces it
on the 16 × 16 production mesh of a ``fake`` process group of 256 ranks
(``main`` starts the group in its own process; importing this module
starts none), and its record goes under ``<cell>#<variant>@16x16`` in
``build/hillclimb_torch.json``, saved after each variant, to be read
beside the base cells' records in the dry run's
``build/dryrun_torch.json``:

* ``qwen3-8b/decode_32k``: the int8 KV cache;
* ``qwen3-8b/train_4k``: fewer microbatches, and the same 256 ranks
  re-meshed as dp64 × tp4 and dp256 × tp1 (``configs.common.
  remesh_dp_tp``);
* ``mixtral-8x22b/train_4k``: microbatches and re-meshes together;
* ``bm25s/score_blocked_2m``: the shard-aligned two-stage top-k, in f32
  and with bf16 scores and weights (K6's and K5's bf16 instantiations),
  and a 4× query batch.

Usage (CPU, no card):
    PYTHONPATH=src python -m repro_torch.launch.hillclimb \\
        --cell qwen3-8b/train_4k --variant dp64tp4
    PYTHONPATH=src python -m repro_torch.launch.hillclimb --all
"""

from __future__ import annotations

import argparse
import traceback
from dataclasses import replace


def _variants() -> dict:
    """``{cell key: {variant name: Cell}}``, the reference's variants
    name for name."""
    import torch

    from ..configs import bm25s as bm25s_cfg
    from ..configs import mixtral_8x22b, qwen3_8b
    from ..configs.common import lm_decode_cell, lm_train_cell, remesh_dp_tp

    v = {}

    # qwen3-8b/decode_32k (memory-bound): int8 KV cache
    v["qwen3-8b/decode_32k"] = {
        "kv_int8": lm_decode_cell(
            "qwen3-8b", replace(qwen3_8b.CONFIG, kv_quant=True),
            batch=128, seq_len=32768, shape_name="decode_32k",
            note="int8 KV cache, per-(pos, head) scales"),
    }

    # qwen3-8b/train_4k: dense-LM TP collectives dominate
    q = qwen3_8b.CONFIG
    v["qwen3-8b/train_4k"] = {
        "mb2": lm_train_cell("qwen3-8b", q, global_batch=256, seq_len=4096,
                             n_microbatches=2, note="mb 4->2"),
        "dp64tp4": lm_train_cell(
            "qwen3-8b", q, global_batch=256, seq_len=4096, n_microbatches=4,
            remesh=remesh_dp_tp(64, 4), note="remesh dp64 tp4"),
        "dp256tp1": lm_train_cell(
            "qwen3-8b", q, global_batch=256, seq_len=4096, n_microbatches=4,
            remesh=remesh_dp_tp(256, 1), note="remesh dp256 tp1 (pure FSDP)"),
        "dp256tp1_mb1": lm_train_cell(
            "qwen3-8b", q, global_batch=256, seq_len=4096, n_microbatches=1,
            remesh=remesh_dp_tp(256, 1),
            note="pure FSDP + single microbatch (gathers once)"),
    }

    # mixtral-8x22b/train_4k: the most collective-bound cell
    m = mixtral_8x22b.CONFIG
    v["mixtral-8x22b/train_4k"] = {
        "mb4": lm_train_cell("mixtral-8x22b", m, global_batch=256,
                             seq_len=4096, n_microbatches=4,
                             note="mb 8->4 (halve FSDP re-gathers)"),
        "dp64tp4_mb4": lm_train_cell(
            "mixtral-8x22b", m, global_batch=256, seq_len=4096,
            n_microbatches=4, remesh=remesh_dp_tp(64, 4),
            note="remesh dp64 tp4 + mb4"),
        "dp32tp8_mb4": lm_train_cell(
            "mixtral-8x22b", m, global_batch=256, seq_len=4096,
            n_microbatches=4, remesh=remesh_dp_tp(32, 8),
            note="remesh dp32 tp8 + mb4"),
        "dp32tp8_mb2": lm_train_cell(
            "mixtral-8x22b", m, global_batch=256, seq_len=4096,
            n_microbatches=2, remesh=remesh_dp_tp(32, 8),
            note="remesh dp32 tp8 + mb2 (halve weight re-gathers again)"),
        "dp64tp4_mb2": lm_train_cell(
            "mixtral-8x22b", m, global_batch=256, seq_len=4096,
            n_microbatches=2, remesh=remesh_dp_tp(64, 4),
            note="remesh dp64 tp4 + mb2"),
    }

    # bm25s/score_blocked_2m: the paper's technique, batched
    v["bm25s/score_blocked_2m"] = {
        "topk2stage": bm25s_cfg._score_blocked_cell(
            sharded_topk=True, note="shard-aligned 2-stage top-k"),
        "topk2stage_bf16": bm25s_cfg._score_blocked_cell(
            sharded_topk=True, score_dtype=torch.bfloat16,
            note="2-stage top-k + bf16 scores/weights"),
        "topk2stage_bf16_b1024": bm25s_cfg._score_blocked_cell(
            sharded_topk=True, score_dtype=torch.bfloat16, batch=1024,
            u_max=4096, note="+ 4x query batch (amortize posting reads)"),
    }
    return v


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", default=None)
    ap.add_argument("--variant", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="build/hillclimb_torch.json")
    ap.add_argument("--world", type=int, default=256,
                    help="ranks of the fake group: 256 for the 16 x 16 "
                         "production mesh; fewer (a power of two) for "
                         "make_mesh_from's mesh over them")
    args = ap.parse_args(argv)

    from .dryrun import fake_group, load_results, run_cell, save_result
    from .mesh import make_mesh_from, make_production_mesh

    variants = _variants()
    if args.all:
        todo = [(cell_key, name, c) for cell_key, vs in variants.items()
                for name, c in vs.items()]
    elif args.cell:
        vs = variants[args.cell]
        names = [args.variant] if args.variant else list(vs)
        todo = [(args.cell, n, vs[n]) for n in names]
    else:
        ap.error("--cell or --all required")

    done = load_results(args.out)
    with fake_group(args.world):
        if args.world == 256:
            mesh = make_production_mesh(multi_pod=False, device_type="cpu")
        else:
            mesh = make_mesh_from(device_type="cpu")
        tag = "x".join(str(s) for s in mesh.shape)
        for cell_key, name, cell in todo:
            key = f"{cell_key}#{name}@{tag}"
            if key in done and done[key].get("ok"):
                print(f"[hillclimb] skip {key}", flush=True)
                continue
            try:
                rec = run_cell(cell, mesh)
                rec["variant"] = name
            except Exception as e:  # record failures, keep climbing
                rec = {"ok": False, "variant": name, "error": repr(e),
                       "traceback": traceback.format_exc()[-1500:]}
                print(f"[hillclimb] FAIL {key}: {e!r}", flush=True)
            save_result(args.out, key, rec)


if __name__ == "__main__":
    main()
