#!/usr/bin/env python3
"""Time gemma3-1b's serving cells on the card, for comparing two trees.

    python3 tools/time_lm_serving.py --src SRC --label NAME \\
        [--seed 0] [--engine-only] [--out FILE]

Runs the timed part of ``chip_smoke.py``'s phase 12 through the
``repro_torch`` under ``SRC`` (a tree's ``src`` directory), with the
smoke's own functions and constants: params drawn from ``--seed`` on the
card and cast to bf16, then ``decode_32k`` (B = 128 over 32,768
positions) and ``long_500k`` (B = 1 over 524,288), each the median of the
smoke's timed steps by CUDA events with the host's enqueue included;
``prefill_32k`` at the smoke's cut batch; ``decode_32k`` over the int8
cache; and the ``DecodeEngine`` over the smoke's seeded requests (ms a
step on the host clock; the lockstep check is left to the smoke). The
engine is host-bound, so a change in the Python a step runs shows there
first; ``--engine-only`` runs the engine alone (no cells, no digests),
for many short turns.

It also checks the plain path's bits: eight ``decode_step`` calls at
B = 4 over 256 positions, bf16 and int8 cache, and a 64-token
``prefill``, on inputs drawn from ``--seed``; each result is summarised
by a SHA-256 of its bytes (logits, and every cache layer), so two trees
that compute the same bits print the same digests.

Run it on the trees to compare in one job, in turns (parent, change,
change, parent), so the card and its power limit are the same for both.
It prints one JSON line (``label``, ``src``, the card's ``nvidia-smi``
name and power limit, ``ms``, ``engine`` and ``digest``) and appends it to
``--out`` if given. Exits 2 without a CUDA device.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import subprocess
import sys
from dataclasses import replace
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CHECK_B, CHECK_S, CHECK_STEPS, CHECK_PROMPT = 4, 256, 8, 64


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _digest(torch, tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        t = t.detach().contiguous().cpu()
        h.update(t.view(torch.uint8).numpy().tobytes() if t.dtype
                 == torch.bfloat16 else t.numpy().tobytes())
    return h.hexdigest()[:16]


def _bits(torch, transformer, cfg, params, seed) -> dict:
    """SHA-256 digests of the plain path's decode (bf16 and int8 cache)
    and prefill results on small seeded inputs."""
    gen = torch.Generator(device="cuda").manual_seed(seed * 100 + 29)
    toks = torch.randint(0, cfg.vocab_size, (CHECK_STEPS, CHECK_B),
                         generator=gen, device="cuda", dtype=torch.int32)
    out = {}
    for name, c in (("decode", cfg), ("decode_int8",
                                      replace(cfg, kv_quant=True))):
        cache = transformer.init_decode_cache(c, CHECK_B, CHECK_S,
                                              dtype=torch.bfloat16,
                                              device="cuda")
        cache["pos"] = torch.zeros_like(cache["pos"])
        for t in range(CHECK_STEPS):
            logits, cache = transformer.decode_step(c, params, cache,
                                                    toks[t])
        out[name] = _digest(torch, [logits] + [
            x for k in ("k", "v", "k_scale", "v_scale")
            for x in cache.get(k, [])])
    prompt = torch.randint(0, cfg.vocab_size, (1, CHECK_PROMPT),
                           generator=gen, device="cuda", dtype=torch.int32)
    logits, cache = transformer.prefill(cfg, params, prompt)
    out["prefill"] = _digest(torch, [logits, cache["k"], cache["v"]])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", required=True)
    ap.add_argument("--label", required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--engine-only", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    cs = _smoke()
    src = str(Path(args.src).resolve())
    sys.path.insert(0, src)            # before the smoke's own src
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    import repro_torch
    from repro_torch import configs
    from repro_torch.configs.common import (LM_SHAPES, lm_decode_cell,
                                            lm_prefill_cell)
    from repro_torch.models import transformer
    if not repro_torch.__file__.startswith(src):
        raise SystemExit(f"imported {repro_torch.__file__}, not {src}")

    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    mesh, _ = cs.one_rank_mesh()
    ms, engine, digest = {}, None, None
    with torch.inference_mode():
        cfg = configs.get_config(cs.LM_ARCH)
        cells = {c.shape: c for c in configs.get_cells(cs.LM_ARCH)
                 if c.kind != "train"}
        gen = torch.Generator(device="cuda").manual_seed(
            args.seed * 100 + 12)
        params = cs.lm_cast(cfg, cells["decode_32k"].build(mesh)[1][0], gen)
        if not args.engine_only:
            for shape in ("decode_32k", "long_500k"):
                ms[shape] = cs.lm_decode_cell_run(cells[shape], params, gen,
                                                  mesh)["ms"]
                torch.cuda.empty_cache()
            seq = LM_SHAPES["prefill_32k"]["seq_len"]
            cut = lm_prefill_cell(cs.LM_ARCH, cfg, batch=cs.LM_PREFILL_B,
                                  seq_len=seq, shape_name="prefill_32k")
            ms["prefill_32k"] = cs.lm_prefill_cell_run(
                cells["prefill_32k"], cut, params, gen, mesh)["ms"]
            torch.cuda.empty_cache()
            q = lm_decode_cell(cs.LM_ARCH, replace(cfg, kv_quant=True),
                               batch=LM_SHAPES["decode_32k"]["global_batch"],
                               seq_len=LM_SHAPES["decode_32k"]["seq_len"],
                               shape_name="decode_32k")
            ms["decode_32k_int8"] = cs.lm_decode_cell_run(
                q, params, gen, mesh, note=" (int8 KV)")["ms"]
            torch.cuda.empty_cache()
        cs.ENGINE_LOCKSTEP = 0
        e = cs.lm_engine_run(cfg, params, args.seed, torch.device("cuda"))
        engine = {"steps": e["steps"], "ms_step": e["ms_step"],
                  "tokens_s": e["tokens_s"]}
        if not args.engine_only:
            digest = _bits(torch, transformer, cfg, params, args.seed)
    torch.distributed.destroy_process_group()
    rec = {"label": args.label, "src": args.src, "gpu": gpu, "ms": ms,
           "engine": engine, "digest": digest}
    line = json.dumps(rec)
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
