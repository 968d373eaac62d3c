#!/usr/bin/env python3
"""Where an LM serving step's time goes on the card, op by op.

    python3 tools/profile_lm.py [--out FILE]

For each cell of gemma3-1b at ``chip_smoke.py``'s phase 12 shapes
(``decode_32k`` B = 128 over 32,768 positions, ``long_500k`` B = 1 over
524,288, ``prefill_32k`` at B = 1, ``decode_32k_int8`` the int8 cache),
params drawn from seed 0 on the card and cast to bf16: one warm call,
then one call timed by CUDA events with the host's enqueue included (the
cell's latency), then one call under ``torch.profiler`` (CPU and CUDA
activity). It prints, per cell, that time, the device time summed over
the profiled call's kernels, and the ``TOP`` kernels by their device
time (name, launches, ms, share); and appends one JSON line a cell to
``--out`` if given. Every product is the port's ``models.transformer``,
as phase 12 runs it. Exits 2 without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from dataclasses import replace
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SEED = 0
CELLS = ("decode_32k", "long_500k", "prefill_32k", "decode_32k_int8")
TOP = 12                         # kernels listed a cell


def _event_ms(torch, fn) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def _call(torch, cell_name, cfg, params, gen):
    """A zero-argument call of one step of ``cell_name``, its state kept
    across calls (a decode cache moves on a position a call)."""
    from repro_torch.configs.common import LM_SHAPES
    from repro_torch.models import transformer
    dev = gen.device
    if cell_name == "prefill_32k":
        s = LM_SHAPES["prefill_32k"]["seq_len"]
        toks = torch.randint(0, cfg.vocab_size, (1, s), generator=gen,
                             device=dev, dtype=torch.int32)
        return lambda: transformer.prefill(cfg, params, toks)
    shape = "decode_32k" if cell_name.startswith("decode") else cell_name
    c = replace(cfg, kv_quant=cell_name.endswith("int8"))
    b = LM_SHAPES[shape]["global_batch"]
    cache = transformer.init_decode_cache(c, b, LM_SHAPES[shape]["seq_len"],
                                          device=dev)
    toks = torch.randint(0, cfg.vocab_size, (b,), generator=gen, device=dev,
                         dtype=torch.int32)
    state = {"cache": cache}

    def step():
        logits, state["cache"] = transformer.decode_step(c, params,
                                                         state["cache"], toks)
        return logits
    return step


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("profile_lm: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import configs
    from repro_torch.models import transformer
    from repro_torch.models.common import cast_tree
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"[card] {card}; torch {torch.__version__}", flush=True)
    dev = torch.device("cuda")
    cfg = configs.get_config("gemma3-1b")
    with torch.inference_mode():
        gen = torch.Generator(device=dev).manual_seed(SEED)
        params = cast_tree(transformer.init_params(gen, cfg, device=dev),
                           cfg.dtype)
        for name in CELLS:
            fn = _call(torch, name, cfg, params, gen)
            fn()
            host_ms = _event_ms(torch, fn)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            # the kernels alone: an aten op's row repeats its kernels'
            # time, and "Command Buffer Full" is the host waiting
            rows = [e for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA
                    and e.self_device_time_total > 0
                    and e.key != "Command Buffer Full"]
            total = sum(e.self_device_time_total for e in rows) / 1e3
            rows.sort(key=lambda e: -e.self_device_time_total)
            top = [dict(op=e.key, calls=e.count,
                        ms=e.self_device_time_total / 1e3)
                   for e in rows[:TOP]]
            print(f"[profile] {name}: {host_ms:.3f} ms with the enqueue, "
                  f"{total:.3f} ms summed over kernels (profiled call)",
                  flush=True)
            for t in top:
                print(f"[profile]   {t['ms']:9.3f} ms "
                      f"{t['ms'] / total if total else 0:6.1%} "
                      f"{t['calls']:6d} x {t['op'][:90]}", flush=True)
            if args.out is not None:
                with open(args.out, "a") as f:
                    f.write(json.dumps(dict(cell=name, card=card,
                                            host_ms=host_ms,
                                            kernel_ms=total, top=top)) + "\n")
            del fn
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
