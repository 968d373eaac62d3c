#!/usr/bin/env python3
"""Time K2 and K4 on saved operands at several k, for comparing two trees.

    python3 chip_smoke.py --save-board-operands build/board_ops
    python3 tools/time_board_kernels.py build/board_ops --src SRC \\
        --label NAME [--k 1 100 200] [--out FILE]

``chip_smoke.py --save-board-operands`` writes the operands of K2
(``bm25_block_score_topk``, the full-width retriever's blocked index and
one batch's query table) and K4 (``bm25_gather_score_topk``, shard 0's
host-rung gather) from its phase 5. This script loads them on the card
and times each kernel through the public wrapper of the ``repro_torch``
under ``SRC`` (a tree's ``src`` directory, whose kernels it builds) at
each k: one warm call, then the mean of three calls by CUDA events. Run
it on the trees to compare in one job, in turns (parent, change, change,
parent), so the card and its power limit are the same for both. It
prints one JSON line (``label``, ``src``, the card's ``nvidia-smi`` name
and power limit, and ``{"K2": {k: ms}, "K4": {k: ms}}``) and appends it
to ``--out`` if given. Exits 2 without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path


def cuda_ms(torch, fn, reps: int = 3) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` calls after one warm
    call, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("operands", type=Path,
                    help="directory of k2.pt and k4.pt")
    ap.add_argument("--src", type=Path, required=True,
                    help="the src directory of the tree to time")
    ap.add_argument("--label", required=True)
    ap.add_argument("--k", type=int, nargs="+", default=[1, 100, 200])
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("time_board_kernels: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.src.resolve()))
    import repro_torch
    from repro_torch.kernels import bm25_block_score as k2
    from repro_torch.kernels import bm25_gather_score as k4

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    times = {}
    for name, fn, path in (("K2", k2.bm25_block_score_topk, "k2.pt"),
                           ("K4", k4.bm25_gather_score_topk, "k4.pt")):
        saved = torch.load(args.operands / path, map_location="cuda")
        ops, kw = saved["ops"], saved["kw"]
        times[name] = {
            k: cuda_ms(torch, lambda k=k: fn(*ops, **dict(kw, k=k)))
            for k in args.k}
        del saved, ops
        torch.cuda.empty_cache()
    line = json.dumps({"label": args.label, "src": repro_torch.__file__,
                       "card": card, "ms": times})
    print(line, flush=True)
    if args.out is not None:
        with args.out.open("a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
