#!/usr/bin/env python3
"""Time K7 and K8 at phase 7's shapes, for comparing two trees.

    python3 tools/time_sparse_kernels.py --src SRC --label NAME \\
        [--seed 0] [--kernels K7 K8] [--out FILE]

The operands are ``chip_smoke.py``'s phase 7, rebuilt on the card from
``--seed`` by the smoke's own functions: K7 (``block_segment_sum``)
aggregates 64-wide f32 messages over the ogb_products graph blocked by
destination (``blocked_by_destination``), K8 (``embedding_bag``) takes the
mean of Reddit's 602-wide feature rows over the hop-1 ``[1024, 15]`` and
hop-2 ``[15360, 10]`` bags of a (15, 10) sample (``sample_bags``). K7 is
also timed at phase 2's shapes past 7,056 segments (S = 10,000 at D = 64
and S = 50,000 at D = 20, S cut into ranges).

Each kernel runs through the public wrapper of the ``repro_torch`` under
``SRC`` (a tree's ``src`` directory, whose kernels it builds), after one
warm call, by CUDA events, with the calls queued behind a
``torch.cuda._sleep`` so that the events time the device and not the
host's enqueue: K7 as the mean of three calls; K8 per call, L2-warm (the
mean of 20 calls back to back) and L2-cold (a 256 MiB buffer written
between launches, each launch timed alone, the mean of 20), beside
``F.embedding_bag(mode="sum", per_sample_weights=...)`` timed the same two
ways. Hop-1's rows (36 MB) fit in the 50 MB L2, so the warm time is that
of a caller that reads the same rows again, the cold time that of one that
samples fresh nodes. K8 and the library call also get ``host``: the host
milliseconds a call takes to enqueue (20 calls, no synchronisation), which
is what back-to-back calls of tens of microseconds wait for. Every output
is summarised by a checksum of its bits, so two trees' results can be
compared.

Run it on the trees to compare in one job, in turns (parent, change,
change, parent), so the card and its power limit are the same for both.
It prints one JSON line (``label``, ``src``, the card's ``nvidia-smi``
name and power limit, ``ms`` and ``checksum``) and appends it to
``--out`` if given. Exits 2 without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FLUSH_BYTES = 256 << 20          # > 5x the H100's 50 MB L2
K8_REPS = 20
SLEEP_CYCLES = 50_000_000        # ~25 ms of device time: the host queues


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean device milliseconds of ``fn()`` over ``reps`` calls back to
    back, after one warm call, by CUDA events; the calls are queued behind
    a sleep on the device, so the host's enqueue is not timed."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def cold_ms(torch, fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` alone with the L2 flushed before each
    call (a ``FLUSH_BYTES`` buffer written), by CUDA events."""
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32,
                        device="cuda")
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    events = []
    for _ in range(reps):
        flush.fill_(1.0)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / reps


def host_ms(torch, fn, reps: int) -> float:
    """Mean host milliseconds to enqueue ``fn()`` (no synchronisation)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return t


def checksum(torch, out) -> int:
    """Sum of the output's 32- or 16-bit patterns, as a Python int."""
    flat = out.reshape(-1)
    bits = flat.view(torch.int32 if flat.dtype == torch.float32
                     else torch.int16)
    step = 1 << 26
    return sum(int(bits[i:i + step].long().sum())
               for i in range(0, bits.numel(), step))


def time_k7(torch, cs, seed: int) -> tuple[dict, dict]:
    import numpy as np

    from repro_torch.data.graphs import random_graph
    from repro_torch.kernels import block_segment_sum as k7
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    g = random_graph(**cs.PRODUCTS, seed=seed)
    dst = torch.as_tensor(np.ascontiguousarray(g.edges[:, 1]), device=dev)
    del g
    values, ids, _ = cs.blocked_by_destination(dst, cs.PRODUCTS["n_nodes"],
                                               gen)
    del dst

    def run():
        return k7.block_segment_sum(values, ids, num_segments=cs.SEG_BLOCK,
                                    tile_p=cs.SEG_TILE_P)

    ms = {"ogb_products": cuda_ms(torch, run, 3)}
    sums = {"ogb_products": checksum(torch, run())}
    del values, ids
    torch.cuda.empty_cache()
    rng = np.random.default_rng(seed + 16)
    for s_len, d in ((10_000, 64), (50_000, 20)):   # phase 2's S split
        vals = rng.normal(size=(3, 2048, d)).astype(np.float32)
        sid = rng.integers(0, s_len, size=(3, 2048)).astype(np.int32)
        sid[1].sort()
        sid[:, ::7] = -1
        vals[:, 5::13] = 0.0
        vt, it = torch.as_tensor(vals, device=dev), torch.as_tensor(
            sid, device=dev)

        def run_s(vt=vt, it=it, s_len=s_len):
            return k7.block_segment_sum(vt, it, num_segments=s_len,
                                        tile_p=512)

        ms[f"S{s_len}_D{d}"] = cuda_ms(torch, run_s, 20)
        sums[f"S{s_len}_D{d}"] = checksum(torch, run_s())
    return ms, sums


def time_k8(torch, cs, seed: int) -> tuple[dict, dict]:
    import numpy as np
    import torch.nn.functional as F

    from repro_torch.data.graphs import random_graph
    from repro_torch.kernels.embedding_bag import embedding_bag as k8
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed + 7)
    gr = random_graph(**cs.REDDIT, seed=seed)
    hop1, hop2, _ = cs.sample_bags(gr, rng)
    table = torch.as_tensor(gr.node_feat, device=dev)
    del gr
    ms, sums = {}, {}
    for name, bag in (("hop1", hop1), ("hop2", hop2)):
        b_dev = torch.as_tensor(bag, device=dev)
        w_dev = torch.as_tensor(cs.mean_weights(bag), device=dev)
        valid = b_dev >= 0
        safe = torch.where(valid, b_dev, 0).long()
        w_lib = w_dev * valid

        def run(b_dev=b_dev, w_dev=w_dev):
            return k8(table, b_dev, w_dev)

        def lib(safe=safe, w_lib=w_lib):
            return F.embedding_bag(safe, table, per_sample_weights=w_lib,
                                   mode="sum")

        ms[name] = {"warm": cuda_ms(torch, run, K8_REPS),
                    "cold": cold_ms(torch, run, K8_REPS),
                    "host": host_ms(torch, run, K8_REPS),
                    "library_warm": cuda_ms(torch, lib, K8_REPS),
                    "library_cold": cold_ms(torch, lib, K8_REPS),
                    "library_host": host_ms(torch, lib, K8_REPS)}
        sums[name] = checksum(torch, run())
    return ms, sums


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", type=Path, required=True,
                    help="the src directory of the tree to time")
    ap.add_argument("--label", required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kernels", nargs="+", default=["K7", "K8"],
                    choices=["K7", "K8"])
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("time_sparse_kernels: no CUDA device", file=sys.stderr)
        return 2
    # the timed tree's package first: chip_smoke (imported for its operand
    # functions) puts this checkout's src on the path, which no longer
    # matters once repro_torch is imported
    sys.path.insert(0, str(args.src.resolve()))
    import repro_torch
    from repro_torch.kernels import _build
    _build.build_all(("block_segment_sum", "embedding_bag"))
    sys.path.append(str(ROOT))
    import chip_smoke as cs

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    ms, sums = {}, {}
    for name, fn in (("K7", time_k7), ("K8", time_k8)):
        if name in args.kernels:
            ms[name], sums[name] = fn(torch, cs, args.seed)
            torch.cuda.empty_cache()
    line = json.dumps({"label": args.label, "src": repro_torch.__file__,
                       "card": card, "torch": torch.__version__,
                       "ms": ms, "checksum": sums})
    print(line, flush=True)
    if args.out is not None:
        with args.out.open("a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
