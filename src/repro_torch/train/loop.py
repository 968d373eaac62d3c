"""Fault-tolerant training loop.

The port's counterpart of ``repro.train.loop``:

* periodic checkpoints with atomic manifests (checkpoint.py) +
  ``auto-resume``: the loop entry point looks for the latest COMPLETE
  checkpoint and continues from there, so preemption between (or during)
  steps loses at most ``ckpt_every`` steps;
* step-level retry: a transient step failure (simulated in tests via an
  injected fault hook) is retried from the last known-good state rather
  than crashing the job — the step is functional, so the state it was
  given is untouched;
* a step is committed only after its loss has been read back to the host
  (``.item()``, which waits for the device: the counterpart of
  ``block_until_ready``), so an asynchronous device failure surfaces
  inside the retry;
* metrics emitted per step through a callback.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterator

from .checkpoint import (latest_complete_step, load_checkpoint,
                         save_checkpoint)


@dataclass
class LoopConfig:
    total_steps: int
    ckpt_every: int = 50
    ckpt_dir: str | None = None
    max_step_retries: int = 2
    log_every: int = 10
    metrics_cb: Callable[[int, dict], None] | None = None
    fault_hook: Callable[[int], None] | None = None   # tests inject faults


def run_training(train_step, state: tuple, batches: Iterator[dict],
                 cfg: LoopConfig) -> tuple:
    """Run (params, opt_state) through the loop with resume + retry.

    ``train_step(params, opt_state, batch) -> (params, opt_state, metrics)``
    must leave its arguments unchanged. Returns the final state.
    """
    params, opt_state = state
    start = 0
    if cfg.ckpt_dir:
        latest = latest_complete_step(cfg.ckpt_dir)
        if latest is not None:
            params, opt_state = load_checkpoint(
                cfg.ckpt_dir, latest, (params, opt_state))
            start = latest
    step = start
    while step < cfg.total_steps:
        batch = next(batches)
        for attempt in range(cfg.max_step_retries + 1):
            try:
                if cfg.fault_hook is not None:
                    cfg.fault_hook(step)
                new_params, new_opt, metrics = train_step(
                    params, opt_state, batch)
                # materialize before committing (surfaces async failures)
                metrics["loss"].item()
                params, opt_state = new_params, new_opt
                break
            except Exception:
                if attempt >= cfg.max_step_retries:
                    raise
                # retry from last good state (params/opt unchanged)
                continue
        step += 1
        if cfg.metrics_cb and (step % cfg.log_every == 0
                               or step == cfg.total_steps):
            cfg.metrics_cb(step, {k: float(v) for k, v in metrics.items()})
        if cfg.ckpt_dir and step % cfg.ckpt_every == 0:
            save_checkpoint(cfg.ckpt_dir, step, (params, opt_state))
    if cfg.ckpt_dir and step > start and step % cfg.ckpt_every != 0:
        save_checkpoint(cfg.ckpt_dir, step, (params, opt_state))
    return params, opt_state
