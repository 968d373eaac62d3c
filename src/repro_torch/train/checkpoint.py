"""Sharded checkpointing with atomic manifests and corruption fallback.

The port's counterpart of ``repro.train.checkpoint``, with its on-disk
format, so a checkpoint written by either package loads in the other.
Layout (one directory per step):

    ckpt_dir/
      step_000120/
        host_000.npz          (this host's shard of every leaf)
        MANIFEST.json         (written LAST, atomically — marks complete)

A step is written into ``step_NNNNNN.tmp`` and renamed into place with
``os.replace``; leaves are keyed by their ``/``-joined path (dict keys,
list and tuple indices), as ``jax.tree_util`` paths are.
``latest_complete_step`` only considers steps whose manifest exists and
whose files pass a size check, so a preempted or corrupted write falls
back to the previous step.

Each process writes its own ``host_{rank}.npz``: ``rank`` is the
``torch.distributed`` rank when a process group is up, else 0.
"""

from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch

from ..models.common import tree_paths, tree_unflatten


def _process() -> tuple[int, int]:
    """(this process's index, the number of processes)."""
    import torch.distributed as tdist
    if tdist.is_available() and tdist.is_initialized():
        return tdist.get_rank(), tdist.get_world_size()
    return 0, 1


def _key(path) -> str:
    return "/".join(str(p) for p in path)


def _flatten(tree) -> dict[str, np.ndarray]:
    return {_key(path): leaf.detach().cpu().numpy()
            if isinstance(leaf, torch.Tensor) else np.asarray(leaf)
            for path, leaf in tree_paths(tree)}


def save_checkpoint(ckpt_dir: str, step: int, state) -> str:
    """Write state for ``step``; manifest written last + atomic rename."""
    d = os.path.join(ckpt_dir, f"step_{step:06d}")
    tmp = d + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    flat = _flatten(state)
    host, n_hosts = _process()
    fname = os.path.join(tmp, f"host_{host:03d}.npz")
    np.savez(fname, **flat)
    manifest = {
        "step": step,
        "n_hosts": n_hosts,
        "files": {f"host_{host:03d}.npz": os.path.getsize(fname)},
        "keys": sorted(flat),
    }
    with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(d):
        shutil.rmtree(d)
    os.replace(tmp, d)
    return d


def _is_complete(d: str) -> bool:
    man = os.path.join(d, "MANIFEST.json")
    if not os.path.exists(man):
        return False
    try:
        with open(man) as f:
            m = json.load(f)
        for fname, size in m["files"].items():
            p = os.path.join(d, fname)
            if not os.path.exists(p) or os.path.getsize(p) != size:
                return False
        return True
    except (json.JSONDecodeError, KeyError, OSError):
        return False


def latest_complete_step(ckpt_dir: str) -> int | None:
    """Newest step with a complete, size-verified manifest (else older)."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = sorted(
        (int(n.split("_")[1]) for n in os.listdir(ckpt_dir)
         if n.startswith("step_") and not n.endswith(".tmp")),
        reverse=True)
    for s in steps:
        if _is_complete(os.path.join(ckpt_dir, f"step_{s:06d}")):
            return s
    return None


def load_checkpoint(ckpt_dir: str, step: int, state_like):
    """Restore into the structure of ``state_like`` (values replaced):
    each leaf a tensor of the file's dtype on its ``state_like`` leaf's
    device."""
    d = os.path.join(ckpt_dir, f"step_{step:06d}")
    host, _ = _process()
    leaves = []
    with np.load(os.path.join(d, f"host_{host:03d}.npz")) as arrs:
        for path, like in tree_paths(state_like):
            a = torch.from_numpy(arrs[_key(path)])   # a fresh array
            leaves.append(a.to(like.device)
                          if isinstance(like, torch.Tensor) else a)
    return tree_unflatten(state_like, leaves)
