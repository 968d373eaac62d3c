"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o _build/<name>-<hash>.so csrc/<name>.cu

The library lands in ``kernels/_build/`` (listed in ``.gitignore``) under
a name keyed by a hash of its sources and flags, so an edited source is
rebuilt and an unchanged one is reused. Builds happen at first use, or all
at once with :func:`build_all` (one ``nvcc`` process per source, started
together). Nothing here runs at import time: the CPU tests import every
module of the port on a machine with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).with_name("_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas", "-v")
SOURCES = ("bm25_resident", "bm25_block_score", "bm25_gather_score",
           "blockwise_topk", "block_segment_sum", "embedding_bag")
SMEM_LIMIT = 232448       # dynamic shared memory a CTA may use on Hopper

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, /usr/local/cuda, PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA "
                           "kernels of repro_torch are built at first use")
    return found


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to (keyed by sources and flags)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names=SOURCES) -> dict[str, dict]:
    """Compile every listed source that is not built yet, all in parallel.

    Returns ``{name: {"seconds": float, "ptxas": str}}`` for the sources
    it compiled (``ptxas`` holds the registers / shared memory / spill
    report of ``-Xptxas -v``). Raises ``RuntimeError`` with the compiler's
    output if any build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    report, failed = {}, []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        os.replace(tmp, out)      # atomic: a concurrent loader sees all
        report[name] = {"seconds": secs, "ptxas": log}
    if failed:
        raise RuntimeError("\n".join(failed))
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build_all([name])
            lib = _libs[name] = ctypes.CDLL(str(path))
        return lib


class LaunchCounter:
    """Launches of one kernel wrapper: ``n`` grows by one (:meth:`add`)
    where the wrapper launches its kernel, and nowhere else (the plain twin
    on a CPU tensor does not count). ``chip_smoke.py`` resets it before the
    main path and reads it after, to show the path went through the
    kernel. The engine's pool and the watchdog launch from several
    threads, so the count changes under a lock."""

    def __init__(self, name: str):
        self.name = name
        self.n = 0
        self._lock = threading.Lock()

    def add(self) -> None:
        with self._lock:
            self.n += 1

    def reset(self) -> None:
        with self._lock:
            self.n = 0


def check(err: int, what: str) -> None:
    """Raise if a launch function returned a non-zero CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
