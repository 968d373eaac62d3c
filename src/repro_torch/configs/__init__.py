"""Architecture registry: ``--arch <id>`` resolves here.

The port's counterpart of ``repro.configs``: ten assigned architectures
(the LM family, EGNN, the recsys family) + the paper's own (``bm25s``).
Each module exposes ``CONFIG`` (exact published config), ``SMOKE``
(reduced same-family variant for CPU tests), ``FAMILY`` and ``cells()``
(the cells for its assigned input shapes).
"""

from __future__ import annotations

import importlib

_ARCH_MODULES = {
    "h2o-danube3-4b": "h2o_danube3_4b",
    "gemma3-1b": "gemma3_1b",
    "qwen3-8b": "qwen3_8b",
    "mixtral-8x22b": "mixtral_8x22b",
    "mixtral-8x7b": "mixtral_8x7b",
    "egnn": "egnn",
    "autoint": "autoint",
    "mind": "mind",
    "dlrm-mlperf": "dlrm_mlperf",
    "sasrec": "sasrec",
    "bm25s": "bm25s",
}

ASSIGNED_ARCHS = [a for a in _ARCH_MODULES if a != "bm25s"]


def _norm(name: str) -> str:
    return name.replace("_", "-").replace("h2o-danube-3", "h2o-danube3")


def get_module(arch: str):
    key = _norm(arch)
    if key not in _ARCH_MODULES:
        raise ValueError(f"unknown arch {arch!r}; available: "
                         f"{sorted(_ARCH_MODULES)}")
    return importlib.import_module(f".{_ARCH_MODULES[key]}", __package__)


def get_config(arch: str):
    return get_module(arch).CONFIG


def get_smoke(arch: str):
    return get_module(arch).SMOKE


def get_cells(arch: str):
    return get_module(arch).cells()


def all_cells(include_extra: bool = True):
    archs = list(_ARCH_MODULES) if include_extra else ASSIGNED_ARCHS
    out = []
    for a in archs:
        out.extend(get_cells(a))
    return out


def list_archs() -> list[str]:
    return list(_ARCH_MODULES)
