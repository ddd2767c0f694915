"""Architecture config registry (``--arch <id>``)."""
from __future__ import annotations

import importlib

ARCHS = (
    "xlstm-125m",
    "deepseek-moe-16b",
    "llama4-maverick-400b-a17b",
    "gemma2-2b",
    "glm4-9b",
    "qwen1.5-110b",
    "gemma2-27b",
    "pixtral-12b",
    "seamless-m4t-large-v2",
    "zamba2-2.7b",
    "tspm-mlho",  # the paper's own downstream-classifier config
)

_MODULES = {a: a.replace("-", "_").replace(".", "_") for a in ARCHS}


def get_config(arch: str, reduced: bool = False):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.reduced() if reduced else mod.full()
