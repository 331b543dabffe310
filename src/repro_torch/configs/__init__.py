"""Architecture config registry.

Each assigned architecture has its own module exporting ``CONFIG`` (the
JAX package's values, copied); the registry maps ``--arch <id>`` to it.
``reduce_for_smoke`` produces the tiny same-family config used by the
smoke tests; ``input_specs`` the ``meta`` stand-ins of a cell's inputs.
"""

from __future__ import annotations

import importlib

from .base import (ModelConfig, SHAPE_CELLS, input_specs,  # noqa: F401
                   reduce_for_smoke)

ARCHS = (
    "gemma2-2b",
    "gemma3-4b",
    "h2o-danube-1.8b",
    "starcoder2-15b",
    "olmoe-1b-7b",
    "llama4-maverick-400b-a17b",
    "qwen2-vl-7b",
    "whisper-tiny",
    "zamba2-7b",
    "rwkv6-7b",
)

_MODULES = {
    "gemma2-2b": "gemma2_2b",
    "gemma3-4b": "gemma3_4b",
    "h2o-danube-1.8b": "h2o_danube_1p8b",
    "starcoder2-15b": "starcoder2_15b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "llama4-maverick-400b-a17b": "llama4_maverick",
    "qwen2-vl-7b": "qwen2_vl_7b",
    "whisper-tiny": "whisper_tiny",
    "zamba2-7b": "zamba2_7b",
    "rwkv6-7b": "rwkv6_7b",
}


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; choose from {ARCHS}")
    mod = importlib.import_module(f".{_MODULES[arch]}", __package__)
    return mod.CONFIG
