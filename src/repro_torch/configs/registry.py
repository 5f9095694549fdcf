"""Architecture registry: --arch <id> -> (full config, smoke config)."""
from __future__ import annotations

import importlib

_MODULES = {
    "mamba2-130m": "mamba2_130m",
    "mistral-large-123b": "mistral_large_123b",
    "qwen1.5-0.5b": "qwen1_5_0_5b",
    "qwen2.5-14b": "qwen2_5_14b",
    "stablelm-3b": "stablelm_3b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "internvl2-76b": "internvl2_76b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "granite-moe-1b-a400m": "granite_moe_1b",
    "whisper-tiny": "whisper_tiny",
}

ARCHS = tuple(_MODULES)


def get_config(arch: str, smoke: bool = False):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCHS}")
    mod = importlib.import_module(f".{_MODULES[arch]}", __package__)
    return mod.SMOKE if smoke else mod.CONFIG
