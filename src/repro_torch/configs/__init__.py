"""Architecture registry of the port: ``get_config(arch)`` resolves each
of the reference's ten architectures.  Each module defines ``CONFIG``
(the published configuration) and ``REDUCED`` (a same-family miniature
for CPU tests)."""

from __future__ import annotations

from importlib import import_module

from ..models.config import ModelConfig

_ARCH_MODULES = {
    "qwen3-4b": "qwen3_4b",
    "stablelm-1.6b": "stablelm_1_6b",
    "gemma3-1b": "gemma3_1b",
    "command-r-plus-104b": "command_r_plus_104b",
    "internvl2-1b": "internvl2_1b",
    "mixtral-8x7b": "mixtral_8x7b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "hymba-1.5b": "hymba_1_5b",
    "rwkv6-3b": "rwkv6_3b",
    "whisper-tiny": "whisper_tiny",
}

ARCH_IDS = list(_ARCH_MODULES)


def get_config(arch: str, *, reduced: bool = False) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; choose from {ARCH_IDS}")
    mod = import_module(f".{_ARCH_MODULES[arch]}", __package__)
    return mod.REDUCED if reduced else mod.CONFIG
