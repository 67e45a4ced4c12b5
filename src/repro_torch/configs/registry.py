"""Architecture registry: --arch <id> -> ArchConfig."""
from __future__ import annotations

import importlib

_MODULES = {
    "zamba2-1.2b": "zamba2_1p2b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "phi4-mini-3.8b": "phi4_mini_3p8b",
    "command-r-35b": "command_r_35b",
    "chatglm3-6b": "chatglm3_6b",
    "internlm2-1.8b": "internlm2_1p8b",
    "internvl2-26b": "internvl2_26b",
    "xlstm-125m": "xlstm_125m",
    "whisper-large-v3": "whisper_large_v3",
}

ARCH_IDS = tuple(_MODULES)


def _mod(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")


def get_config(name: str):
    return _mod(name).ARCH


def get_smoke_config(name: str):
    return _mod(name).smoke_config()
