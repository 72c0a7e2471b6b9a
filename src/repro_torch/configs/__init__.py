"""Architecture config registry of the port: the architectures of the
families it runs (dense, with and without MLA, moe and encoder). The
recurrent, audio and vision architectures join with their families."""

import importlib

from repro_torch.configs.base import ArchConfig

_MODULES = {
    "gemma3-1b": "gemma3_1b",
    "kimi-k2-1t-a32b": "kimi_k2",
    "gemma2-9b": "gemma2_9b",
    "qwen2-moe-a2.7b": "qwen2_moe",
    "gemma3-27b": "gemma3_27b",
    "minicpm3-4b": "minicpm3_4b",
    "bert-base": "bert_base",
}


def _mod(name: str):
    if name not in _MODULES:
        raise ValueError(f"unknown arch {name!r}; have {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")


def get_config(name: str) -> ArchConfig:
    return _mod(name).CONFIG


def get_smoke_config(name: str) -> ArchConfig:
    return _mod(name).SMOKE


def list_archs():
    return sorted(_MODULES)


__all__ = ["ArchConfig", "get_config", "get_smoke_config", "list_archs"]
