"""Architecture config registry of the port: every architecture of the
JAX package's registry (dense, with and without MLA, moe, encoder, the
recurrent ssm and hybrid families, the audio encoder-decoder and the
vision model with gated cross-attention)."""

import importlib

from repro_torch.configs.base import INPUT_SHAPES, ArchConfig, InputShape

_MODULES = {
    "gemma3-1b": "gemma3_1b",
    "zamba2-7b": "zamba2_7b",
    "whisper-small": "whisper_small",
    "kimi-k2-1t-a32b": "kimi_k2",
    "rwkv6-1.6b": "rwkv6_1b6",
    "gemma2-9b": "gemma2_9b",
    "qwen2-moe-a2.7b": "qwen2_moe",
    "llama-3.2-vision-90b": "llama32_vision_90b",
    "gemma3-27b": "gemma3_27b",
    "minicpm3-4b": "minicpm3_4b",
    "bert-base": "bert_base",
}

ASSIGNED_ARCHS = tuple(k for k in _MODULES if k != "bert-base")


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


__all__ = [
    "ASSIGNED_ARCHS",
    "ArchConfig",
    "INPUT_SHAPES",
    "InputShape",
    "get_config",
    "get_smoke_config",
    "list_archs",
]
