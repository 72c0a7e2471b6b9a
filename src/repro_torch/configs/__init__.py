"""Architecture config registry of the port. Holds the architectures whose
slices have been ported; the others join with their model families."""

import importlib

from repro_torch.configs.base import ArchConfig

_MODULES = {
    "bert-base": "bert_base",
    "gemma3-1b": "gemma3_1b",
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
