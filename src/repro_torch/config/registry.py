"""Architecture registry (the port's copy of ``repro.config.registry``).

Configs register themselves at import; :func:`get_arch` imports
:mod:`repro_torch.configs` on first use. Arch ids use dashes. An
architecture the JAX package registers but the port has not ported yet
raises; nothing falls back to another architecture.
"""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.config.model import ModelConfig

_REGISTRY: Dict[str, ModelConfig] = {}

#: Architectures of the JAX package that the port does not serve yet.
NOT_PORTED = (
    "granite-3-2b",
    "hubert-xlarge",
    "internlm2-20b",
    "jamba-v0.1-52b",
    "mixtral-8x7b",
    "phi-3-vision-4.2b",
    "qwen3-32b",
    "qwen3-moe-235b-a22b",
    "xlstm-125m",
)


def register_arch(cfg: ModelConfig) -> ModelConfig:
    cfg.validate()
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ModelConfig:
    if not _REGISTRY:
        importlib.import_module("repro_torch.configs")
    key = name.replace("_", "-")
    if key in _REGISTRY:
        return _REGISTRY[key]
    if key in NOT_PORTED:
        raise NotImplementedError(f"arch {name!r} is not ported yet; ported: {sorted(_REGISTRY)}")
    raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
