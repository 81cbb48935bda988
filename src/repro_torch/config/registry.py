"""Architecture registry (the port's copy of ``repro.config.registry``).

Configs register themselves at import; :func:`get_arch` imports
:mod:`repro_torch.configs` on first use. Arch ids use dashes. Every
architecture the JAX package registers is ported; one named in
``NOT_PORTED`` would raise ``NotImplementedError``, an unknown one raises
``KeyError``. Nothing falls back to another architecture.
"""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.config.model import ModelConfig

_REGISTRY: Dict[str, ModelConfig] = {}

#: Architectures of the JAX package that the port does not serve yet.
NOT_PORTED: tuple = ()


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
