"""Architecture registry (the port's copy of ``repro.config.registry``).

Configs register themselves at import; :func:`get_arch` imports
:mod:`repro_torch.configs` on first use. Arch ids use dashes. Every
architecture the JAX package registers is ported; one named in
``NOT_PORTED`` would raise ``NotImplementedError``, an unknown one raises
``KeyError``. Nothing falls back to another architecture.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.config.model import ModelConfig
from repro_torch.config.shapes import ShapeConfig

_REGISTRY: Dict[str, ModelConfig] = {}

#: Architectures of the JAX package that the port does not serve yet.
NOT_PORTED: tuple = ()


def register_arch(cfg: ModelConfig) -> ModelConfig:
    cfg.validate()
    _REGISTRY[cfg.name] = cfg
    return cfg


def _ensure_loaded() -> None:
    if not _REGISTRY:
        importlib.import_module("repro_torch.configs")


def get_arch(name: str) -> ModelConfig:
    _ensure_loaded()
    key = name.replace("_", "-")
    if key in _REGISTRY:
        return _REGISTRY[key]
    if key in NOT_PORTED:
        raise NotImplementedError(f"arch {name!r} is not ported yet; ported: {sorted(_REGISTRY)}")
    raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")


def list_archs() -> List[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


def arch_supports_shape(cfg: ModelConfig, shape: ShapeConfig) -> str:
    """Return "" if supported, else a human-readable skip reason, by the
    reference's rules:

      * encoder-only archs have no decode step;
      * long_500k decode requires a sub-quadratic path (SSM state or SWA).
    """
    if cfg.is_encoder_only and shape.kind == "decode":
        return "encoder-only: no autoregressive decode step"
    if shape.kind == "decode" and shape.seq_len > 100_000 and not cfg.is_subquadratic:
        return "long_500k needs sub-quadratic attention (no SWA/SSM path)"
    return ""
