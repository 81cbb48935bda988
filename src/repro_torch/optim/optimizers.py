"""Functional optimizers over parameter trees (the port of
``repro.optim.optimizers``), with an explicit step index:

    state = opt.init(params)
    updates, state = opt.update(grads, state, params, step)
    params = apply_updates(params, updates)

``torch.optim`` is not used: the reference's step-index convention is part
of the parity contract. Adam's bias correction uses ``step + 1`` and its
rate ``lr(step)``, and the Co-Boosting generator restarts ``step`` at 0
every epoch while its moments carry over.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.config.train import TrainConfig
from repro_torch.optim.schedules import Schedule, make_schedule
from repro_torch.utils.trees import tree_leaves, tree_map

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


@dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any, int], Any]  # grads, state, params, step


def apply_updates(params: Any, updates: Any) -> Any:
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


def clip_by_global_norm(grads: Any, max_norm: float) -> Any:
    """Scale every gradient by ``min(1, max_norm / ‖grads‖₂)`` (the norm
    over all leaves, in f32). Stays on the device: no host read."""
    if max_norm <= 0:
        return grads
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in tree_leaves(grads)))
    scale = torch.clamp(max_norm / (gnorm + 1e-12), max=1.0)
    # as in the reference, a gradient below f32 is promoted by the f32 scale
    return tree_map(lambda g: g.to(torch.promote_types(g.dtype, torch.float32)) * scale, grads)


def sgd(lr: Schedule) -> Optimizer:
    def init(params):
        return ()

    def update(grads, state, params, step):
        lr_t = lr(step)
        return tree_map(lambda g: -lr_t * g, grads), state

    return Optimizer(init, update)


def sgdm(lr: Schedule, momentum: float = 0.9, weight_decay: float = 0.0, state_dtype: Optional[str] = None) -> Optimizer:
    """SGD with (heavy-ball) momentum — the paper's client/server optimizer.
    ``state_dtype`` (e.g. "bfloat16") stores the momentum slot at reduced
    precision; the accumulation itself is in f32."""

    def init(params):
        dt = DTYPES[state_dtype] if state_dtype else None
        return {"m": tree_map(lambda p: torch.zeros_like(p, dtype=dt or p.dtype), params)}

    def update(grads, state, params, step):
        if weight_decay:
            grads = tree_map(lambda g, p: g + weight_decay * p, grads, params)
        m = tree_map(lambda m_, g: (momentum * m_.float() + g.float()).to(m_.dtype), state["m"], grads)
        lr_t = lr(step)
        return tree_map(lambda m_: -lr_t * m_.float(), m), {"m": m}

    return Optimizer(init, update)


def _adam_core(lr: Schedule, b1: float, b2: float, eps: float, weight_decay: float, decoupled: bool) -> Optimizer:
    """Adam and AdamW. ``step`` is the caller's 0-based index: bias
    correction uses ``step + 1`` (in f32, as the reference computes it) and
    the rate ``lr(step)``. AdamW adds ``weight_decay·p`` to the update
    (decoupled); Adam adds it to the gradient."""

    def init(params):
        z = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
        return {"m": z, "v": tree_map(torch.zeros_like, z)}

    def update(grads, state, params, step):
        t = np.float32(step) + np.float32(1.0)
        if weight_decay and not decoupled:
            grads = tree_map(lambda g, p: g + weight_decay * p, grads, params)
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g.float(), state["m"], grads)
        v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * torch.square(g.float()), state["v"], grads)
        bc1 = float(np.float32(1.0) - np.float32(b1) ** t)
        bc2 = float(np.float32(1.0) - np.float32(b2) ** t)
        lr_t = lr(int(step))

        def u_fn(m_, v_, p):
            upd = (m_ / bc1) / (torch.sqrt(v_ / bc2) + eps)
            if weight_decay and decoupled:
                upd = upd + weight_decay * p.float()
            return (-lr_t * upd).to(p.dtype)

        return tree_map(u_fn, m, v, params), {"m": m, "v": v}

    return Optimizer(init, update)


def adam(lr: Schedule, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 0.0) -> Optimizer:
    return _adam_core(lr, b1, b2, eps, weight_decay, decoupled=False)


def adamw(lr: Schedule, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 0.01) -> Optimizer:
    return _adam_core(lr, b1, b2, eps, weight_decay, decoupled=True)


def make_optimizer(cfg: TrainConfig) -> Optimizer:
    lr = make_schedule(cfg)
    if cfg.optimizer == "sgd":
        return sgd(lr)
    if cfg.optimizer == "sgdm":
        return sgdm(lr, cfg.momentum, cfg.weight_decay, state_dtype=cfg.state_dtype or None)
    if cfg.optimizer == "adam":
        return adam(lr, cfg.beta1, cfg.beta2, cfg.eps, cfg.weight_decay)
    if cfg.optimizer == "adamw":
        return adamw(lr, cfg.beta1, cfg.beta2, cfg.eps, cfg.weight_decay)
    raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
