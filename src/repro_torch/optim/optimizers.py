"""Functional optimizers over parameter trees (the port of
``repro.optim.optimizers``), with an explicit step index:

    state = opt.init(params)
    updates, state = opt.update(grads, state, params, step)
    params = apply_updates(params, updates)

``torch.optim`` is not used: the reference's step-index convention is part
of the parity contract. Adam's bias correction uses ``step + 1``, and the
Co-Boosting generator restarts ``step`` at 0 every epoch while its moments
carry over.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.config.train import TrainConfig
from repro_torch.optim.schedules import Schedule, constant_schedule
from repro_torch.utils.trees import tree_map


@dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any, int], Any]  # grads, state, params, step


def apply_updates(params: Any, updates: Any) -> Any:
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


def sgdm(lr: Schedule, momentum: float = 0.9) -> Optimizer:
    """SGD with (heavy-ball) momentum — the paper's client/server optimizer."""

    def init(params):
        return {"m": tree_map(torch.zeros_like, params)}

    def update(grads, state, params, step):
        m = tree_map(lambda m_, g: momentum * m_ + g.float(), state["m"], grads)
        lr_t = lr(step)
        u = tree_map(lambda m_: -lr_t * m_, m)
        return u, {"m": m}

    return Optimizer(init, update)


def adam(lr: Schedule, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> Optimizer:
    """Adam. ``step`` is the caller's 0-based index; bias correction uses
    ``step + 1`` (in f32, as the reference computes it)."""

    def init(params):
        z = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
        return {"m": z, "v": tree_map(torch.zeros_like, z)}

    def update(grads, state, params, step):
        t = np.float32(step) + np.float32(1.0)
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g.float(), state["m"], grads)
        v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * torch.square(g.float()), state["v"], grads)
        bc1 = float(np.float32(1.0) - np.float32(b1) ** t)
        bc2 = float(np.float32(1.0) - np.float32(b2) ** t)
        lr_t = lr(int(step))

        def u_fn(m_, v_, p):
            return (-lr_t * ((m_ / bc1) / (torch.sqrt(v_ / bc2) + eps))).to(p.dtype)

        return tree_map(u_fn, m, v, params), {"m": m, "v": v}

    return Optimizer(init, update)


def make_optimizer(cfg: TrainConfig) -> Optimizer:
    lr = constant_schedule(cfg.learning_rate)
    if cfg.optimizer == "sgdm":
        return sgdm(lr, cfg.momentum)
    if cfg.optimizer == "adam":
        return adam(lr, cfg.beta1, cfg.beta2, cfg.eps)
    raise ValueError(f"unknown optimizer {cfg.optimizer!r}; the port has 'sgdm' and 'adam'")
