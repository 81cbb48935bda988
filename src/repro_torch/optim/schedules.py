"""Learning-rate schedules (the port of ``repro.optim.schedules``).

A schedule maps the step index to the rate. The reference evaluates it in
f32 on a traced step; the port evaluates the same expressions in numpy
f32 on the host and returns a Python float.
"""
from __future__ import annotations

from typing import Callable

import numpy as np

Schedule = Callable[[int], float]

_F = np.float32


def constant_schedule(lr: float) -> Schedule:
    return lambda step: lr


def cosine_schedule(lr: float, total_steps: int, final_frac: float = 0.0) -> Schedule:
    def fn(step):
        t = np.clip(_F(step) / _F(max(total_steps, 1)), _F(0.0), _F(1.0))
        cos = _F(0.5) * (_F(1.0) + np.cos(_F(np.pi) * t))
        return float(_F(lr) * (_F(final_frac) + _F(1.0 - final_frac) * cos))

    return fn


def linear_warmup_cosine(lr: float, warmup: int, total_steps: int) -> Schedule:
    cos = cosine_schedule(lr, max(total_steps - warmup, 1))

    def fn(step):
        if step < warmup:
            return float(_F(lr) * (_F(step) + _F(1.0)) / _F(max(warmup, 1)))
        return cos(step - warmup)

    return fn


def make_schedule(cfg) -> Schedule:
    if cfg.schedule == "constant":
        return constant_schedule(cfg.learning_rate)
    if cfg.schedule == "cosine":
        return cosine_schedule(cfg.learning_rate, cfg.total_steps)
    if cfg.schedule == "linear_warmup_cosine":
        return linear_warmup_cosine(cfg.learning_rate, cfg.warmup_steps, cfg.total_steps)
    raise ValueError(f"unknown schedule {cfg.schedule!r}")
