"""Functional optimizers and learning-rate schedules."""
from repro_torch.optim.optimizers import (
    Optimizer,
    adam,
    adamw,
    clip_by_global_norm,
    make_optimizer,
    sgd,
    sgdm,
)
from repro_torch.optim.schedules import constant_schedule, cosine_schedule, linear_warmup_cosine, make_schedule

__all__ = [
    "Optimizer",
    "sgd",
    "sgdm",
    "adam",
    "adamw",
    "make_optimizer",
    "clip_by_global_norm",
    "constant_schedule",
    "cosine_schedule",
    "linear_warmup_cosine",
    "make_schedule",
]
