"""Replay ring buffer over synthetic batches (D_S).

A fixed-shape ``(capacity, B, …)`` ring on the run's device. Appending
writes the new batch at ``ptr`` in place and advances ``ptr``/``size``;
once full, the oldest batch is overwritten — the ``append`` + ``pop(0)``
window of a list. Logical order is oldest-first: logical index ``i`` lives
at physical slot ``(ptr - size + i) % capacity``. ``ptr`` and ``size`` are
host integers: the epoch loop runs on the host.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

import torch


@dataclass
class ReplayBuffer:
    """``x``: (capacity, B, *obs); ``y``: (capacity, B); ``ptr``: next write
    slot; ``size``: valid slots."""

    x: torch.Tensor
    y: torch.Tensor
    ptr: int = 0
    size: int = 0

    @property
    def capacity(self) -> int:
        return self.x.shape[0]


def buffer_init(
    capacity: int, batch_shape: Sequence[int], x_dtype=torch.float32, y_dtype=torch.int64, device=None
) -> ReplayBuffer:
    """Preallocate a ring over ``capacity`` batches of shape ``(B, *obs)``."""
    batch_shape = tuple(batch_shape)
    return ReplayBuffer(
        x=torch.zeros((capacity, *batch_shape), dtype=x_dtype, device=device),
        y=torch.zeros((capacity, batch_shape[0]), dtype=y_dtype, device=device),
    )


def buffer_append(buf: ReplayBuffer, x: torch.Tensor, y: torch.Tensor) -> ReplayBuffer:
    """Insert one batch in place, evicting the oldest once full."""
    buf.x[buf.ptr].copy_(x)
    buf.y[buf.ptr].copy_(y)
    buf.ptr = (buf.ptr + 1) % buf.capacity
    buf.size = min(buf.size + 1, buf.capacity)
    return buf


def buffer_get(buf: ReplayBuffer, slot: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Read one physical slot."""
    return buf.x[slot], buf.y[slot]
