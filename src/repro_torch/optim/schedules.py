"""Learning-rate schedules (the main path uses a constant rate)."""
from __future__ import annotations

from typing import Callable

Schedule = Callable[[int], float]


def constant_schedule(lr: float) -> Schedule:
    return lambda step: lr

