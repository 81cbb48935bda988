"""Thin stdlib logging wrapper with a consistent format.

The ``repro_torch`` root level comes from the ``REPRO_LOG_LEVEL`` environment
variable (``DEBUG``/``INFO``/``WARNING``/... or a numeric level; default
``INFO``).
"""
from __future__ import annotations

import logging
import os
import sys

_FORMAT = "%(asctime)s %(name)s %(levelname).1s | %(message)s"


def _level_from_env(default: int = logging.INFO) -> int:
    raw = os.environ.get("REPRO_LOG_LEVEL", "").strip()
    if not raw:
        return default
    if raw.isdigit():
        return int(raw)
    level = logging.getLevelName(raw.upper())
    return level if isinstance(level, int) else default


def get_logger(name: str) -> logging.Logger:
    root = logging.getLogger("repro_torch")
    if not root.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FORMAT, datefmt="%H:%M:%S"))
        root.addHandler(handler)
        root.setLevel(_level_from_env())
        root.propagate = False
    return logging.getLogger(f"repro_torch.{name}")
