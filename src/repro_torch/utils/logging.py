"""Thin stdlib logging wrapper with a consistent format.

The ``repro_torch`` root level comes from the ``REPRO_LOG_LEVEL`` environment
variable (``DEBUG``/``INFO``/``WARNING``/... or a numeric level; default
``INFO``); :func:`set_level` changes it at runtime.
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


def set_level(level) -> None:
    """Set the ``repro_torch`` root logger level: a logging constant, a
    numeric value, or a name like ``"debug"``."""
    if isinstance(level, str):
        resolved = logging.getLevelName(level.upper())
        if not isinstance(resolved, int):
            raise ValueError(f"unknown log level {level!r}")
        level = resolved
    logging.getLogger("repro_torch").setLevel(level)


def get_logger(name: str) -> logging.Logger:
    root = logging.getLogger("repro_torch")
    if not root.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FORMAT, datefmt="%H:%M:%S"))
        root.addHandler(handler)
        root.setLevel(_level_from_env())
        root.propagate = False
    return logging.getLogger(f"repro_torch.{name}")
