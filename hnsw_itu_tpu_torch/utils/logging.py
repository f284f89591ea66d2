"""Logging set-up (a copy of hnsw_itu_tpu/utils/logging.py): HH:MM:SS
timestamps and the CLI's -v/-q verbosity, loggers under
``hnsw_itu_tpu_torch.*``."""

from __future__ import annotations

import logging
import sys
import time

ROOT = "hnsw_itu_tpu_torch"


def setup(verbosity: int = 0) -> None:
    """verbosity: -1 quiet (-q), 0 info, 1 debug (-v)."""
    level = {
        -2: logging.CRITICAL,
        -1: logging.ERROR,
        0: logging.INFO,
        1: logging.DEBUG,
    }.get(max(-2, min(verbosity, 1)), logging.DEBUG)
    handler = logging.StreamHandler(sys.stderr)
    fmt = logging.Formatter(
        "%(asctime)s %(levelname)5s %(name)s: %(message)s", datefmt="%H:%M:%S"
    )
    fmt.converter = time.localtime
    handler.setFormatter(fmt)
    root = logging.getLogger(ROOT)
    root.handlers[:] = [handler]
    root.setLevel(level)


def get(name: str) -> logging.Logger:
    return logging.getLogger(f"{ROOT}.{name}")
