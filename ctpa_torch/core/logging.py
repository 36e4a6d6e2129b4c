"""Logging (port of ``ctpa/core/logging.py``): one ``get_logger`` with a
consistent format and rank-0 gating, and ``log_once`` for warnings that
would otherwise repeat every step.  The rank is ``torch.distributed``'s
when a process group is initialised, else 0."""

from __future__ import annotations

import logging
import sys
from functools import lru_cache

_FORMAT = "%(asctime)s %(levelname).1s %(name)s] %(message)s"


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


@lru_cache(maxsize=None)
def get_logger(name: str = "ctpa_torch", level: int = logging.INFO,
               all_processes: bool = False) -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FORMAT, datefmt="%H:%M:%S"))
        logger.addHandler(handler)
        logger.setLevel(level)
        logger.propagate = False
    if not all_processes and _rank() != 0:
        logger.setLevel(logging.CRITICAL)   # only rank 0 speaks
    return logger


_seen: set[str] = set()


def log_once(logger: logging.Logger, key: str, message: str,
             level: int = logging.WARNING) -> None:
    """Emit ``message`` only the first time ``key`` is seen."""
    if key in _seen:
        return
    _seen.add(key)
    logger.log(level, message)
