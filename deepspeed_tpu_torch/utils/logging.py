"""Rank-aware logging (reference: deepspeed/utils/logging.py), the
port's copy of ``deepspeed_tpu/utils/logging.py`` with the rank read
from ``torch.distributed`` instead of jax."""

from __future__ import annotations

import logging
import os
import sys

LOG_LEVELS = {
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "critical": logging.CRITICAL,
}


def _create_logger(name: str = "deepspeed_tpu_torch") -> logging.Logger:
    logger = logging.getLogger(name)
    if logger.handlers:
        return logger
    level = LOG_LEVELS.get(os.environ.get("DS_TPU_LOG_LEVEL", "info"),
                           logging.INFO)
    logger.setLevel(level)
    logger.propagate = False
    handler = logging.StreamHandler(stream=sys.stdout)
    handler.setFormatter(logging.Formatter(
        "[%(asctime)s] [%(levelname)s] [%(name)s] %(message)s"))
    logger.addHandler(handler)
    return logger


logger = _create_logger()


def rank() -> int:
    """This process's rank: the process group's once one exists, else
    the launcher-provided env rank."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return int(os.environ.get("RANK", os.environ.get("DS_PROCESS_ID", "0")))


def log_dist(message: str, ranks: list[int] | None = None,
             level: int = logging.INFO) -> None:
    """Log on selected process ranks only (reference: utils/logging.py
    log_dist). ranks=None or [-1] logs everywhere; default logs on rank 0."""
    my_rank = rank()
    should = ranks is None and my_rank == 0 \
        or ranks is not None and (-1 in ranks or my_rank in ranks)
    if should:
        logger.log(level, f"[Rank {my_rank}] {message}")


def warning_once(message: str, _seen: set = set()) -> None:
    if message not in _seen:
        _seen.add(message)
        logger.warning(message)
