"""Logging utilities (port of ``deepspeed_tpu/utils/logging.py``).

Ref: ``deepspeed/utils/logging.py:22 LoggerFactory``, ``log_dist:86``.
Rank filtering reads ``torch.distributed``'s rank when a process group is
initialised, else 0 (one process per device, as in the reference).
"""

import functools
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


class LoggerFactory:

    @staticmethod
    def create_logger(name=None, level=logging.INFO):
        if name is None:
            raise ValueError("name for logger cannot be None")
        formatter = logging.Formatter(
            "[%(asctime)s] [%(levelname)s] [%(filename)s:%(lineno)d:%(funcName)s] %(message)s")
        logger_ = logging.getLogger(name)
        logger_.setLevel(level)
        logger_.propagate = False
        if not logger_.handlers:
            ch = logging.StreamHandler(stream=sys.stdout)
            ch.setLevel(level)
            ch.setFormatter(formatter)
            logger_.addHandler(ch)
        return logger_


logger = LoggerFactory.create_logger(
    name="DeepSpeedTorch", level=LOG_LEVELS.get(os.environ.get("DS_TORCH_LOG_LEVEL", "info"), logging.INFO))


def _process_index():
    import torch.distributed as dist
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def log_dist(message, ranks=None, level=logging.INFO):
    """Log on selected ranks only (ref: utils/logging.py:86 log_dist)."""
    my_rank = _process_index()
    if ranks is None or len(ranks) == 0 or my_rank in ranks or (-1 in ranks):
        logger.log(level, f"[Rank {my_rank}] {message}")


def print_rank_0(message):
    if _process_index() == 0:
        print(message, flush=True)


@functools.lru_cache(None)
def warn_once(message):
    logger.warning(message)


def should_log_le(max_log_level_str):
    if not isinstance(max_log_level_str, str):
        raise ValueError("max_log_level_str must be a string")
    max_log_level_str = max_log_level_str.lower()
    if max_log_level_str not in LOG_LEVELS:
        raise ValueError(f"Invalid log level: {max_log_level_str}")
    return logger.getEffectiveLevel() <= LOG_LEVELS[max_log_level_str]
