"""Process-rank-prefixed logging.

Capability parity with the reference's rank-prefixed logger
(reference: chitu/chitu_main.py:23-35).
"""

from __future__ import annotations

import logging
import sys

_LOGGER_NAME = "chitu_tpu_torch"
_initialized = False
_rank = [0]  # mutable so a later init_logger(rank=...) takes effect


class _RankFilter(logging.Filter):
    def filter(self, record: logging.LogRecord) -> bool:
        record.rank = _rank[0]
        return True


def init_logger(rank: int = 0, level: int = logging.INFO) -> logging.Logger:
    """Idempotent handler setup; the rank prefix UPDATES on every call —
    modules call get_logger() at import (rank 0), and the multi-host
    bring-up re-inits with the real process index afterwards."""
    global _initialized
    logger = logging.getLogger(_LOGGER_NAME)
    _rank[0] = rank
    if _initialized:
        logger.setLevel(level)
        return logger
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(
        logging.Formatter(
            "[%(asctime)s][Rank %(rank)s][%(levelname)s] %(message)s",
            datefmt="%H:%M:%S",
        )
    )
    handler.addFilter(_RankFilter())
    logger.addHandler(handler)
    logger.setLevel(level)
    logger.propagate = False
    _initialized = True
    return logger


def get_logger() -> logging.Logger:
    if not _initialized:
        init_logger()
    return logging.getLogger(_LOGGER_NAME)
