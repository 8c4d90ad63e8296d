"""Logging helpers.

The reference's only observability is a hand-rolled timestamped
``log_message`` inside clusterbreak (R/clusterbreak.R:206-209) plus ``cat``
convergence reports (:264-270).  We expose the same user-visible events via
standard :mod:`logging`.
"""

from __future__ import annotations

import logging
import sys
import time


def get_logger(name: str = "dynaalign_torch") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(
            logging.Formatter("[%(asctime)s] %(levelname)s: %(message)s",
                              datefmt="%H:%M:%S")
        )
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    return logger


def log_message(msg: str, level: str = "INFO") -> None:
    """Timestamped log line in the reference's format
    (R/clusterbreak.R:206-209): ``[HH:MM:SS] LEVEL: msg``."""
    timestamp = time.strftime("%H:%M:%S")
    print(f"[{timestamp}] {level}: {msg}")
