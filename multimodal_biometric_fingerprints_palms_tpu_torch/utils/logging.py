"""Logging helpers of the port (a copy of the JAX package's
``utils/logging.py``): the stage banner and the idempotent per-stage file
logger every runner uses."""

from __future__ import annotations

import logging
import sys
from pathlib import Path


def console_step(message: str, char: str = "=", width: int = 70) -> None:
    """Print a banner marking a pipeline stage."""
    line = char * width
    sys.stdout.write(f"\n{line}\n{message}\n{line}\n")
    sys.stdout.flush()


def get_file_logger(name: str, logfile: str | Path | None = None,
                    level: int = logging.INFO) -> logging.Logger:
    """Return a logger writing to ``logfile`` (and stderr), idempotently."""
    logger = logging.getLogger(name)
    logger.setLevel(level)
    if logfile is not None:
        logfile = Path(logfile)
        logfile.parent.mkdir(parents=True, exist_ok=True)
        already = any(
            isinstance(h, logging.FileHandler)
            and Path(getattr(h, "baseFilename", "")) == logfile.resolve()
            for h in logger.handlers
        )
        if not already:
            handler = logging.FileHandler(logfile)
            handler.setFormatter(
                logging.Formatter("%(asctime)s [%(levelname)s] %(name)s: %(message)s")
            )
            logger.addHandler(handler)
    return logger
