"""Logging utilities: colored console logging, context, progress with ETA.

A copy of ``mixed_precision_multigrid_solvers_for_pdes_tpu/utils/
logging_utils.py`` (standard library only), whose loggers are named under
this package.
"""

from __future__ import annotations

import functools
import logging
import sys
import time
from typing import Optional

_COLORS = {
    "DEBUG": "\033[36m",
    "INFO": "\033[32m",
    "WARNING": "\033[33m",
    "ERROR": "\033[31m",
    "CRITICAL": "\033[35m",
}
_RESET = "\033[0m"


class ColoredFormatter(logging.Formatter):
    """Level-colored console formatter (reference logging_utils.py:11-45)."""

    def format(self, record: logging.LogRecord) -> str:
        msg = super().format(record)
        color = _COLORS.get(record.levelname)
        if color and sys.stderr.isatty():
            return f"{color}{msg}{_RESET}"
        return msg


def setup_logging(
    level: str = "INFO",
    log_file: Optional[str] = None,
    colored: bool = True,
    name: str = "mixed_precision_multigrid_solvers_for_pdes_torch",
) -> logging.Logger:
    """Configure the package logger (reference logging_utils.py:46-110)."""
    logger = logging.getLogger(name)
    logger.setLevel(getattr(logging, level.upper()))
    logger.handlers.clear()
    fmt = "%(asctime)s %(name)s %(levelname)s: %(message)s"
    console = logging.StreamHandler()
    console.setFormatter(ColoredFormatter(fmt) if colored else logging.Formatter(fmt))
    logger.addHandler(console)
    if log_file:
        fh = logging.FileHandler(log_file)
        fh.setFormatter(logging.Formatter(fmt))
        logger.addHandler(fh)
    logger.propagate = False
    return logger


def get_logger(name: str = "") -> logging.Logger:
    base = "mixed_precision_multigrid_solvers_for_pdes_torch"
    return logging.getLogger(f"{base}.{name}" if name else base)


class LoggingContext:
    """Temporarily change a logger's level (reference logging_utils.py:150-188)."""

    def __init__(self, logger: logging.Logger, level: str):
        self.logger = logger
        self.level = getattr(logging, level.upper())
        self._saved: Optional[int] = None

    def __enter__(self):
        self._saved = self.logger.level
        self.logger.setLevel(self.level)
        return self.logger

    def __exit__(self, *exc):
        self.logger.setLevel(self._saved)
        return False


class ProgressLogger:
    """Work-unit progress with rate + ETA (reference logging_utils.py:189-260)."""

    def __init__(self, total: int, logger: Optional[logging.Logger] = None,
                 every: int = 1, label: str = "progress"):
        self.total = total
        self.done = 0
        self.every = max(1, every)
        self.label = label
        self.logger = logger or get_logger("progress")
        self.t0 = time.perf_counter()

    def update(self, n: int = 1) -> None:
        self.done += n
        if self.done % self.every == 0 or self.done >= self.total:
            elapsed = time.perf_counter() - self.t0
            rate = self.done / max(elapsed, 1e-12)
            eta = (self.total - self.done) / max(rate, 1e-12)
            self.logger.info(
                "%s: %d/%d (%.1f/s, ETA %.1fs)",
                self.label, self.done, self.total, rate, eta,
            )


def log_function_call(logger: Optional[logging.Logger] = None):
    """Decorator logging entry/exit + wall time
    (reference logging_utils.py:262-300)."""

    def deco(fn):
        log = logger or get_logger(fn.__module__)

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            log.debug("-> %s", fn.__qualname__)
            try:
                return fn(*args, **kwargs)
            finally:
                log.debug("<- %s (%.3fs)", fn.__qualname__,
                          time.perf_counter() - t0)

        return wrapper

    return deco
