"""Logging (a copy of the JAX package's `utils/logging.py`): one factory
producing namespaced loggers under "lattice_mcmc", an optional timestamped
run-log file shared by all of them, and a phase-timer context that logs
wall-clock per experiment phase. Host-side only.
"""

from __future__ import annotations

import contextlib
import datetime
import logging
import os
import time
from typing import Iterator, Optional

_ROOT = "lattice_mcmc"
_configured = False


def get_logger(name: str = "") -> logging.Logger:
    """Namespaced logger, e.g. get_logger("reduction") ->
    "lattice_mcmc.reduction". Console handler is installed once on the root
    of the namespace (INFO, overridable via LATTICE_MCMC_LOGLEVEL)."""
    global _configured
    root = logging.getLogger(_ROOT)
    if not _configured:
        level = os.environ.get("LATTICE_MCMC_LOGLEVEL", "INFO").upper()
        root.setLevel(getattr(logging, level, logging.INFO))
        if not root.handlers:
            h = logging.StreamHandler()
            h.setFormatter(logging.Formatter(
                "%(asctime)s %(name)s %(levelname)s %(message)s",
                datefmt="%H:%M:%S"))
            root.addHandler(h)
        root.propagate = False
        _configured = True
    return logging.getLogger(f"{_ROOT}.{name}" if name else _ROOT)


def add_run_file_handler(log_dir: str, prefix: str = "run") -> str:
    """Attach a timestamped file handler capturing every lattice_mcmc
    logger. Returns the log-file path."""
    os.makedirs(log_dir, exist_ok=True)
    stamp = datetime.datetime.now().strftime("%Y%m%d_%H%M%S")
    path = os.path.join(log_dir, f"{prefix}_{stamp}.log")
    fh = logging.FileHandler(path)
    fh.setFormatter(logging.Formatter(
        "%(asctime)s %(name)s %(levelname)s %(message)s"))
    get_logger().addHandler(fh)
    return path


@contextlib.contextmanager
def log_phase(name: str, logger: Optional[logging.Logger] = None
              ) -> Iterator[None]:
    """Log phase start/end with wall-clock."""
    log = logger or get_logger("phase")
    log.info("%s: start", name)
    t0 = time.perf_counter()
    try:
        yield
    except Exception:
        log.exception("%s: FAILED after %.2fs", name,
                      time.perf_counter() - t0)
        raise
    log.info("%s: done in %.2fs", name, time.perf_counter() - t0)
