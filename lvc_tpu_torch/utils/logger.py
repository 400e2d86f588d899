"""Logging helpers (a copy of ``lvc_tpu/utils/logger.py``; loggers default to
the name ``lvc_tpu_torch``).

Counterpart of detectron2/utils/logger.py (setup_logger, log_first_n,
log_every_n_seconds) — per-process loggers with optional file output and
rate-limited logging used by hot paths.
"""
from __future__ import annotations

import functools
import logging
import os
import sys
import time
from collections import Counter

_LOG_COUNTER: Counter = Counter()
_LOG_TIMER: dict = {}


@functools.lru_cache()
def setup_logger(
    output: str | None = None,
    distributed_rank: int = 0,
    *,
    name: str = "lvc_tpu_torch",
    abbrev_name: str | None = None,
) -> logging.Logger:
    """Configure and return a logger; rank != 0 skips the console handler."""
    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG)
    logger.propagate = False
    fmt = logging.Formatter(
        "[%(asctime)s] %(name)s %(levelname)s: %(message)s", datefmt="%m/%d %H:%M:%S"
    )
    if distributed_rank == 0:
        ch = logging.StreamHandler(stream=sys.stdout)
        ch.setLevel(logging.DEBUG)
        ch.setFormatter(fmt)
        logger.addHandler(ch)
    if output:
        filename = output if output.endswith((".txt", ".log")) else os.path.join(output, "log.txt")
        if distributed_rank > 0:
            filename = filename + f".rank{distributed_rank}"
        os.makedirs(os.path.dirname(os.path.abspath(filename)), exist_ok=True)
        fh = logging.StreamHandler(open(filename, "a"))
        fh.setLevel(logging.DEBUG)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


def _caller_key():
    frame = sys._getframe(2)
    return (frame.f_code.co_filename, frame.f_lineno)


def log_first_n(lvl: int, msg: str, n: int = 1, *, name: str = "lvc_tpu_torch", key: str = "caller"):
    """Log only the first n times per call site (or per message)."""
    k = _caller_key() if key == "caller" else msg
    _LOG_COUNTER[k] += 1
    if _LOG_COUNTER[k] <= n:
        logging.getLogger(name).log(lvl, msg)


def log_every_n(lvl: int, msg: str, n: int = 1, *, name: str = "lvc_tpu_torch"):
    k = _caller_key()
    _LOG_COUNTER[k] += 1
    if (_LOG_COUNTER[k] - 1) % n == 0:
        logging.getLogger(name).log(lvl, msg)


def log_every_n_seconds(lvl: int, msg: str, n: int = 1, *, name: str = "lvc_tpu_torch"):
    k = _caller_key()
    now = time.time()
    last = _LOG_TIMER.get(k)
    if last is None or now - last >= n:
        logging.getLogger(name).log(lvl, msg)
        _LOG_TIMER[k] = now
