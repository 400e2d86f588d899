"""Metrics storage and writers (counterpart of ``lvc_tpu/utils/events.py``;
the port keeps its own copy of the parts the trainer uses).

Counterpart of detectron2/utils/events.py (EventStorage:232, JSONWriter:40,
CommonMetricPrinter:154, TensorboardXWriter:109). The JAX module's image and
histogram queues and name scopes have no caller in either package and are
left out. ``get_event_storage`` returns the storage of the innermost
``with EventStorage(...)`` block (the running trainer's), as JAX's does.
"""
from __future__ import annotations

import datetime
import json
import logging
import os
import statistics
from collections import defaultdict, deque
from typing import Dict

logger = logging.getLogger(__name__)

_CURRENT_STORAGE_STACK = []


def get_event_storage() -> "EventStorage":
    """The ``EventStorage`` of the innermost open ``with`` block."""
    assert _CURRENT_STORAGE_STACK, "get_event_storage() called outside a storage context"
    return _CURRENT_STORAGE_STACK[-1]


class HistoryBuffer:
    def __init__(self, window: int = 20):
        self._deque = deque(maxlen=window)
        self._latest = float("nan")

    def update(self, value: float):
        self._deque.append(value)
        self._latest = value

    def latest(self) -> float:
        return self._latest

    def values(self) -> list:
        """The values in the window, oldest first."""
        return list(self._deque)

    def median(self) -> float:
        return statistics.median(self._deque) if self._deque else float("nan")


class EventStorage:
    """Scalars by name, each in a 20-value window, and the current
    iteration; a context manager, as the trainer uses it."""

    def __init__(self, start_iter: int = 0):
        self._history: Dict[str, HistoryBuffer] = defaultdict(HistoryBuffer)
        self._smoothing_hints: Dict[str, bool] = {}
        self.iter = start_iter

    def put_scalar(self, name: str, value, smoothing_hint: bool = True):
        self._history[name].update(float(value))
        self._smoothing_hints[name] = smoothing_hint

    def put_scalars(self, *, smoothing_hint: bool = True, **kwargs):
        for k, v in kwargs.items():
            self.put_scalar(k, v, smoothing_hint=smoothing_hint)

    def histories(self) -> Dict[str, HistoryBuffer]:
        return self._history

    def latest_with_smoothing(self) -> Dict[str, float]:
        """The median of each smoothed scalar's window, the latest value of
        the others."""
        return {
            k: h.median() if self._smoothing_hints.get(k, True) else h.latest()
            for k, h in self._history.items()
        }

    def __enter__(self):
        _CURRENT_STORAGE_STACK.append(self)
        return self

    def __exit__(self, *args):
        assert _CURRENT_STORAGE_STACK[-1] is self
        _CURRENT_STORAGE_STACK.pop()


class JSONWriter:
    """Appends one json line of latest scalars per write (metrics.json)."""

    def __init__(self, json_file: str):
        os.makedirs(os.path.dirname(json_file) or ".", exist_ok=True)
        self._file = open(json_file, "a")

    def write(self, storage: EventStorage):
        row = {"iteration": storage.iter}
        row.update(storage.latest_with_smoothing())
        self._file.write(json.dumps(row, sort_keys=True) + "\n")
        self._file.flush()

    def close(self):
        self._file.close()


class CommonMetricPrinter:
    """The terminal line: eta, iter, losses, lr (events.py:154)."""

    def __init__(self, max_iter: int):
        self._max_iter = max_iter

    def write(self, storage: EventStorage):
        iteration = storage.iter
        latest = storage.latest_with_smoothing()
        data_time = latest.get("data_time")
        step_time = latest.get("time")
        eta = ""
        if step_time:
            secs = step_time * (self._max_iter - iteration)
            eta = f"eta: {datetime.timedelta(seconds=int(secs))}  "
        losses = "  ".join(
            f"{k}: {v:.4g}" for k, v in latest.items() if "loss" in k
        )
        lr = latest.get("lr")
        lr_s = f"lr: {lr:.3e}  " if lr is not None else ""
        t_s = f"time: {step_time:.4f}  " if step_time else ""
        d_s = f"data_time: {data_time:.4f}  " if data_time else ""
        logger.info(f"{eta}iter: {iteration}  {losses}  {t_s}{d_s}{lr_s}")

    def close(self):
        pass


class TensorboardWriter:
    """Optional tensorboard writer; silently disabled if unavailable."""

    def __init__(self, log_dir: str):
        self._writer = None
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._writer = SummaryWriter(log_dir)
        except Exception:
            logger.info("tensorboard unavailable; skipping TensorboardWriter")

    def write(self, storage: EventStorage):
        if self._writer is None:
            return
        for k, v in storage.latest_with_smoothing().items():
            self._writer.add_scalar(k, v, storage.iter)

    def close(self):
        if self._writer is not None:
            self._writer.close()
