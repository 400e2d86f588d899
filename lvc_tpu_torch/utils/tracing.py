"""The port's spans and counters: on exactly while a torch profiler records.

``span(name)`` marks a stage of the program; ``count(name, n)`` adds to the
innermost span open on the calling thread (``n`` an int, or a function
that returns one, called only while a profiler records). Both read one
flag first, ``torch.autograd.profiler._is_profiler_enabled``, which every
``torch.profiler.profile`` sets while it records (the benchmark's traced
section, the trainer's ``ProfilerHook``). While it is off a span is one
shared no-op context and a count returns at once: no ``record_function``,
no lock, no CUDA event, no allocation.

While it is on, a span opens ``record_function(name)``, so it sits in the
profiler's Chrome trace on the clock of the kernels it launched, and on
closing adds to an in-memory table keyed by its name: one call, its host
milliseconds (``time.perf_counter``) and its counts. With ``device=True``
once CUDA is in use it also records a timing event on the current stream
at entry and at exit; the pair is resolved only when the stream has passed
it or when ``totals()`` reads the table, never by a synchronise on the hot
path. Its interval is the stream time from the span's first work to its
last, idle inside included, which for a span that reads back to the host
every round is what the step pays for it. The loader's spans, which run on
its worker threads and launch nothing, pass ``device=False``.

The table holds aggregates only, and is shared by every thread (the
loader's workers record concurrently): ``totals()`` returns
``{span: {"calls", "host_ms", "stream_ms" (None without events),
"counts": {counter: n}}}``; counts made with no span open are kept under
the span ``""``. ``reset()`` clears it. A profile keeps the worker threads'
``record_function`` ranges only with
``_ExperimentalConfig(profile_all_threads=True)``; the table has them
either way.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

import torch
from torch.autograd import profiler as _profiler

# events waiting for the stream before a closing span looks for finished ones
_RESOLVE_AT = 32


class _Off:
    """The span while no profiler records."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Entry:
    __slots__ = ("calls", "host_s", "stream_ms", "timed", "counts")

    def __init__(self):
        self.calls = 0
        self.host_s = 0.0
        self.stream_ms = 0.0
        self.timed = 0
        self.counts: Dict[str, int] = {}


class _Span:
    __slots__ = ("tracer", "name", "device", "counts", "_rf", "_t0", "_start")

    def __init__(self, tracer: "Tracer", name: str, device: bool):
        self.tracer = tracer
        self.name = name
        self.device = device
        self.counts: Optional[Dict[str, int]] = None

    def __enter__(self):
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        self._start = None
        if self.device and torch.cuda.is_initialized():
            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record()
        self.tracer._stack().append(self)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        host_s = time.perf_counter() - self._t0
        pair = None
        if self._start is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            pair = (self._start, end)
        self.tracer._stack().pop()
        self._rf.__exit__(*exc)
        self.tracer._add(self.name, host_s, pair, self.counts)
        return False


class Tracer:
    """The table of spans and counts, and each thread's stack of open spans."""

    def __init__(self):
        self._lock = threading.Lock()
        self._table: Dict[str, _Entry] = {}
        self._pending: List[Tuple[str, torch.cuda.Event, torch.cuda.Event]] = []
        self._local = threading.local()

    def _stack(self) -> List[_Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def span(self, name: str, device: bool = True):
        if not _profiler._is_profiler_enabled:
            return _OFF
        return _Span(self, name, device)

    def count(self, name: str, n=1) -> None:
        if not _profiler._is_profiler_enabled:
            return
        n = int(n() if callable(n) else n)
        stack = self._stack()
        if not stack:
            self._add("", 0.0, None, {name: n}, calls=0)
            return
        top = stack[-1]
        if top.counts is None:
            top.counts = {}
        top.counts[name] = top.counts.get(name, 0) + n

    def _entry(self, name: str) -> _Entry:
        entry = self._table.get(name)
        if entry is None:
            entry = self._table[name] = _Entry()
        return entry

    def _add(self, name, host_s, pair, counts, calls: int = 1) -> None:
        with self._lock:
            entry = self._entry(name)
            entry.calls += calls
            entry.host_s += host_s
            for k, v in (counts or {}).items():
                entry.counts[k] = entry.counts.get(k, 0) + v
            if pair is not None:
                self._pending.append((name, *pair))
                if len(self._pending) >= _RESOLVE_AT:
                    self._resolve(wait=False)

    def _resolve(self, wait: bool) -> None:
        """Adds the pending event pairs' intervals to their spans: every
        pair, waiting for its end event (``wait``), else those the stream
        has passed. Called under the lock."""
        left = []
        for name, start, end in self._pending:
            if wait:
                end.synchronize()
            if wait or end.query():
                entry = self._entry(name)
                entry.stream_ms += start.elapsed_time(end)
                entry.timed += 1
            else:
                left.append((name, start, end))
        self._pending = left

    def totals(self) -> Dict[str, Dict]:
        with self._lock:
            self._resolve(wait=True)
            return {name: {"calls": e.calls, "host_ms": 1e3 * e.host_s,
                           "stream_ms": e.stream_ms if e.timed else None, "counts": dict(e.counts)}
                    for name, e in self._table.items()}

    def reset(self) -> None:
        with self._lock:
            self._table = {}
            self._pending = []


_TRACER = Tracer()


def span(name: str, device: bool = True):
    """A context that records ``name`` while a profiler records (see the
    module's docstring); ``device=False`` for host-only work."""
    return _TRACER.span(name, device)


def count(name: str, n=1) -> None:
    """Adds ``n`` to counter ``name`` of the innermost span open on this
    thread, while a profiler records. ``n`` may be a function that returns
    it, called only while recording: a count that needs a device read (a
    launch and a synchronisation) costs an untraced step nothing."""
    _TRACER.count(name, n)


def totals() -> Dict[str, Dict]:
    """The table: ``{span: {"calls", "host_ms", "stream_ms", "counts"}}``
    (it waits for the stream to pass the pending timing events)."""
    return _TRACER.totals()


def reset() -> None:
    """Clears the table."""
    _TRACER.reset()
