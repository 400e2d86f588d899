"""Readings of the program's own spans and counters
(``lvc_tpu_torch.utils.tracing``), which the traced section records in this
process: a span's stream or host ms and a counter's count, a traced step or
a call. Each returns None where the program has no such span (or no such
module, as before it had one)."""
from __future__ import annotations

from typing import Dict, Optional


def totals() -> Dict[str, Dict]:
    try:
        from lvc_tpu_torch.utils import tracing
    except ImportError:
        return {}
    return tracing.totals()


def _entry(name: str) -> Optional[Dict]:
    entry = totals().get(name)
    return entry if entry and entry["calls"] > 0 else None


def stream_ms_per_step(ctx, name: str) -> Optional[float]:
    entry = _entry(name)
    if entry is None or entry["stream_ms"] is None or ctx.traced_steps <= 0:
        return None
    return entry["stream_ms"] / ctx.traced_steps


def host_ms_per_step(ctx, name: str) -> Optional[float]:
    entry = _entry(name)
    if entry is None or ctx.traced_steps <= 0:
        return None
    return entry["host_ms"] / ctx.traced_steps


def host_ms_per_call(name: str) -> Optional[float]:
    entry = _entry(name)
    return None if entry is None else entry["host_ms"] / entry["calls"]


def count_per_step(ctx, name: str, counter: str) -> Optional[float]:
    entry = _entry(name)
    if entry is None or ctx.traced_steps <= 0:
        return None
    return entry["counts"].get(counter, 0) / ctx.traced_steps
