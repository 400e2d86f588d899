"""Where the harness finds things, by the names ``BENCHMARK.json`` uses:
``benchmark/cells/<cell>.json`` (its configuration, traffic, chips, why,
driver and limits; a traffic ``mix`` names ``benchmark/traffic/<mix>.json``,
whose parameters the cell's own override), ``benchmark/configs/<config>.json``,
and one reader ``benchmark/metrics/<metric>.py`` per per-layer metric, whose
``read(ctx)`` returns a number or None (nothing to read in this cell). A
reader of a kernel's roofline also declares ``KERNEL``: ``call``, the
program's function that launches the kernel (``module:function``), which a
traced run wraps to record each call; ``events``, parts of the kernel's
names in the trace; ``counts``, the yardstick (``module:object``) whose
``record(*args)`` keeps what ``least_ms(record)`` needs from one call.
Which metrics a cell reports is ``BENCHMARK.json``'s: an entry lists the
cell in its ``workloads``, or has no ``workloads`` and moves an end-to-end
metric that the cell reports."""
from __future__ import annotations

import importlib.util
import json
import os
from typing import Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _load(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def cell(name: str) -> Dict:
    c = _load(os.path.join(HERE, "cells", f"{name}.json"))
    if "mix" in c["traffic"]:
        c["traffic"] = dict(_load(os.path.join(HERE, "traffic", f"{c['traffic']['mix']}.json")), **c["traffic"])
    return c


def config(name: str) -> Dict:
    return _load(os.path.join(HERE, "configs", f"{name}.json"))


def benchmark() -> Dict:
    return _load(os.path.join(ROOT, "BENCHMARK.json"))


def end_to_end(bench: Dict, cell_name: str) -> List[Dict]:
    """The end-to-end metrics the cell reports: those that list it, and
    those that list no cells (every cell reports them)."""
    return [m for m in bench["end_to_end"] if cell_name in m.get("workloads", [cell_name])]


def per_layer(bench: Dict, cell_name: str) -> List[Dict]:
    """The per-layer metrics the cell reports: those that list it, and those
    that list no cells and move an end-to-end metric the cell reports."""
    e2e = {m["name"] for m in end_to_end(bench, cell_name)}
    return [m for m in bench["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m else m["moves"] in e2e)]


def _reader_module(metric: str):
    path = os.path.join(HERE, "metrics", f"{metric}.py")
    mod_spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def reader(metric: str):
    return _reader_module(metric).read


def kernels(bench: Dict, cell_name: str) -> List[Dict]:
    """The ``KERNEL`` declarations of the cell's per-layer readers, one a
    launching function."""
    out: Dict[str, Dict] = {}
    for m in per_layer(bench, cell_name):
        k = getattr(_reader_module(m["name"]), "KERNEL", None)
        if k is not None:
            out.setdefault(k["call"], k)
    return list(out.values())


def resolve(ref: str):
    """``module:attribute`` -> the attribute."""
    module, attr = ref.split(":")
    return getattr(importlib.import_module(module), attr)


class Context:
    """What a reader sees: ``mode`` ("train" or "infer"), ``window`` (the
    untraced window: seconds, steps, images, flops, peak_flops, and
    loader_waits where a loader fed it), ``trace`` (``trace.read``'s summary
    of the traced section, or None), ``traced_steps``, and
    ``kernel_least_ms`` (for each declared ``KERNEL['call']`` that the
    traced section made, the least ms of its calls)."""

    def __init__(self, mode: str, window: Dict, trace: Optional[Dict], traced_steps: int,
                 kernel_least_ms: Optional[Dict[str, float]] = None):
        self.mode = mode
        self.window = window
        self.trace = trace
        self.traced_steps = traced_steps
        self.kernel_least_ms = dict(kernel_least_ms or {})

    def range_ms(self, name: str) -> Optional[float]:
        if not self.trace or self.traced_steps <= 0:
            return None
        ms = self.trace["range_ms"].get(name, 0.0)
        return ms / self.traced_steps if ms > 0 else None

    def roofline_pct(self, kernel: Dict) -> Optional[float]:
        """100 x the least ms of the traced calls of a declared ``KERNEL``
        over the device ms of its events."""
        least = self.kernel_least_ms.get(kernel["call"])
        if not self.trace or not least:
            return None
        device_ms = sum(t for k, (t, _) in self.trace["kernels_ms"].items() if any(n in k for n in kernel["events"]))
        return 100.0 * least / device_ms if device_ms > 0 else None
