"""The traced section of a ``--trace 1`` run: ``torch.profiler`` over a few
steady steps, its Chrome trace read back into

- the device's busy seconds (the union of kernel, copy and fill intervals
  on each device) and the idle gaps between them, each named by the
  innermost host range open at the gap's middle;
- the device time of each profiler range (``backbone``, ``rpn``,
  ``roi_heads``, ``backward``, ``optimizer``): the kernels whose launch
  falls inside the range, on any host thread (the backward launches from
  autograd's thread), as ``chip_smoke.stage_times`` counts them;
- the device time of kernels by name, and of the NCCL kernels not
  overlapped by any other kernel of their device.

Times in the Chrome trace are microseconds.
"""
from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from typing import Dict, List, Sequence, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _union(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def _length(spans) -> float:
    return sum(e - s for s, e in spans)


class Profile:
    """``with Profile() as p: ...`` profiles the block; ``p.summary``
    afterwards holds the readings."""

    def __init__(self, ranges: Sequence[str] = ()):
        self.ranges = tuple(ranges)
        self.summary: Dict = {}

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self._cuda = torch.cuda.is_available()
        if self._cuda:
            torch.cuda.synchronize()
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self._cuda else [])
        self._prof = profile(activities=activities)
        self._prof.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import torch

        if self._cuda:
            torch.cuda.synchronize()
        window_s = time.perf_counter() - self._t0
        self._prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        self.summary = read(events, self.ranges, window_s)
        return False


def read(events: List[Dict], ranges: Sequence[str], window_s: float) -> Dict:
    device_ops = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    launches = {}
    host = []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        if cat in ("cuda_runtime", "cuda_driver") and "correlation" in e.get("args", {}):
            launches[e["args"]["correlation"]] = e["ts"]
        elif cat in ("user_annotation", "cpu_op", "python_function"):
            host.append(e)
    # busy and idle per device
    by_device: Dict[int, List[Tuple[float, float]]] = {}
    for e in device_ops:
        by_device.setdefault(e.get("args", {}).get("device", 0), []).append((e["ts"], e["ts"] + e["dur"]))
    unions = {d: _union(s) for d, s in by_device.items()}
    busy_us = sum(_length(u) for u in unions.values()) / max(len(unions), 1)
    # range device time: kernels whose launch lies in the range
    spans = {r: sorted((e["ts"], e["ts"] + e["dur"]) for e in host
                       if e.get("cat") == "user_annotation" and e["name"] == r) for r in ranges}
    starts = {r: [s for s, _ in v] for r, v in spans.items()}
    range_us = dict.fromkeys(ranges, 0.0)
    range_us["other"] = 0.0
    ordered = sorted(device_ops, key=lambda e: (e.get("args", {}).get("stream", 0), e["ts"]))
    last_launch = {}
    for e in ordered:
        args = e.get("args", {})
        at = launches.get(args.get("correlation"))
        stream = args.get("stream", 0)
        if at is None:  # a launch the trace did not record: take its stream's previous one
            at = last_launch.get(stream)
        else:
            last_launch[stream] = at
        where = "other"
        if at is not None:
            for r in ranges:
                i = bisect.bisect_right(starts[r], at) - 1
                if i >= 0 and spans[r][i][0] <= at <= spans[r][i][1]:
                    where = r
                    break
        range_us[where] += e["dur"]
    kernels: Dict[str, Tuple[float, int]] = {}
    for e in device_ops:
        t, n = kernels.get(e["name"], (0.0, 0))
        kernels[e["name"]] = (t + e["dur"], n + 1)
    # NCCL kernels' time not covered by any other kernel of their device
    exposed_us = []
    for d, ops in by_device.items():
        nccl = [(e["ts"], e["ts"] + e["dur"]) for e in device_ops
                if e.get("args", {}).get("device", 0) == d and "nccl" in e["name"].lower()]
        if not nccl:
            continue
        others = _union([(e["ts"], e["ts"] + e["dur"]) for e in device_ops
                         if e.get("args", {}).get("device", 0) == d and "nccl" not in e["name"].lower()])
        covered = 0.0
        for s, t in _union(nccl):
            for a, b in others:
                covered += max(0.0, min(t, b) - max(s, a))
        exposed_us.append(_length(_union(nccl)) - covered)
    # idle gaps, each named by the innermost host range open at its middle
    gaps = []
    for d, u in unions.items():
        for (_, e0), (s1, _) in zip(u[:-1], u[1:]):
            if s1 > e0:
                gaps.append((s1 - e0, (e0 + s1) / 2))
    gaps.sort(reverse=True)
    named = []
    for dur, at in gaps[:10]:
        open_ = [e for e in host if e["ts"] <= at <= e["ts"] + e["dur"]]
        name = min(open_, key=lambda e: e["dur"])["name"] if open_ else "no host range"
        named.append([name[:120], dur / 1e6])
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:10]
    return {
        "window_s": window_s,
        "busy_s": busy_us / 1e6,
        "devices": len(unions),
        "range_ms": {r: v / 1e3 for r, v in range_us.items()},
        "kernels_ms": {k: (t / 1e3, n) for k, (t, n) in kernels.items()},
        "nccl_exposed_ms": (sum(exposed_us) / len(exposed_us) / 1e3) if exposed_us else None,
        "breakdown": {"device_ops": [[k[:120], t / 1e6] for k, (t, _) in top], "idle_gaps": named},
    }
