"""One run of one benchmark cell on this machine's cards.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout of the repository. The cell
(``benchmark/cells/<cell>.json``) names its configuration
(``benchmark/configs/<config>.json``), its traffic and its driver
(``benchmark/drivers/<driver>.py``). The run makes its weights and inputs
from ``--seed``, sets up and warms up, measures for ``--seconds``, with
``--trace 1`` then profiles a short section, and after the window has its
outputs judged by the plain reference. The last line of standard output is
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer metrics, as
``BENCHMARK.json`` lists them), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each number compared beside its limit;
the last lines of standard error repeat the checks.

Exit codes: 0 with a result; 2 no usable card (fewer than the cell asks
for, or none); 3 the JAX package or JAX was loaded, by this process or by
any rank of a data-parallel cell. Build caches stay
inside the checkout (the program's kernels under ``build/kernels``, Triton's
under ``build/triton``); what a run writes goes under ``TMPDIR``.
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import time

BANNED = ("jax", "jaxlib", "flax", "lvc_tpu")


def process_start() -> float:
    """The wall-clock time this process started (Linux's /proc)."""
    with open("/proc/self/stat") as f:
        start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return time.time() - uptime + start_ticks / os.sysconf("SC_CLK_TCK")


def banned_modules():
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(BANNED))


def card(chips: int):
    """The first card, where there are as many as the cell asks for; else None."""
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        return None
    return torch.device("cuda", 0)


def card_line() -> str:
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.TimeoutExpired):
        return "nvidia-smi unavailable"
    return "; ".join(out)


def result_line(cell_name: str, cell: dict, out: dict, trace: bool, setup_s: float, chips: int, device_kind: str):
    from benchmark import check, spec

    bench = spec.benchmark()
    values = dict(out["e2e"], setup_s=setup_s)
    metrics = {}
    if trace:
        ctx = spec.Context(cell["driver"], out["window"], out["trace"], out["traced_steps"], out["kernel_least_ms"])
        for m in spec.per_layer(bench, cell_name):
            v = spec.reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in spec.end_to_end(bench, cell_name):
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    correct, checks = check.judge(out["numbers"], cell["limits"])
    device = {"platform": "gpu", "kind": device_kind, "count": chips, "memory_peak_bytes": int(out["memory_peak_bytes"])}
    line = {"correct": bool(correct), "attempted": out["attempted"], "failed": out["failed"], "metrics": metrics,
            "device": device}
    if trace and out["trace"]:
        device.update(busy_s=out["trace"]["busy_s"], window_s=out["trace"]["window_s"])
        line["breakdown"] = out["trace"]["breakdown"]
    line["checks"] = checks
    return line


def main(argv=None) -> int:
    started = process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(root, "build", "triton"))
    os.environ.setdefault("USE_FLAX", "0")

    from benchmark import spec

    cell = spec.cell(args.workload)
    config = spec.config(cell["config"])
    import torch

    device = card(cell["chips"])
    if device is None:
        print(f"benchmark: the cell needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    driver = importlib.import_module(f"benchmark.drivers.{cell['driver']}")
    kernels = spec.kernels(spec.benchmark(), args.workload) if args.trace else []
    out = driver.run(cell, config, args.seed, args.seconds, bool(args.trace), device, kernels=kernels)
    found = sorted(set(banned_modules()) | set(out.get("banned", ())))
    if found:
        print(f"benchmark: the run loaded {found}; the port must run without JAX", file=sys.stderr)
        return 3
    line = result_line(args.workload, cell, out, bool(args.trace), out["setup_done"] - started, cell["chips"],
                       torch.cuda.get_device_name(0))
    print(f"card: {card_line()}", file=sys.stderr)
    at, parts = started, []
    for name, t in out["setup_marks"]:
        parts.append(f"{name} {t - at:.2f} s")
        at = t
    print("setup: " + ", ".join(parts), file=sys.stderr)
    for k, v in line["checks"].items():
        ok = "ok" if v["value"] <= v["limit"] else "FAIL"
        print(f"check {k} {v['value']!r} limit {v['limit']!r} {ok}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
