"""Time the fused GEMM kernel of this checkout against another checkout's, on
one card, in turns.

    python -m lvc_tpu_torch.tools.compare_fused_kernel --other build/parent

``--other`` is the root of another checkout of the repository (for example
``git archive <commit> | tar -x -C build/parent``). Each turn runs that
checkout's own ``chip_smoke.fused_kernel_phase`` (its kernel, built from its
sources, checked against its plain version at the seven shapes of the fused
calls of one R-101-FPN forward, and timed) in a process of its own, in the
order other, this, this, other; then, in the same process, it times the host
side of that checkout's wrapper at each shape. It prints each turn's
per-shape card ms and host µs per call, then one JSON line with the per-shape
means of both and the ratio of their card times. It needs a
CUDA card and exits non-zero if a turn fails.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
_TURN = (
    "import json, sys, time, torch\n"
    "sys.path.insert(0, '.')\n"
    "import chip_smoke\n"
    "from lvc_tpu_torch.ops.fused_matmul import matmul_affine_residual as kernel\n"
    "torch.backends.cuda.matmul.allow_tf32 = False\n"
    "torch.backends.cudnn.allow_tf32 = False\n"
    "row = chip_smoke.fused_kernel_phase('[' + chip_smoke.card_line() + ']')\n"
    "host = []\n"
    "for _, B, H, W, K, N, relu, _ in chip_smoke.FUSED_SHAPES:\n"
    "    M = B * H * W\n"
    "    x = torch.randn(M, K, device='cuda').bfloat16()\n"
    "    w = torch.randn(N, K, device='cuda').bfloat16().t()\n"
    "    scale, shift = torch.ones(N, device='cuda'), torch.zeros(N, device='cuda')\n"
    "    res = torch.randn(M, N, device='cuda').bfloat16()\n"
    "    kernel(x, w, scale, shift, res, relu=relu)\n"
    "    torch.cuda.synchronize()\n"
    "    us = []\n"
    "    for _ in range(5):\n"
    "        t0 = time.perf_counter()\n"
    "        for _ in range(100):\n"
    "            kernel(x, w, scale, shift, res, relu=relu)\n"
    "        us.append((time.perf_counter() - t0) / 100 * 1e6)\n"
    "        torch.cuda.synchronize()\n"
    "    host.append(sorted(us)[2])\n"
    "    del x, w, res\n"
    "    torch.cuda.empty_cache()\n"
    "print(json.dumps([[s['shape'], s['calls'], s['ms'], s['bound_ms'], us]\n"
    "                  for s, us in zip(row['shapes'], host)]))\n"
)


def turn(root: Path) -> list:
    """One run of ``root``'s fused kernel phase, then of its wrapper's host
    time (after a synchronised warm-up, the median of five means over 100
    calls that are not synchronised): [(M, K, N), calls, ms, bound_ms,
    host_us] per shape."""
    proc = subprocess.run([sys.executable, "-c", _TURN], cwd=root, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"fused kernel phase of {root} failed:\n{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, help="root of the other checkout")
    args = ap.parse_args(argv)
    other = Path(args.other).resolve()
    if not (other / "chip_smoke.py").exists():
        print(f"compare_fused_kernel: no chip_smoke.py under {other}", file=sys.stderr)
        return 2
    runs = {"other": [], "this": []}
    for name, root in (("other", other), ("this", ROOT), ("this", ROOT), ("other", other)):
        shapes = turn(root)
        runs[name].append(shapes)
        print(f"{name} ({root}): " + ", ".join(f"{tuple(s[0])} {s[2]:.4f} ms {s[4]:.1f} host us" for s in shapes),
              flush=True)
    rows, totals = [], {"other": 0.0, "this": 0.0, "bound": 0.0}
    for i, (shape, calls, _, bound_ms, _) in enumerate(runs["this"][0]):
        mean = {k: sum(r[i][2] for r in v) / len(v) for k, v in runs.items()}
        us = {k: sum(r[i][4] for r in v) / len(v) for k, v in runs.items()}
        rows.append(dict(shape=shape, calls=calls, other_ms=mean["other"], this_ms=mean["this"], bound_ms=bound_ms,
                         other_over_this=mean["other"] / mean["this"], other_host_us=us["other"],
                         this_host_us=us["this"]))
        totals["other"] += calls * mean["other"]
        totals["this"] += calls * mean["this"]
        totals["bound"] += calls * bound_ms
    print(json.dumps({"shapes": rows, "per_forward_ms": totals}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
