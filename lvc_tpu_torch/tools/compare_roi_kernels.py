"""Time the RoIAlign kernels of this checkout against another checkout's, on
one card, in turns.

    python -m lvc_tpu_torch.tools.compare_roi_kernels --other build/parent

``--other`` is the root of another checkout of the repository (for example
``git archive <commit> | tar -x -C build/parent``). Each turn runs in a
process of its own, in the order other, this, this, other, from that
checkout's root: its own wrappers (its kernels, built from its sources) time
the same calls on the same seeded inputs (``chip_smoke.kernel_inputs``, p2-p5
of an 8x832x1344 batch, C=256, bf16):

- ``roi_align_band`` and ``roi_align_paired`` at 1000 boxes per image;
- ``roi_align_paired`` at the training pool's 512 boxes per image;
- the whole backward at 512 boxes per image,
  ``[g.to(gout.dtype) for g in roi_align_paired_bwd(level_shapes, taps, gout)]``:
  gout to feature-dtype gradients whichever dtype the wrapper returns.

Each call's card ms (CUDA events over 50 calls after a warm-up) and host µs
per call (the mean of 100 calls that are not synchronised), the backward's
peak memory, and a float64 sum of each output are printed per turn; then one
JSON line with the per-call means of both checkouts and the ratio of their
card times. It needs a CUDA card and exits non-zero if a turn fails.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
_TURN = (
    "import json, sys, torch\n"
    "sys.path.insert(0, '.')\n"
    "import chip_smoke as cs\n"
    "from lvc_tpu_torch.ops import roi_align as ra\n"
    "feats, boxes = cs.kernel_inputs(torch.bfloat16)\n"
    "shapes = [tuple(f.shape[1:3]) for f in feats]\n"
    "level_shapes = [tuple(f.shape) for f in feats]\n"
    "B = boxes.shape[0]\n"
    "train = boxes[:, :cs.TRAIN_BOXES].contiguous()\n"
    "band = ra.band_taps(ra.tiled_prep_band(shapes, B, boxes, cs.STRIDES, dtype=torch.bfloat16), shapes, B, 32, True)\n"
    "paired = ra.paired_taps(ra.tiled_prep_2d(shapes, B, boxes, cs.STRIDES, dtype=torch.bfloat16), shapes, 48)\n"
    "ptrain = ra.paired_taps(ra.tiled_prep_2d(shapes, B, train, cs.STRIDES, dtype=torch.bfloat16), shapes, 48)\n"
    "n, P, _ = ptrain.rows.shape\n"
    "g = torch.Generator(device='cuda').manual_seed(1)\n"
    "gout = torch.randn(n, P, P, feats[0].shape[-1], generator=g, device='cuda').to(torch.bfloat16)\n"
    "calls = {\n"
    "    'roi_align_band 8x1000': lambda: [ra.roi_align_band(feats, band)],\n"
    "    'roi_align_paired 8x1000': lambda: [ra.roi_align_paired(feats, paired)],\n"
    "    'roi_align_paired 8x512': lambda: [ra.roi_align_paired(feats, ptrain)],\n"
    "    'backward 8x512': lambda: [x.to(gout.dtype) for x in ra.roi_align_paired_bwd(level_shapes, ptrain, gout)],\n"
    "}\n"
    "out = {}\n"
    "for name, fn in calls.items():\n"
    "    total = sum(float(x.double().sum()) for x in fn())\n"
    "    torch.cuda.synchronize()\n"
    "    base = torch.cuda.memory_allocated()\n"
    "    torch.cuda.reset_peak_memory_stats()\n"
    "    fn()\n"
    "    torch.cuda.synchronize()\n"
    "    peak = torch.cuda.max_memory_allocated() - base\n"
    "    out[name] = [cs.cuda_ms(fn, 50), cs.host_us(fn, 100), peak, total]\n"
    "print(json.dumps(out))\n"
)


def turn(root: Path) -> dict:
    """One turn from ``root``: {call: [card ms, host µs, peak bytes, sum]}."""
    proc = subprocess.run([sys.executable, "-c", _TURN], cwd=root, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"turn of {root} failed:\n{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, help="root of the other checkout")
    args = ap.parse_args(argv)
    other = Path(args.other).resolve()
    if not (other / "chip_smoke.py").exists():
        print(f"compare_roi_kernels: no chip_smoke.py under {other}", file=sys.stderr)
        return 2
    runs = {"other": [], "this": []}
    for name, root in (("other", other), ("this", ROOT), ("this", ROOT), ("other", other)):
        calls = turn(root)
        runs[name].append(calls)
        print(f"{name} ({root}): " + "; ".join(
            f"{k} {v[0]:.4f} ms {v[1]:.1f} host us peak {v[2] / 2 ** 20:.1f} MiB sum {v[3]:.6e}"
            for k, v in calls.items()), flush=True)
    rows = []
    for call in runs["this"][0]:
        mean = {k: [sum(r[call][i] for r in v) / len(v) for i in range(3)] for k, v in runs.items()}
        rows.append(dict(call=call, other_ms=mean["other"][0], this_ms=mean["this"][0],
                         other_over_this=mean["other"][0] / mean["this"][0],
                         other_host_us=mean["other"][1], this_host_us=mean["this"][1],
                         other_peak_bytes=mean["other"][2], this_peak_bytes=mean["this"][2]))
    print(json.dumps({"calls": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
