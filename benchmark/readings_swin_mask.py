"""Readings that the limits of a ``train_swin_mask`` cell are set from (not
run by the benchmark's own runs), as ``benchmark.readings`` gives them for
the other cells:

    python3 -m benchmark.readings_swin_mask --workload swin_s_mask_train_b8 --seeds 1,2 --mode <mode> [--seconds 3]

``program``: sound runs (each seed a whole run with a short window), the
lower readings; ``control``: the reference in the program's place in fp8
e4m3 (one precision below the configuration's bf16 AMP); the faults, each
planted under the timed path: ``unchanged`` (the step leaves the state
unchanged), ``half`` (a step on half of each batch), ``mask_shift`` (each
slot's mask logits handed to the next slot). One JSON line a seed on
standard output.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from benchmark import faults, spec
from benchmark.drivers import train_swin_mask

CONTROL = "fp8"


class MaskShift:
    """The mask head's logits of each slot handed to the next slot."""

    def wrap_step(self, step, model, optimizer):
        model.roi_heads.mask_head.register_forward_hook(lambda module, inputs, output: output.roll(1, 0))
        return step


FAULTS = {"unchanged": faults.Unchanged, "half": faults.HalfBatch, "mask_shift": MaskShift}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--mode", required=True, choices=("program", "control") + tuple(FAULTS))
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    cell = spec.cell(args.workload)
    config = spec.config(cell["config"])
    device = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        if args.mode == "control":
            numbers = train_swin_mask.played(dict(config["cfg"]), cell, seed, device, CONTROL)
        else:
            fault = FAULTS[args.mode]() if args.mode in FAULTS else None
            numbers = train_swin_mask.run(dict(cell), config, seed, args.seconds, False, device, faults=fault)["numbers"]
        print(json.dumps({"workload": args.workload, "mode": args.mode, "seed": seed, "numbers": numbers}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
