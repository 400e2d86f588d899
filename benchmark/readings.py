"""Readings that the cells' limits are set from (not run by the benchmark's
own runs):

    python3 -m benchmark.readings --workload <cell> --seeds 1,2,3 --mode <mode> [--seconds 3]

``program``: sound runs of the program (each seed a whole run with a short
window), the lower readings; ``noexchange``: runs of a data-parallel cell
with the gradients' exchange left out (a fault planted in the program);
``control``: the reference in the program's place one precision below the
configuration's (fp8 e4m3 for the AMP training config, bfloat16 for the
float32 inference config), judged as the program is; ``half``: a training
step on half of each batch, the mean over the rest (a fault); ``answer``:
one served detection's score altered where it is produced (a fault). One
JSON line a seed on standard output.
"""
from __future__ import annotations

import argparse
import importlib
import json
import sys

import numpy as np
import torch

from benchmark import check, faults, spec
from benchmark.reference import boxes as bx
from benchmark.reference import train as ref_train
from benchmark.reference import weights as ref_weights
from benchmark.traffic.images import make_pool

CONTROL = {"train": "fp8", "infer": "bf16"}


def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False


def train_played(cell, config, seed, device, mode, overrides=None) -> dict:
    cfgd = dict(config["cfg"], **(overrides or {}))
    _no_tf32()
    params0 = ref_weights.make(cfgd, bx.fold_in(seed, 1), device)
    pool = make_pool(cell["traffic"], cfgd, bx.fold_in(seed, 2), device)
    n = cell["check_steps"]
    batches = [pool[i % len(pool)] for i in range(n)]
    seeds = [bx.fold_in(seed, 3, i) for i in range(n)]
    if mode == "control":
        played = check.player_readings(cfgd, params0, batches, seeds, CONTROL["train"])
        ref = ref_train.steps(cfgd, params0, batches, seeds, "fp32", played["selections"])
    else:  # half
        played = check.player_readings(cfgd, params0, batches, seeds, "fp32", drop_half=True)
        ref = ref_train.steps(cfgd, params0, batches, seeds, "fp32")
    return check.train_numbers(cfgd, played, ref)


def infer_played(cell, config, seed, device, mode, overrides=None) -> dict:
    cfgd = dict(config["cfg"], **(overrides or {}))
    _no_tf32()
    params = ref_weights.make(cfgd, bx.fold_in(seed, 1), device)
    pool = make_pool(cell["traffic"], cfgd, bx.fold_in(seed, 2), device, with_gt=False)
    rng = np.random.RandomState(bx.fold_in(seed, 4) % (2 ** 32))
    out = {}
    for j in sorted(int(j) for j in rng.choice(cell["check_within"], cell["check_batches"], replace=False)):
        batch = pool[j % len(pool)]
        call, dets = check.infer_player(cfgd, params, batch, CONTROL["infer"] if mode == "control" else "fp32")
        if mode == "answer":
            dets = faults.altered(dets)
        for k, v in check.infer_numbers(cfgd, params, batch, call, dets).items():
            out[k] = max(out.get(k, v), v)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--mode", required=True, choices=("program", "noexchange", "control", "half", "answer"))
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    cell = spec.cell(args.workload)
    config = spec.config(cell["config"])
    device = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        if args.mode in ("program", "noexchange"):
            driver = importlib.import_module(f"benchmark.drivers.{cell['driver']}")
            fault = faults.NoExchange() if args.mode == "noexchange" else None
            numbers = driver.run(cell, config, seed, args.seconds, False, device, faults=fault)["numbers"]
        elif cell["driver"] == "train":
            numbers = train_played(cell, config, seed, device, args.mode)
        else:
            numbers = infer_played(cell, config, seed, device, args.mode)
        print(json.dumps({"workload": args.workload, "mode": args.mode, "seed": seed, "numbers": numbers}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
