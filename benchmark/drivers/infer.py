"""An inference cell: the program's eval forward (``GeneralizedRCNN``'s
detections) on a pool of device-resident batches, one call after another
(a closed loop of one client), each call timed from the call to its
detections on the host, as the evaluator takes them.

Cell keys: ``traffic`` (the generator's parameters), ``check_batches`` (how
many served batches the reference judges, drawn from the seed among the
first ``check_within``), ``trace_steps``, ``limits``.
"""
from __future__ import annotations

import gc
import itertools
import sys
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark import program
from benchmark.drivers.train import print_steps
from benchmark.reference import boxes as bx
from benchmark.reference import weights as ref_weights
from benchmark.traffic.images import make_pool

FIELDS = ("boxes", "scores", "classes", "valid", "proposal_idx")


def _worst(a: float, b: float) -> float:
    return a if a != a else b if b != b else max(a, b)


class HostDetections:
    def __init__(self, dets):
        # the first copy waits for the device; the rest are host copies
        for f in FIELDS:
            setattr(self, f, getattr(dets, f).cpu())


def run(cell: Dict, config: Dict, seed: int, seconds: float, trace: bool, device, overrides=None, faults=None,
        kernels=()):
    from benchmark import counts
    from benchmark.check import infer_numbers
    from benchmark.trace import Profile

    marks = [("imports", time.time())]
    cfgd = dict(config["cfg"], **(overrides or {}))
    cfg = program.port_cfg(config, overrides)
    model = program.build_model(cfg, ref_weights.make(cfgd, bx.fold_in(seed, 1), device), device)
    model.eval()
    marks.append(("model and weights", time.time()))
    if faults:
        model = faults.wrap_model(model)
    pool = make_pool(cell["traffic"], cfgd, bx.fold_in(seed, 2), device, with_gt=False)
    marks.append(("traffic", time.time()))
    # set-up: the first batch of each canvas once (the shapes the window runs)
    for j in sorted({tuple(b["image"].shape[1:3]): j for j, b in reversed(list(enumerate(pool)))}.values()):
        HostDetections(model(pool[j]))
    rng = np.random.RandomState(bx.fold_in(seed, 4) % (2 ** 32))
    sample = set(int(j) for j in rng.choice(cell["check_within"], cell["check_batches"], replace=False))
    capture = program.Capture(model.module if hasattr(model, "module") else model)
    if device.type == "cuda":
        torch.cuda.synchronize(device)

    B = cell["traffic"]["batch"]
    setup_done = time.time()
    marks.append(("warm-up", setup_done))
    lat: List[float] = []
    kept = {}
    flops = 0.0
    i = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        batch = pool[i % len(pool)]
        if i in sample:
            capture.begin()
        t = time.perf_counter()
        dets = HostDetections(model(batch))
        lat.append(time.perf_counter() - t)
        if i in sample:
            capture.end()
            kept[i] = dets
        H, W = batch["image"].shape[1:3]
        flops += B * counts.model_flops(cfgd, H, W, train=False)
        i += 1
    window_s = time.perf_counter() - t0
    capture.end()
    peak, _ = counts.peak_flops(cfgd, train=False)
    window = {"seconds": window_s, "steps": i, "images": i * B, "flops": flops, "peak_flops": peak}

    summary, kc, traced = None, None, 0
    if trace:
        with program.KernelCalls(kernels) as kc, program.ranges(model), Profile(program.RANGES_INFER) as prof:
            for j in range(cell["trace_steps"]):
                HostDetections(model(pool[(i + j) % len(pool)]))
                traced += 1
        summary = prof.summary
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    least_ms = kc.least_ms() if kc is not None else {}
    del kc
    calls_kept = [c for c in capture.calls]
    capture.remove()
    del model
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    judged = sorted(kept)
    if judged:
        call = calls_kept[0]
        thresh = cfgd["MODEL.ROI_HEADS.SCORE_THRESH_TEST"]
        probs = torch.softmax(call["scores"], -1)[:, :-1]
        cand = (probs > thresh).sum().item() / B
        print(f"candidates an image above SCORE_THRESH_TEST {thresh}: {cand:.1f} (proposal, class) pairs; "
              f"detections an image: {kept[judged[0]].valid.sum().item() / B:.1f}", file=sys.stderr)
    numbers: Dict[str, float] = {}
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        params = ref_weights.make(cfgd, bx.fold_in(seed, 1), device)
        for j, call in zip(judged, calls_kept):
            got = infer_numbers(cfgd, params, pool[j % len(pool)], call, kept[j])
            for k, v in got.items():
                numbers[k] = _worst(numbers.get(k, v), v)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    if not judged:
        numbers["judged_batches"] = 0
    print_steps([0.0] + list(itertools.accumulate(lat)))
    lat_ms = sorted(1e3 * t for t in lat)
    return {"setup_done": setup_done, "setup_marks": marks, "window": window, "trace": summary, "traced_steps": traced,
            "kernel_least_ms": least_ms, "memory_peak_bytes": memory_peak, "numbers": numbers,
            "attempted": i, "failed": 0,
            "e2e": {"infer_img_per_s": window["images"] / window_s,
                    "infer_batch_p95_ms": float(np.percentile(lat_ms, 95)) if lat_ms else float("nan")}}
