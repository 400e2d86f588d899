"""Equivalence and timing check of the fused residual GEMM on the serving
path (the port's twin of scripts/check_fused_serving.py).

Builds the serving configuration (R-101-FPN, bf16, ``POOLER_IMPL``
pallas_fast) with seeded damped weights and ``SCORE_THRESH_TEST`` 0.0, so
the detections are not vacuous, runs the same seeded batch with the fused
path on and off (``LVC_TPU_FUSED_RESIDUAL``, read at call time), and prints
ms/batch and img/s of both, the valid counts, the max |box| and |score|
deltas on detections valid in both, and the speedup.

    python -m lvc_tpu_torch.tools.check_fused_serving [--batch 16] [--height 832]
        [--width 1344] [--iters 10] [--device cpu]

It runs on the card unless ``--device cpu``. Detections are compared slot
by slot: with random weights the class scores nearly tie, so the slots of
the two runs may hold different boxes where the scores swap order.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Optional

import torch

from lvc_tpu_torch.config import get_cfg
from lvc_tpu_torch.modeling.layers import fused_residual
from lvc_tpu_torch.modeling.meta_arch.build import build_model
from lvc_tpu_torch.utils.init import damped_init


def serving_cfg():
    cfg = get_cfg()
    cfg.merge_from_file("configs/Base-RCNN-FPN.yaml")
    cfg.MODEL.RESNETS.DEPTH = 101
    cfg.MODEL.ROI_HEADS.NUM_CLASSES = 80
    cfg.MODEL.DTYPE = "bfloat16"
    cfg.MODEL.ROI_HEADS.POOLER_IMPL = "pallas_fast"
    cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST = 0.0
    return cfg


def _run(model, batch, fused: bool, iters: int):
    """The detections of ``batch`` and the ms per batch over ``iters`` forwards
    after one warm-up, with the fused path on or off."""
    cuda = model.device.type == "cuda"
    with fused_residual(fused):
        dets = model(batch)
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            dets = model(batch)
        if cuda:
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / iters
    return dets, ms


def compare(batch: int = 16, height: int = 832, width: int = 1344, iters: int = 10,
            device: Optional[str] = None, seed: int = 0) -> Dict[str, float]:
    """Runs the batch fused and unfused, prints the comparison and returns
    its numbers."""
    model = damped_init(build_model(serving_cfg(), device=device), seed=seed)
    g = torch.Generator(device=model.device).manual_seed(seed)
    images = {
        "image": torch.rand(batch, height, width, 3, generator=g, device=model.device) * 255,
        "image_size": torch.tensor([[height, width]] * batch, dtype=torch.int32, device=model.device),
    }
    out_f, ms_f = _run(model, images, True, iters)
    out_u, ms_u = _run(model, images, False, iters)
    both = out_f.valid & out_u.valid
    res = {
        "fused_ms": ms_f, "unfused_ms": ms_u,
        "fused_img_s": batch * 1e3 / ms_f, "unfused_img_s": batch * 1e3 / ms_u,
        "valid_fused": int(out_f.valid.sum()), "valid_unfused": int(out_u.valid.sum()),
        "max_box_delta": float((out_f.boxes - out_u.boxes).abs()[both].max()) if bool(both.any()) else 0.0,
        "max_score_delta": float((out_f.scores - out_u.scores).abs()[both].max()) if bool(both.any()) else 0.0,
        "speedup": ms_u / ms_f,
    }
    for key, dets in (("fused", out_f), ("unfused", out_u)):
        if not (torch.isfinite(dets.boxes).all() and torch.isfinite(dets.scores).all()):
            raise FloatingPointError(f"{key}: non-finite detections")
    print(f"fused=True: {ms_f:7.2f} ms/batch {res['fused_img_s']:7.2f} img/s")
    print(f"fused=False: {ms_u:7.2f} ms/batch {res['unfused_img_s']:7.2f} img/s")
    print(f"valid count fused/unfused: {res['valid_fused']} {res['valid_unfused']}")
    print(f"max |box delta| on co-valid: {res['max_box_delta']}")
    print(f"max |score delta| on co-valid: {res['max_score_delta']}")
    print(f"speedup: {res['speedup']:.3f}x")
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--height", type=int, default=832)
    ap.add_argument("--width", type=int, default=1344)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--device", default=None, help="cpu to run on the CPU; the card otherwise")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    compare(args.batch, args.height, args.width, args.iters, args.device)


if __name__ == "__main__":
    main()
