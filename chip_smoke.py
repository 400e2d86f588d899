#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (lvc_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of the repository

Phases, each of which raises (non-zero exit) on failure:
1. build every kernel source with nvcc for sm_90a, all in parallel;
2. kernel phase: each RoIAlign kernel and its plain PyTorch version on the
   same seeded inputs at the serving path's shapes (p2-p5 of an 8x832x1344
   batch, C=256, bf16, 1000 boxes per image), error, times and bound;
3. reference check: a narrow R-50-FPN at float32 on a small input, on the
   card (kernels) and on the CPU (plain versions), for the band and paired
   pools; proposals and detections must agree;
4. main path: R-101-FPN at full width, 832x1344, bf16, POOLER_IMPL
   pallas_fast, B=8, seeded damped weights, 1 warm-up + 3 timed forwards,
   with every kernel count set to 0 just before and read just after; then
   one B=2 POOLER_IMPL=auto forward, which takes the paired kernel;
5. backward kernel phase: the RoIAlign backward kernel (K3) and its plain
   version at the training path's shapes (p2-p5 of 8x832x1344, C=256, bf16,
   512 boxes per image), error against the sum of absolute contributions,
   times, bound, and the accumulators' zero-fill and cast as torch ops;
6. training reference check: one train step of a narrow R-50-FPN at float32
   (POOLER_IMPL pallas_train, exhaustive sampling) on the card (K2 forward,
   K3 backward) and on the CPU (plain versions) from the same weights;
   losses and every parameter gradient must agree;
7. training main path: the R-50-FPN train step at full width, bf16 AMP,
   POOLER_IMPL pallas_train, B=8 at 832x1344 with 100 gt slots, seeded damped
   weights, 1 warm-up + 5 timed steps with every kernel count set to 0 just
   before and read just after; one profiled step with the device time of
   each stage (the profiler ranges of the step and the model's forward).
The last three lines are the kernels' JSON, the card's name and power limit,
and {"ok": true, "device": ...}. Float32 comparisons run with TF32 off for
both convolutions and matmuls (set below).
"""
import json
import math
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
KERNEL_REPLACES = {
    "roi_align_band": "lvc_tpu/ops/roi_align.py:2150; lvc_tpu/ops/roi_align.py:1718; "
                      "lvc_tpu/ops/roi_align.py:1505",
    "roi_align_paired": "lvc_tpu/ops/roi_align.py:1133; lvc_tpu/ops/roi_align.py:2813; "
                        "lvc_tpu/ops/roi_align.py:717",
    "roi_align_paired_bwd": "lvc_tpu/ops/roi_align.py:3174; lvc_tpu/ops/roi_align.py:2340",
}
KERNEL_SOURCE = {
    "roi_align_band": "lvc_tpu_torch/ops/csrc/roi_align_fwd.cu",
    "roi_align_paired": "lvc_tpu_torch/ops/csrc/roi_align_fwd.cu",
    "roi_align_paired_bwd": "lvc_tpu_torch/ops/csrc/roi_align_bwd.cu",
}
TRAIN_BOXES = 512  # ROI_HEADS.BATCH_SIZE_PER_IMAGE: the sampled boxes per image
MAIN_SHAPES = [(208, 336), (104, 168), (52, 84), (26, 42)]  # p2-p5 of 832x1344
STRIDES = (4, 8, 16, 32)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bf16_ulp(x):
    import torch

    mag = x.abs().clamp(min=2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def kernel_inputs(dtype, seed: int = 0):
    """Seeded features and boxes at the main path's shapes, with canvas-wide
    boxes (over-wide on p5: the window clamp) and corner-hugging boxes."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    B, R, C = 8, 1000, 256
    feats = [
        torch.randn(B, C, h, w, generator=g, device="cuda").to(dtype)
        .contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
        for h, w in MAIN_SHAPES
    ]
    xy = torch.rand(B, R, 2, generator=g, device="cuda") * torch.tensor([1344.0, 832.0], device="cuda")
    wh = torch.exp(torch.rand(B, R, 2, generator=g, device="cuda") * 4.3) * 8  # 8 .. ~590 px
    boxes = torch.cat([xy - wh / 2, xy + wh / 2], -1)
    boxes[..., 0::2] = boxes[..., 0::2].clamp(0, 1344)
    boxes[..., 1::2] = boxes[..., 1::2].clamp(0, 832)
    special = torch.tensor(
        [[0, 0, 1344, 832], [0, 0, 1344, 100], [0, 700, 1344, 832], [1300, 800, 1344, 832],
         [0, 800, 40, 832], [1310, 0, 1344, 30], [0, 0, 20, 20], [600, 400, 600, 400]],
        dtype=torch.float32, device="cuda",
    )
    boxes[:, : len(special)] = special
    return feats, boxes


def touched(level_shapes, taps):
    """The taps the kernels use (rows with a weight, columns with a weight
    inside the level) and the number of distinct feature pixels they touch.
    ``level_shapes`` are the levels' (B, H, W, C)."""
    import torch

    rows_ok = (taps.wy != 0) & (taps.rows >= 0)  # (n, P, NR)
    pixels = 0
    cols_ok_all = torch.zeros(taps.wx.shape, dtype=torch.bool, device=taps.wx.device)
    for l, (B, H, W, _) in enumerate(level_shapes):
        sel = taps.lvl == l
        cols = taps.xs[:, None, None].long() + taps.tcol.long()
        cols_ok = (taps.wx != 0) & (cols < W)
        cols_ok_all |= cols_ok & sel[:, None, None]
        r = torch.where(rows_ok & sel[:, None, None], taps.rows.long(), -1)  # (n, Py, NR)
        c = torch.where(cols_ok & sel[:, None, None], cols, -1)  # (n, Px, NT)
        lin = r[:, :, :, None, None] * W + c[:, None, None, :, :]
        ok = (r[:, :, :, None, None] >= 0) & (c[:, None, None, :, :] >= 0)
        mark = torch.zeros(B * H * W, dtype=torch.bool, device=taps.wx.device)
        mark[lin[ok]] = True
        pixels += int(mark.sum())
    return rows_ok, cols_ok_all, pixels


def _roofline(nbytes, ops):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes, ops


def bound(feats, taps):
    """Least time for the card: bytes (each feature element the samples touch
    read once, the kernel's other inputs read once, the output written once)
    over the memory rate, against this data's multiply-adds over the float32
    rate. Counts what these inputs need (zero-weight and padding reads are
    not counted)."""
    n, P, NR = taps.rows.shape
    C, isz = feats[0].shape[-1], feats[0].element_size()
    rows_ok, cols_ok, pixels = touched([tuple(f.shape) for f in feats], taps)
    out_bytes = n * P * P * C * isz
    meta_bytes = sum(t.numel() * t.element_size() for t in taps)
    nbytes = pixels * C * isz + out_bytes + meta_bytes
    nr = rows_ok.sum(-1)  # nonzero rows per (n, py)
    nt = cols_ok.sum(-1)  # nonzero taps per (n, px)
    ops = C * int((nt[:, None, :] * (2 * nr[:, :, None] + 2) + 1).sum())
    return _roofline(nbytes, ops)


def backward_bound(level_shapes, taps, gout):
    """Least time for K3's function (d pooled -> d features): gout and the
    taps read once and each feature-gradient element the taps touch written
    once in float32, over the memory rate, against this data's operations
    over the float32 rate (per channel: the 1/count scale of each output
    cell, and a multiply and an add for each nonzero row-column tap pair).
    Reading the zeroed accumulators back is the atomic design's cost, not
    the function's, and is not counted."""
    C = gout.shape[-1]
    rows_ok, cols_ok, pixels = touched(level_shapes, taps)
    meta_bytes = sum(t.numel() * t.element_size() for t in taps)
    nbytes = gout.numel() * gout.element_size() + meta_bytes + pixels * C * 4
    nr = rows_ok.sum(-1)
    nt = cols_ok.sum(-1)
    ops = C * int((nt[:, None, :] * 2 * nr[:, :, None] + 1).sum())
    return _roofline(nbytes, ops)


def kernel_phase(tag):
    import torch

    from lvc_tpu_torch.ops import roi_align as ra

    feats, boxes = kernel_inputs(torch.bfloat16)
    shapes = [tuple(f.shape[1:3]) for f in feats]
    B = boxes.shape[0]
    cases = {
        "roi_align_band": (ra.roi_align_band, ra.band_taps(
            ra.tiled_prep_band(shapes, B, boxes, STRIDES, dtype=torch.bfloat16), shapes, B, 32, True)),
        "roi_align_paired": (ra.roi_align_paired, ra.paired_taps(
            ra.tiled_prep_2d(shapes, B, boxes, STRIDES, dtype=torch.bfloat16), shapes, 48)),
    }
    results = {}
    for name, (kernel, taps) in cases.items():
        got = kernel(feats, taps)
        torch.cuda.synchronize()
        want = ra.roi_align_taps_plain(feats, taps, kernel.paired)
        if not torch.isfinite(got).all():
            raise AssertionError(f"{name}: non-finite output")
        err = (got.float() - want.float()).abs()
        # tolerance: one bf16 ulp of the output magnitude, element by element
        tol = bf16_ulp(torch.maximum(got.float().abs(), want.float().abs()))
        if not bool((err <= tol).all()):
            raise AssertionError(f"{name}: max abs err {float(err.max())} over 1 bf16 ulp")
        ms = cuda_ms(lambda: kernel(feats, taps), 50)
        plain_ms = cuda_ms(lambda: ra.roi_align_taps_plain(feats, taps, kernel.paired), 3)
        bound_ms, bound_by, nbytes, ops = bound(feats, taps)
        results[name] = dict(
            name=name, route="cuda", source=KERNEL_SOURCE[name], replaces=KERNEL_REPLACES[name],
            launches=0, max_abs_err=float(err.max()), ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
        )
        print(f"kernel {name}: boxes {taps.lvl.numel()} max_abs_err {float(err.max())} "
              f"(tolerance 1 bf16 ulp) ms {ms:.4f} plain_ms {plain_ms:.3f} bound_ms {bound_ms:.4f} "
              f"({bound_by}; {nbytes} bytes, {ops} ops) {tag}")
    return results


def calibrated_init(model, seed: int):
    """He-normal weights scaled to keep a narrow detector's outputs well
    spread (FPN features O(10), RPN logits std ~1-2, class scores in
    (0.05, 0.5)): the reference check then has no near-ties to flip."""
    import math

    import torch

    gen = torch.Generator().manual_seed(seed)
    scale = {
        "backbone.bottom_up.": 0.7, "proposal_generator.rpn_head.conv.": 0.1,
        "proposal_generator.rpn_head.objectness_logits.": 0.1,
        "proposal_generator.rpn_head.anchor_deltas.": 0.01,
        "roi_heads.box_predictor.cls_score.": 0.03, "roi_heads.box_predictor.bbox_pred.": 0.3,
    }
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if name.endswith(("bias", "running_mean")):
                t.zero_()
            elif name.endswith("running_var") or ".norm." in name:
                t.fill_(1.0)
            else:
                std = math.sqrt(2.0 / (t.shape[0] * t[0, 0].numel())) if t.dim() == 4 else math.sqrt(1.0 / t.shape[1])
                f = next((v for k, v in scale.items() if name.startswith(k)), 1.0)
                t.copy_(torch.randn(t.shape, generator=gen) * std * f)


def narrow_cfg(impl: str):
    """A narrow R-50-FPN (64-wide res2 and FPN, 5 classes) for the reference
    checks."""
    from lvc_tpu_torch.config import get_cfg

    cfg = get_cfg()
    cfg.merge_from_file("configs/Base-RCNN-FPN.yaml")
    cfg.MODEL.RESNETS.RES2_OUT_CHANNELS = 64
    cfg.MODEL.RESNETS.WIDTH_PER_GROUP = 16
    cfg.MODEL.FPN.OUT_CHANNELS = 64
    cfg.MODEL.ROI_HEADS.NUM_CLASSES = 5
    cfg.MODEL.ROI_BOX_HEAD.FC_DIM = 128
    cfg.MODEL.ROI_HEADS.POOLER_IMPL = impl
    return cfg


def reference_check(tag):
    import numpy as np
    import torch

    from lvc_tpu_torch.modeling.meta_arch.build import build_model

    rng = np.random.RandomState(3)
    batch = {
        "image": (rng.rand(2, 128, 192, 3) * 255).astype(np.float32),
        "image_size": np.array([[128, 192], [112, 160]], np.int32),
    }
    for impl in ("pallas_fast", "pallas"):
        cfg = narrow_cfg(impl)
        cfg.MODEL.RPN.PRE_NMS_TOPK_TEST = 200
        cfg.MODEL.RPN.POST_NMS_TOPK_TEST = 100
        cfg.TEST.DETECTIONS_PER_IMAGE = 30
        cpu = build_model(cfg, device="cpu")
        calibrated_init(cpu, seed=0)
        gpu = build_model(cfg)
        gpu.load_state_dict(cpu.state_dict())
        out = {}
        for key, model in (("cpu", cpu), ("gpu", gpu)):
            props = model.proposals(batch)
            dets = model(batch)
            out[key] = [t.cpu() for t in props] + [t.cpu() for t in dets]
        c, g = out["cpu"], out["gpu"]
        if not torch.equal(c[2], g[2]) or int(c[2].sum()) < 50:
            raise AssertionError(f"{impl}: proposal validity differs or too few proposals")
        prop_err = float((c[0] - g[0]).abs().max())
        dv = c[6]
        if not torch.equal(dv, g[6]) or int(dv.sum()) < 10 or not torch.equal(c[5][dv], g[5][dv]):
            raise AssertionError(f"{impl}: detections differ in validity or class")
        box_err = float((c[3][dv] - g[3][dv]).abs().max())
        score_err = float((c[4][dv] - g[4][dv]).abs().max())
        if prop_err > 1e-3 or box_err > 1e-3 or score_err > 1e-4:
            raise AssertionError(f"{impl}: errors {prop_err} {box_err} {score_err}")
        print(f"reference {impl}: card vs CPU at float32, {int(c[2].sum())} proposals max err "
              f"{prop_err:.2e} (tol 1e-3), {int(dv.sum())} detections box err {box_err:.2e} "
              f"(tol 1e-3) score err {score_err:.2e} (tol 1e-4) {tag}")


def serving_cfg(impl: str):
    from lvc_tpu_torch.config import get_cfg

    cfg = get_cfg()
    cfg.merge_from_file("configs/Base-RCNN-FPN.yaml")
    cfg.MODEL.RESNETS.DEPTH = 101
    cfg.MODEL.ROI_HEADS.NUM_CLASSES = 80
    cfg.MODEL.DTYPE = "bfloat16"
    cfg.MODEL.ROI_HEADS.POOLER_IMPL = impl
    cfg.MODEL.RPN.APPROX_TOPK = True  # the port maps it to the exact top-k
    return cfg


def main_path(tag, kernels):
    import torch

    from lvc_tpu_torch.modeling.meta_arch.build import build_model
    from lvc_tpu_torch.ops import roi_align as ra
    from lvc_tpu_torch.utils.init import damped_init

    wrappers = {"roi_align_band": ra.roi_align_band, "roi_align_paired": ra.roi_align_paired}
    model = damped_init(build_model(serving_cfg("pallas_fast")), seed=0)
    g = torch.Generator(device="cuda").manual_seed(0)
    B, H, W = 8, 832, 1344
    batch = {
        "image": torch.rand(B, H, W, 3, generator=g, device="cuda") * 255,
        "image_size": torch.tensor([[H, W]] * B, dtype=torch.int32, device="cuda"),
    }
    dets = model(batch)  # warm-up
    torch.cuda.synchronize()

    for w in wrappers.values():
        w.launches = 0
    iters = 3
    t0 = time.perf_counter()
    for _ in range(iters):
        dets = model(batch)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / iters
    counts = {k: w.launches for k, w in wrappers.items()}
    kernels["roi_align_band"]["launches"] = counts["roi_align_band"]
    if counts["roi_align_band"] < iters:
        raise AssertionError(f"main path did not go through the band kernel: {counts}")
    check_detections(dets, B)
    print(f"main path R-101-FPN 832x1344 bf16 pallas_fast B={B}: {ms:.2f} ms/batch "
          f"{B * 1e3 / ms:.2f} img/s, launches {counts}, valid detections "
          f"{int(dets.valid.sum())} {tag}")

    # stage breakdown of one forward (host clock around synchronised stages)
    with torch.no_grad():
        marks = [time.perf_counter()]
        feats = model.backbone(model.model_images(batch)); torch.cuda.synchronize(); marks.append(time.perf_counter())
        sizes = batch["image_size"]
        props, _, pvalid, _ = model.proposal_generator(feats, sizes); torch.cuda.synchronize(); marks.append(time.perf_counter())
        pooled = model.roi_heads.pool(feats, props); torch.cuda.synchronize(); marks.append(time.perf_counter())
        model.roi_heads(feats, props, pvalid, sizes); torch.cuda.synchronize(); marks.append(time.perf_counter())
    stages = ["backbone", "rpn", "pool", "roi_heads(pool+head+inference)"]
    print("main path stages ms: " + ", ".join(
        f"{s} {(marks[i + 1] - marks[i]) * 1e3:.2f}" for i, s in enumerate(stages)) + f" {tag}")
    profile_call(lambda: model(batch), ms, "forward", tag)
    del model, feats, props, pooled
    torch.cuda.empty_cache()

    # second path: POOLER_IMPL auto takes the paired kernel on CUDA
    model = damped_init(build_model(serving_cfg("auto")), seed=0)
    small = {"image": batch["image"][:2], "image_size": batch["image_size"][:2]}
    for w in wrappers.values():
        w.launches = 0
    dets = model(small)
    torch.cuda.synchronize()
    counts = {k: w.launches for k, w in wrappers.items()}
    kernels["roi_align_paired"]["launches"] = counts["roi_align_paired"]
    if counts["roi_align_paired"] < 1:
        raise AssertionError(f"auto path did not go through the paired kernel: {counts}")
    check_detections(dets, 2)
    print(f"auto path R-101-FPN 832x1344 bf16 B=2: launches {counts} {tag}")


def profile_call(fn, untraced_ms, what, tag, stages=()):
    """One call of ``fn`` (a forward or a train step) under torch.profiler:
    the device's busy time (union of kernel intervals), its idle share of the
    traced device span and of the untraced call's time (the profiler slows
    the host, so the traced share overstates idling), the device time of the
    profiler ranges named in ``stages``, and the ops that take the most
    device time. Prints "not measured" if the profiler records no device
    activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device activity, less the device-side spans the profiler draws for each
    # record_function range (they cover the range, busy or not)
    spans = sorted(
        (e.time_range.start, e.time_range.end)
        for e in prof.events()
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation and e.name not in stages
    )
    if not spans:
        print(f"profile: no device activity recorded; idle share not measured {tag}")
        return
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    span = spans[-1][1] - spans[0][0]
    print(f"profile: traced {what} {wall_ms:.2f} ms wall, device span {span / 1e3:.2f} ms, busy "
          f"{busy / 1e3:.2f} ms, idle share {1 - busy / span:.3f} of the traced span, "
          f"{1 - busy / 1e3 / untraced_ms:.3f} of the untraced {untraced_ms:.2f} ms {tag}")
    if stages:
        stage_times(prof.events(), stages, tag)
    # device time attributed to the host-side ops that launched it
    rows = [
        (a.self_device_time_total, a.count, a.key)
        for a in prof.key_averages()
        if a.device_type == DeviceType.CPU and a.self_device_time_total > 0
    ]
    for t, count, key in sorted(rows, reverse=True)[:12]:
        print(f"  {t / 1e3:8.3f} ms device  x{count:<5d} {key[:80]} {tag}")


def backward_kernel_phase(tag):
    """K3 and its plain version at the training path's shapes. Atomics add
    in no fixed order, so the tolerance is per accumulator element:
    |got - want| <= 1e-5 * S, S the plain backward on |gout| and |weights|;
    after the cast to bf16, 1 bf16 ulp of the plain version's cast plus that
    float32 tolerance (where the sum cancels to near 0, its ulp is below the
    float32 error; the count of such elements is printed)."""
    import torch

    from lvc_tpu_torch.ops import roi_align as ra

    feats, boxes = kernel_inputs(torch.bfloat16)
    boxes = boxes[:, :TRAIN_BOXES].contiguous()
    shapes = [tuple(f.shape[1:3]) for f in feats]
    level_shapes = [tuple(f.shape) for f in feats]
    B, C = boxes.shape[0], feats[0].shape[-1]
    taps = ra.paired_taps(ra.tiled_prep_2d(shapes, B, boxes, STRIDES, dtype=torch.bfloat16), shapes, 48)
    n, P, _ = taps.rows.shape
    g = torch.Generator(device="cuda").manual_seed(1)
    gout = torch.randn(n, P, P, C, generator=g, device="cuda").to(torch.bfloat16)
    del feats

    k3 = ra.roi_align_paired_bwd
    got = k3(level_shapes, taps, gout)
    torch.cuda.synchronize()
    want = ra.roi_align_taps_plain_backward(level_shapes, taps, gout)
    S = ra.roi_align_taps_plain_backward(
        level_shapes, taps._replace(wy=taps.wy.abs(), wx=taps.wx.abs()), gout.abs()
    )
    max_err, max_ratio, over_ulp = 0.0, 0.0, 0
    for l, (a, w, s) in enumerate(zip(got, want, S)):
        err = (a - w).abs()
        if not bool((err <= 1e-5 * s).all()):
            raise AssertionError(f"roi_align_paired_bwd level {l}: error over 1e-5 * S")
        cast, ref = a.to(torch.bfloat16).float(), w.to(torch.bfloat16).float()
        cast_err = (cast - ref).abs()
        if not bool((cast_err <= bf16_ulp(ref) + 1e-5 * s).all()):
            raise AssertionError(f"roi_align_paired_bwd level {l}: bf16 cast over 1 ulp + 1e-5 * S")
        over_ulp += int((cast_err > bf16_ulp(ref)).sum())
        max_err = max(max_err, float(err.max()))
        max_ratio = max(max_ratio, float((err / s.clamp(min=1e-30)).max()))
    del want, S

    accs = [torch.zeros(s, dtype=torch.float32, device="cuda") for s in level_shapes]
    ms = cuda_ms(lambda: k3.launch(accs, taps, gout), 50)
    zero_ms = cuda_ms(lambda: [torch.zeros(s, dtype=torch.float32, device="cuda") for s in level_shapes], 20)
    cast_ms = cuda_ms(lambda: [a.to(torch.bfloat16) for a in accs], 20)
    plain_ms = cuda_ms(lambda: ra.roi_align_taps_plain_backward(level_shapes, taps, gout), 3)
    bound_ms, bound_by, nbytes, ops = backward_bound(level_shapes, taps, gout)
    # the atomics also read each touched accumulator element back: the
    # design's overhead over the function's bound
    rmw_bytes = touched(level_shapes, taps)[2] * C * 4
    print(f"kernel roi_align_paired_bwd: boxes {n} max_abs_err {max_err} max err/S {max_ratio:.3e} "
          f"(tolerance 1e-5 * S; after the cast 1 bf16 ulp + 1e-5 * S, {over_ulp} elements over "
          f"1 ulp alone) ms {ms:.4f} plain_ms {plain_ms:.3f} "
          f"bound_ms {bound_ms:.4f} ({bound_by}; {nbytes} bytes, {ops} ops; the atomics' read-back "
          f"adds {rmw_bytes} bytes, {rmw_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms) zero_fill_ms {zero_ms:.4f} "
          f"cast_ms {cast_ms:.4f} {tag}")
    return dict(
        name="roi_align_paired_bwd", route="cuda", source=KERNEL_SOURCE["roi_align_paired_bwd"],
        replaces=KERNEL_REPLACES["roi_align_paired_bwd"], launches=0, max_abs_err=max_err, ms=ms,
        plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
    )


def train_batch(B, H, W, G, seed, device, num_classes=80, n_gt=(10, 20), size=(16, 600)):
    """Seeded training batch: raw pixels, G gt slots per image of which
    n_gt[0]..n_gt[1] are valid boxes of size[0]..size[1] px inside the image,
    with classes in [0, num_classes)."""
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    boxes = np.zeros((B, G, 4), np.float32)
    classes = np.zeros((B, G), np.int64)
    valid = np.zeros((B, G), bool)
    for b in range(B):
        k = rng.randint(n_gt[0], n_gt[1] + 1)
        wh = rng.uniform(size[0], size[1], (k, 2))
        xy = rng.uniform(0, 1, (k, 2)) * ([W, H] - wh)
        boxes[b, :k] = np.concatenate([xy, xy + wh], -1)
        classes[b, :k] = rng.randint(0, num_classes, k)
        valid[b, :k] = True
    batch = {
        "image": rng.rand(B, H, W, 3).astype(np.float32) * 255,
        "image_size": np.array([[H, W]] * B, np.int32),
        "gt_boxes": boxes, "gt_classes": classes, "gt_valid": valid,
    }
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def train_reference_check(tag):
    """One train step of a narrow R-50-FPN at float32 with POOLER_IMPL
    pallas_train on the card (K2 + K3) and on the CPU (plain versions), from
    the same weights and the same sampling priorities. Sampling is
    exhaustive (RPN 8192 >= the 6138 anchors, ROI 128 >= 100 proposals + 4
    gt): every loss to rel 1e-4, every parameter gradient to rel L2 1e-4."""
    import torch

    from lvc_tpu_torch.engine.train_loop import make_train_step
    from lvc_tpu_torch.modeling.meta_arch.build import build_model
    from lvc_tpu_torch.ops import roi_align as ra
    from lvc_tpu_torch.solver.build import build_lr_schedule, build_optimizer

    cfg = narrow_cfg("pallas_train")
    cfg.MODEL.RPN.PRE_NMS_TOPK_TRAIN = 200
    cfg.MODEL.RPN.POST_NMS_TOPK_TRAIN = 100
    cfg.MODEL.RPN.BATCH_SIZE_PER_IMAGE = 8192
    cfg.MODEL.RPN.POSITIVE_FRACTION = 0.999
    cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE = 128
    cfg.MODEL.ROI_HEADS.POSITIVE_FRACTION = 0.999
    cfg.SOLVER.BASE_LR = 0.01
    cfg.SOLVER.WARMUP_ITERS = 0
    cpu = build_model(cfg, device="cpu")
    calibrated_init(cpu, seed=0)
    gpu = build_model(cfg)
    gpu.load_state_dict(cpu.state_dict())
    batch = train_batch(2, 128, 192, 4, seed=3, device="cpu", num_classes=5, n_gt=(3, 3), size=(24, 100))
    before = ra.roi_align_paired.launches, ra.roi_align_paired_bwd.launches
    res = {}
    for key, model in (("cpu", cpu), ("gpu", gpu)):
        model.train()
        opt = build_optimizer(cfg, model)
        step = make_train_step(model, opt, build_lr_schedule(cfg, opt))
        metrics = step(batch, torch.Generator().manual_seed(0))
        grads = {n: p.grad.detach().cpu().double() for n, p in model.named_parameters() if p.requires_grad}
        res[key] = {k: float(v) for k, v in metrics.items()}, grads
    torch.cuda.synchronize()
    after = ra.roi_align_paired.launches, ra.roi_align_paired_bwd.launches
    if not (after[0] > before[0] and after[1] > before[1]):
        raise AssertionError(f"training reference step did not launch K2 and K3: {before} -> {after}")
    (c_loss, c_grad), (g_loss, g_grad) = res["cpu"], res["gpu"]
    loss_err = max(abs(g_loss[k] - v) / max(abs(v), 1e-30) for k, v in c_loss.items())
    if set(c_loss) != set(g_loss) or loss_err > 1e-4 or c_loss["loss_box_reg"] <= 0:
        raise AssertionError(f"training losses differ: cpu {c_loss} card {g_loss}")
    rel = {n: float((g_grad[n] - w).norm() / w.norm().clamp(min=1e-30)) for n, w in c_grad.items()}
    worst = max(rel, key=rel.get)
    if rel[worst] > 1e-4:
        raise AssertionError(f"training grads differ: {worst} rel L2 {rel[worst]}")
    print(f"train reference pallas_train: card vs CPU at float32, losses {c_loss} max rel err "
          f"{loss_err:.2e} (tol 1e-4); {len(rel)} parameter grads max rel L2 {rel[worst]:.2e} "
          f"({worst}; tol 1e-4); K2/K3 launches +{after[0] - before[0]}/+{after[1] - before[1]} {tag}")


def train_cfg():
    from lvc_tpu_torch.config import get_cfg

    cfg = get_cfg()
    cfg.merge_from_file("configs/Base-RCNN-FPN.yaml")
    cfg.MODEL.RESNETS.DEPTH = 50
    cfg.MODEL.ROI_HEADS.NUM_CLASSES = 80
    cfg.MODEL.ROI_HEADS.POOLER_IMPL = "pallas_train"
    cfg.SOLVER.AMP.ENABLED = True
    cfg.SOLVER.BASE_LR = 1e-4  # random weights
    cfg.SOLVER.WARMUP_ITERS = 0
    return cfg


def train_main_path(tag, kernels):
    import torch

    from lvc_tpu_torch.engine.train_loop import make_train_step
    from lvc_tpu_torch.modeling.meta_arch.build import build_model
    from lvc_tpu_torch.ops import roi_align as ra
    from lvc_tpu_torch.solver.build import build_lr_schedule, build_optimizer
    from lvc_tpu_torch.utils.init import damped_init

    wrappers = {"roi_align_band": ra.roi_align_band, "roi_align_paired": ra.roi_align_paired,
                "roi_align_paired_bwd": ra.roi_align_paired_bwd}
    cfg = train_cfg()
    model = damped_init(build_model(cfg), seed=0).train()
    opt = build_optimizer(cfg, model)
    sched = build_lr_schedule(cfg, opt)
    step = make_train_step(model, opt, sched, mixed_precision=cfg.SOLVER.AMP.ENABLED)
    B, H, W = 8, 832, 1344
    batch = train_batch(B, H, W, cfg.PAD.MAX_GT_PER_IMAGE, seed=0, device="cuda",
                        num_classes=cfg.MODEL.ROI_HEADS.NUM_CLASSES)
    gen = torch.Generator(device="cuda").manual_seed(0)
    step(batch, gen)  # warm-up
    torch.cuda.synchronize()

    for w in wrappers.values():
        w.launches = 0
    torch.cuda.reset_peak_memory_stats()
    steps = 5
    t0 = time.perf_counter()
    metrics = [step(batch, gen) for _ in range(steps)]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / steps
    counts = {k: w.launches for k, w in wrappers.items()}
    peak = torch.cuda.max_memory_allocated()
    for k in ("roi_align_paired", "roi_align_paired_bwd"):
        kernels[k]["launches"] += counts[k]
        if counts[k] < steps:
            raise AssertionError(f"train path did not launch {k} once per step: {counts}")
    losses = [{k: float(v) for k, v in m.items()} for m in metrics]
    if not all(math.isfinite(v) for m in losses for v in m.values()):
        raise AssertionError(f"non-finite training losses: {losses}")
    print(f"train main path R-50-FPN 832x1344 AMP bf16 pallas_train B={B}: {ms:.2f} ms/step "
          f"{B * 1e3 / ms:.2f} img/s, launches {counts}, peak memory {peak / 2 ** 30:.2f} GiB {tag}")
    for i, m in enumerate(losses):
        print(f"  step {i + 1}: " + ", ".join(f"{k} {v:.5f}" for k, v in sorted(m.items())) + f" {tag}")
    profile_call(lambda: step(batch, gen), ms, "train step", tag, TRAIN_STAGES)
    del model, opt
    torch.cuda.empty_cache()


# the profiler ranges of GeneralizedRCNN._losses and make_train_step's step
TRAIN_STAGES = ("backbone", "rpn", "roi_heads", "backward", "optimizer")


def stage_times(events, stages, tag):
    """Device time of each profiler range of ``stages``: the kernels of
    every host op that starts inside the range, on any thread (the backward
    runs on autograd's), beside the range's host time. Kernels of ops outside
    every range are "other"."""
    from torch.autograd import DeviceType

    ranges = {s: [] for s in stages}
    for e in events:
        if e.device_type == DeviceType.CPU and e.name in ranges:
            ranges[e.name].append((e.time_range.start, e.time_range.end))
    device = dict.fromkeys(list(stages) + ["other"], 0.0)
    for e in events:
        if e.device_type != DeviceType.CPU or not e.kernels:
            continue
        t = e.time_range.start
        where = next((s for s, rs in ranges.items() if any(a <= t <= b for a, b in rs)), "other")
        device[where] += sum(k.duration for k in e.kernels)
    host = {s: sum(b - a for a, b in rs) for s, rs in ranges.items()}
    print("stages, device ms (host ms of the traced range): " + ", ".join(
        f"{s} {device[s] / 1e3:.3f} ({host[s] / 1e3:.2f})" for s in stages
    ) + f", other {device['other'] / 1e3:.3f}; sum {sum(device.values()) / 1e3:.3f} {tag}")


def check_detections(dets, B):
    import torch

    D = 100
    if tuple(dets.boxes.shape) != (B, D, 4) or tuple(dets.scores.shape) != (B, D):
        raise AssertionError(f"detections shape {tuple(dets.boxes.shape)}")
    for name, t in (("boxes", dets.boxes), ("scores", dets.scores)):
        if not torch.isfinite(t).all():
            raise AssertionError(f"non-finite detection {name}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from lvc_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    tag = f"[{card}]"
    print(f"torch {torch.__version__} cuda {torch.version.cuda} {torch.cuda.get_device_name(0)}; "
          f"TF32 off (cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}, "
          f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32})")

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(_build.SOURCES)) as ex:
        reports = list(ex.map(_build.build, _build.SOURCES))
    print(f"build: {len(_build.SOURCES)} sources in {time.perf_counter() - t0:.1f} s {tag}")
    for report in reports:
        for line in report.splitlines():
            if "Used" in line or "spill" in line:
                print(f"  {line.strip()} {tag}")

    kernels = kernel_phase(tag)
    reference_check(tag)
    main_path(tag, kernels)
    kernels["roi_align_paired_bwd"] = backward_kernel_phase(tag)
    train_reference_check(tag)
    train_main_path(tag, kernels)
    print(json.dumps({"kernels": list(kernels.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
