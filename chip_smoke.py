#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (lvc_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of the repository

Phases, each of which raises (non-zero exit) on failure:
1. build every kernel source with nvcc for sm_90a, all in parallel;
2. kernel phase: each RoIAlign kernel and its plain PyTorch version on the
   same seeded inputs at the serving path's shapes (p2-p5 of an 8x832x1344
   batch, C=256, bf16, 1000 boxes per image), and the paired kernel again at
   the training path's 512 boxes per image: error, times, bound, and the
   feature bytes a per-box design fetches beside the bound's;
3. reference check: a narrow R-50-FPN at float32 on a small input, on the
   card (kernels) and on the CPU (plain versions), for the band and paired
   pools; proposals and detections must agree;
4. main path: R-101-FPN at full width, 832x1344, bf16, POOLER_IMPL
   pallas_fast, B=8, seeded damped weights, 1 warm-up + 3 timed forwards,
   with every kernel count set to 0 just before and read just after; then
   one B=2 POOLER_IMPL=auto forward, which takes the paired kernel;
5. backward kernel phase: the RoIAlign backward kernel (K3) and its plain
   version at the training path's shapes (p2-p5 of 8x832x1344, C=256, bf16,
   512 boxes per image): error of the bf16 gradients against the sum of
   absolute contributions, two calls bit-equal, float32 on 64 boxes bit-equal
   to the plain version on the CPU, the whole backward's time against two
   bounds, and its peak memory;
6. training reference check: one train step of a narrow R-50-FPN at float32
   (POOLER_IMPL pallas_train, exhaustive sampling) on the card (K2 forward,
   K3 backward) and on the CPU (plain versions) from the same weights;
   losses and every parameter gradient must agree;
7. training main path: the R-50-FPN train step at full width, bf16 AMP,
   POOLER_IMPL pallas_train, B=8 at 832x1344 with 100 gt slots, seeded damped
   weights, 1 warm-up + 5 timed steps with every kernel count set to 0 just
   before and read just after; one profiled step with the device time of
   each stage (the profiler ranges of the step and the model's forward);
8. attention kernel phase: the flash-attention kernel and its plain version
   on the same seeded qkv at the verifier's shape (B, N, H, d) =
   (64, 785, 6, 64), float32 and bf16: error (also on a peaked qkv whose
   logits span tens), card ms (beside the time before this kernel's
   redesign), plain ms, the bound, and scaled_dot_product_attention's ms on
   the same tensors as a yardstick;
9. verify reference check: a narrow ViT (N = 197) at float32 on the card and
   on the CPU from the same weights, and knn_vote on the card and the CPU;
10. verify main path: DINO ViT-S/8 at full width, seeded random weights,
   B=64 crops of 224 through DescriptorExtractor.embed_crops, float32 and
   bf16, 1 warm-up + 5 timed calls with the kernel's count set to 0 just
   before and read just after, one profiled call with the device time of the
   ViT's profiler ranges; knn_vote at S=2,400, Q=50,000, D=384, k=10;
11. the verification CLI (run_nearest_neighbours) on the card on a seeded
   mini COCO tree written to a temporary directory;
12. fused kernel phase: the fused residual GEMM kernel and its plain version
   at the seven shapes of the fused calls of the serving path (every
   bottleneck conv3 and the FPN laterals, 8x832x1344), ReLU on and off and a
   ragged M: error in bf16 ulps, card ms (beside the time before this
   kernel's redesign), plain ms, the bound, the wrapper's host µs per call,
   and the unfused Conv2d tail's and torch.matmul's ms beside them;
13. fused reference check: a narrow R-50-FPN at bf16 with
   LVC_TPU_FUSED_RESIDUAL=1 on the card and on the CPU from the same
   weights: FPN outputs, proposals and the kernel's launches (19);
14. fused serving path: phase 4's R-101-FPN with LVC_TPU_FUSED_RESIDUAL=1,
   timed in turns with the unfused form on the same model (unfused, fused,
   fused, unfused; 3 forwards each, 36 fused launches per forward), one
   profiled fused forward, then lvc_tpu_torch.tools.check_fused_serving at
   B=8;
15. fused training path: phase 7's step with LVC_TPU_FUSED_RESIDUAL=1, in
   turns with the unfused step on the same model (5 steps each; 32 fused
   launches per step: 19 forward, 13 recomputed under REMAT), one profiled
   fused step.
Phases 1-11 run with the fused path off, whatever the environment says.
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
HAND_KERNELS = ("roi_align_rows_kernel", "box_ranges_kernel", "roi_align_paired_bwd_kernel",
                "flash_attention_fwd_kernel", "matmul_affine_residual_kernel")
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


def host_us(fn, iters: int = 100) -> float:
    """The host's microseconds per call of ``fn`` (its enqueue, not the
    card's time): the mean over ``iters`` calls after a synchronised warm-up,
    with no synchronisation in between."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    us = (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize()
    return us


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


def box_pixels(level_shapes, taps):
    """The feature pixels a design that reads each box's window once must
    fetch: the sum over boxes of distinct valid rows x distinct valid columns
    (``bound`` counts the union over all boxes instead)."""
    import torch

    widths = torch.tensor([w for _, _, w, _ in level_shapes], device=taps.xs.device)[taps.lvl.long()]
    n = taps.lvl.numel()
    r = torch.where((taps.wy != 0) & (taps.rows >= 0), taps.rows, -1).reshape(n, -1)
    c = taps.xs[:, None, None] + taps.tcol
    c = torch.where((taps.wx != 0) & (c >= 0) & (c < widths[:, None, None]), c, -1).reshape(n, -1)

    def distinct(v):
        v = v.sort(dim=1).values
        return ((v[:, 1:] != v[:, :-1]) & (v[:, 1:] >= 0)).sum(1) + (v[:, 0] >= 0)

    return int((distinct(r) * distinct(c)).sum())


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


def backward_bound(level_shapes, taps, gout, dense=True):
    """Least time for K3's function (d pooled -> d features): gout and the
    taps read once and the gradient written once, over the memory rate,
    against this data's operations over the float32 rate (per channel: the
    1/count scale of each output cell, and a multiply and an add for each
    nonzero row-column tap pair). ``dense``: the whole gradient in gout's
    dtype, untouched pixels included, which is what the wrapper returns;
    otherwise only the elements the taps touch, in float32 (the count before
    the gather form, kept to compare with)."""
    C = gout.shape[-1]
    rows_ok, cols_ok, pixels = touched(level_shapes, taps)
    meta_bytes = sum(t.numel() * t.element_size() for t in taps)
    if dense:
        out_bytes = sum(math.prod(s) for s in level_shapes) * gout.element_size()
    else:
        out_bytes = pixels * C * 4
    nbytes = gout.numel() * gout.element_size() + meta_bytes + out_bytes
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
    train_boxes = boxes[:, :TRAIN_BOXES].contiguous()
    cases = {
        "roi_align_band": (ra.roi_align_band, ra.band_taps(
            ra.tiled_prep_band(shapes, B, boxes, STRIDES, dtype=torch.bfloat16), shapes, B, 32, True)),
        "roi_align_paired": (ra.roi_align_paired, ra.paired_taps(
            ra.tiled_prep_2d(shapes, B, boxes, STRIDES, dtype=torch.bfloat16), shapes, 48)),
        # the training pool's forward: the same kernel at 512 boxes per image
        "roi_align_paired@train": (ra.roi_align_paired, ra.paired_taps(
            ra.tiled_prep_2d(shapes, B, train_boxes, STRIDES, dtype=torch.bfloat16), shapes, 48)),
    }
    results = {}
    for case, (kernel, taps) in cases.items():
        name = case.split("@")[0]
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
        if not torch.equal(kernel(feats, taps), got):
            raise AssertionError(f"{case}: two calls differ")
        ms = cuda_ms(lambda: kernel(feats, taps), 50)
        plain_ms = cuda_ms(lambda: ra.roi_align_taps_plain(feats, taps, kernel.paired), 3)
        bound_ms, bound_by, nbytes, ops = bound(feats, taps)
        # feature bytes: the union of the boxes' pixels (in the bound) against
        # the sum of each box's window, what a per-box design fetches from L2
        C, isz = feats[0].shape[-1], feats[0].element_size()
        level_shapes = [tuple(f.shape) for f in feats]
        union = touched(level_shapes, taps)[2] * C * isz
        fetch = box_pixels(level_shapes, taps) * C * isz
        fetch_ms = (nbytes - union + fetch) / HBM_BYTES_PER_S * 1e3
        if "@" not in case:
            results[name] = dict(
                name=name, route="cuda", source=KERNEL_SOURCE[name], replaces=KERNEL_REPLACES[name],
                launches=0, max_abs_err=float(err.max()), ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
            )
        print(f"kernel {case}: boxes {taps.lvl.numel()} max_abs_err {float(err.max())} "
              f"(tolerance 1 bf16 ulp; two calls bit-equal) ms {ms:.4f} plain_ms {plain_ms:.3f} "
              f"bound_ms {bound_ms:.4f} ({bound_by}; {nbytes} bytes, {ops} ops) share "
              f"{bound_ms / ms:.3f}; feature bytes: union {union}, sum of per-box windows {fetch} "
              f"({fetch_ms:.4f} ms with them at the memory rate, share {fetch_ms / ms:.3f}) {tag}")
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
    return ms


def profile_call(fn, untraced_ms, what, tag, stages=()):
    """One call of ``fn`` (a forward or a train step) under torch.profiler:
    the device's busy time (union of kernel intervals), its idle share of the
    traced device span and of the untraced call's time (the profiler slows
    the host, so the traced share overstates idling), the device time of the
    profiler ranges named in ``stages``, the device time of the hand-written
    kernels, and the ops that take the most device time. Prints "not
    measured" if the profiler records no device activity."""
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
    # the hand-written kernels, launched through ctypes, are linked to no torch
    # op, so neither the stage ranges nor the op table below count them
    hand = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
            name = next((k for k in HAND_KERNELS if k in e.name), None)
            if name:
                t, n = hand.get(name, (0.0, 0))
                hand[name] = (t + e.time_range.end - e.time_range.start, n + 1)
    print("hand-written kernels, device ms: " + (", ".join(
        f"{k} {t / 1e3:.3f} (x{n})" for k, (t, n) in sorted(hand.items())) or "none") + f" {tag}")
    # device time attributed to the host-side ops that launched it
    rows = [
        (a.self_device_time_total, a.count, a.key)
        for a in prof.key_averages()
        if a.device_type == DeviceType.CPU and a.self_device_time_total > 0
    ]
    for t, count, key in sorted(rows, reverse=True)[:12]:
        print(f"  {t / 1e3:8.3f} ms device  x{count:<5d} {key[:80]} {tag}")


def backward_kernel_phase(tag):
    """K3 and its plain version at the training path's shapes. K3 returns
    the gradients in gout's dtype (bf16 here); each element must be within 1
    bf16 ulp of the plain version's float32 sum cast to bf16, plus 1e-5 * S,
    S the plain backward on |gout| and |weights| (the plain version on the
    card adds with index_add_'s atomics, in no fixed order; where a sum
    cancels to near 0 its ulp is below that float32 error; the count of such
    elements is printed). Two calls must give the same bits, and at float32
    on the first 64 boxes K3 must equal the plain version run on the CPU bit
    for bit (it sums in that order). Times the whole backward (gout to
    feature-dtype gradients) and prints its share of two bounds and its peak
    memory."""
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
    if any(a.dtype != gout.dtype or tuple(a.shape) != s for a, s in zip(got, level_shapes)):
        raise AssertionError("roi_align_paired_bwd: wrong dtype or shape")
    again = k3(level_shapes, taps, gout)
    if not all(torch.equal(a.view(torch.int16), b.view(torch.int16)) for a, b in zip(got, again)):
        raise AssertionError("roi_align_paired_bwd: two calls differ")
    del again
    want = ra.roi_align_taps_plain_backward(level_shapes, taps, gout)
    S = ra.roi_align_taps_plain_backward(
        level_shapes, taps._replace(wy=taps.wy.abs(), wx=taps.wx.abs()), gout.abs()
    )
    max_err, max_ratio, over_ulp = 0.0, 0.0, 0
    for l, (a, w, s) in enumerate(zip(got, want, S)):
        ref = w.to(torch.bfloat16).float()
        err = (a.float() - ref).abs()
        if not torch.isfinite(a).all() or not bool((err <= bf16_ulp(ref) + 1e-5 * s).all()):
            raise AssertionError(f"roi_align_paired_bwd level {l}: over 1 bf16 ulp + 1e-5 * S")
        over_ulp += int((err > bf16_ulp(ref)).sum())
        max_err = max(max_err, float(err.max()))
        max_ratio = max(max_ratio, float((err / s.clamp(min=1e-30)).max()))
    del want, S

    # float32, the first 64 boxes: bit-equal to the plain version on the CPU
    sub = ra.RoiTaps(*[t[:64].contiguous() for t in taps])
    g32 = torch.randn(64, P, P, C, generator=g, device="cuda")
    card = k3(level_shapes, sub, g32)
    cpu = ra.roi_align_taps_plain_backward(level_shapes, ra.RoiTaps(*[t.cpu() for t in sub]), g32.cpu())
    if not all(torch.equal(a.cpu().view(torch.int32), b.view(torch.int32)) for a, b in zip(card, cpu)):
        raise AssertionError("roi_align_paired_bwd: float32 result differs from the CPU plain version")
    del card, cpu

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    k3(level_shapes, taps, gout)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    ms = cuda_ms(lambda: k3(level_shapes, taps, gout), 50)
    plain_ms = cuda_ms(lambda: ra.roi_align_taps_plain_backward(level_shapes, taps, gout), 3)
    bound_ms, bound_by, nbytes, ops = backward_bound(level_shapes, taps, gout)
    touched_ms, _, touched_bytes, _ = backward_bound(level_shapes, taps, gout, dense=False)
    fetch = box_pixels(level_shapes, taps) * C * gout.element_size()
    print(f"kernel roi_align_paired_bwd: boxes {n} max_abs_err {max_err} (bf16 output) max err/S "
          f"{max_ratio:.3e} (tolerance 1 bf16 ulp of the plain version's cast + 1e-5 * S, {over_ulp} "
          f"elements over 1 ulp alone; two calls bit-equal; float32 on 64 boxes bit-equal to the CPU "
          f"plain version) whole backward ms {ms:.4f} plain_ms {plain_ms:.3f} "
          f"bound_ms {bound_ms:.4f} (dense {gout.dtype} gradient written once; {bound_by}; {nbytes} "
          f"bytes, {ops} ops) share {bound_ms / ms:.3f}; touched-f32 bound_ms {touched_ms:.4f} "
          f"({touched_bytes} bytes) share {touched_ms / ms:.3f}; peak memory of one call "
          f"{peak / 2 ** 20:.1f} MiB over the {base / 2 ** 20:.1f} MiB live before it; "
          f"the train forward's per-box window fetch {fetch} bytes {tag}")
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
    return ms, peak


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


# ---------------------------------------------------------------------------
# The label-verification path (DINO ViT + kNN vote)
# ---------------------------------------------------------------------------

ATTN_SHAPE = (64, 785, 6, 64)  # (B, N, H, d): 64 crops of 224 through ViT-S/8
BF16_OPS_PER_S = 989e12  # H100 SXM dense bf16 tensor cores
TF32_OPS_PER_S = 495e12  # H100 SXM dense TF32 tensor cores: float32's tensor-core path
VIT_STAGES = ("patch_embed", "attention", "mlp")  # the profiler ranges in the ViT
MINI_SPLITS = (  # (dataset name, annotation file under the root; "" for the K-shot files)
    ("coco_trainval_all", "cocosplit/datasplit/trainvalno5k.json"),
    ("coco_trainval_all_2shot", ""),
)


def attention_bound(B, N, H, d, isz, ops_per_s):
    """Least time for the attention function: 4*B*H*N^2*d operations (QK^T
    and PV) at the dtype's dense tensor-core rate, against q, k, v read once
    and the output written once at the memory rate."""
    ops = 4 * B * H * N * N * d
    nbytes = 4 * B * N * H * d * isz
    t_ops, t_bytes = ops / ops_per_s * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), nbytes, ops


def peaked(qkv):
    """A peaked copy of qkv (B, N, 3, H, d) with N(0, 0.25) entries, numpy or
    torch: q and k scaled by 4, so at d = 64 and scale 1/8 the logits have a
    std of about 4, a row spans about 26 and its largest weight is about
    0.4; and the keys at N//2 + 3, N - 40 and N - 1 scaled by 2 more (logits
    of std about 8 there), so in about a sixth of the rows the running max
    jumps by tens late in the row and the online softmax's rescale
    exp(m_old - m_new) falls far below 1, as in trained attention. v is left
    as it is, so |out| stays under 2. (At N < 40 only the keys that exist.)"""
    N = qkv.shape[1]
    out = qkv * 1
    out[:, :, :2] *= 4
    out[:, sorted({j for j in (N // 2 + 3, N - 40, N - 1) if 0 <= j < N}), 1] *= 2
    return out


def attention_error(got, want, shape):
    """(max abs err, its share of the tolerance, text): float32 1e-5 max abs;
    bf16 2 bf16 ulps of the largest |out| of each (batch, head)."""
    import torch

    B, N, H, d = shape
    err = (got.float() - want.float()).abs()
    if got.dtype == torch.float32:
        return float(err.max()), float(err.max()) / 1e-5, "tolerance 1e-5"
    mx = want.float().abs().view(B, N, H, d).amax(dim=(1, 3))
    ratio = float((err.view(B, N, H, d).amax(dim=(1, 3)) / bf16_ulp(mx)).max())
    return float(err.max()), ratio / 2, f"{ratio:.2f} bf16 ulps of the largest |out| of a (b, h); tolerance 2"


def attention_kernel_phase(tag):
    """The attention kernel and its plain version on the same seeded qkv at
    the main path's shape, float32 and bf16: error, card ms, the plain
    version's ms, the bound and scaled_dot_product_attention's ms on the same
    (B, H, N, d) tensors (a yardstick only; the port never calls it). The
    error is also held on a peaked qkv (``peaked``), whose logits span tens.
    Tolerances: float32 1e-5 max abs; bf16 2 bf16 ulps of the largest |out|
    of each (batch, head). Returns the float32 row (the CLI's dtype)."""
    import torch
    import torch.nn.functional as F

    from lvc_tpu_torch.ops.attention import flash_attention, flash_attention_plain

    B, N, H, d = ATTN_SHAPE
    scale = d ** -0.5
    rows = {}
    for dtype, rate in ((torch.float32, TF32_OPS_PER_S), (torch.bfloat16, BF16_OPS_PER_S)):
        name = str(dtype).replace("torch.", "")
        g = torch.Generator(device="cuda").manual_seed(0)
        mild = (torch.randn(B, N, 3 * H * d, generator=g, device="cuda") * 0.5).view(B, N, 3, H, d)
        errs = {}
        for case, qkv in (("peaked", peaked(mild).to(dtype)), ("mild", mild.to(dtype))):
            got = flash_attention(qkv, scale)
            torch.cuda.synchronize()
            want = flash_attention_plain(qkv, scale)
            if tuple(got.shape) != (B, N, H * d) or not torch.isfinite(got).all():
                raise AssertionError(f"flash_attention_fwd {name} {case}: shape {tuple(got.shape)} or non-finite")
            errs[case] = attention_error(got, want, ATTN_SHAPE)
            if errs[case][1] > 1:
                raise AssertionError(f"flash_attention_fwd {name} {case}: max abs err {errs[case][0]} "
                                     f"({errs[case][2]})")
            if case == "peaked" and dtype == torch.float32:
                # both against float64 softmax attention: how much of their
                # difference is float32 rounding of logits that reach tens
                q, k, v = (t.transpose(1, 2).double() for t in qkv.unbind(2))
                exact = (torch.softmax(q @ k.transpose(-1, -2) * scale, dim=-1) @ v).transpose(1, 2)
                exact = exact.reshape(B, N, H * d)
                vs64 = [float((t.double() - exact).abs().max()) for t in (got, want)]
                del q, k, v, exact
            del got, want
        del mild
        max_abs_err, _, tol_text = errs["mild"]
        peak_text = f"peaked qkv max_abs_err {errs['peaked'][0]} ({errs['peaked'][2]})"
        if dtype == torch.float32:
            peak_text += f", against float64: kernel {vs64[0]:.3e}, plain {vs64[1]:.3e}"
        ms = cuda_ms(lambda: flash_attention(qkv, scale), 20)
        plain_ms = cuda_ms(lambda: flash_attention_plain(qkv, scale), 3)
        q, k, v = (t.transpose(1, 2).contiguous() for t in qkv.unbind(2))
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=scale), 20)
        bound_ms, bound_by, nbytes, ops = attention_bound(B, N, H, d, qkv.element_size(), rate)
        print(f"kernel flash_attention_fwd {name}: (B, N, H, d) {ATTN_SHAPE} max_abs_err {max_abs_err} "
              f"({tol_text}); {peak_text}; "
              f"ms {ms:.4f} plain_ms {plain_ms:.3f} sdpa_ms "
              f"{library_ms:.4f} bound_ms {bound_ms:.4f} ({bound_by}; {nbytes} bytes at 3.35 TB/s, {ops} "
              f"flops at {rate / 1e12:.0f} TFLOP/s) share of bound {bound_ms / ms:.3f}, kernel/sdpa "
              f"{ms / library_ms:.2f} {tag}")
        rows[name] = dict(
            name="flash_attention_fwd", route="cuda", source="lvc_tpu_torch/ops/csrc/flash_attention_fwd.cu",
            replaces="lvc_tpu/modeling/backbone/vit.py:80", launches=0, max_abs_err=max_abs_err,
            ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
            dtype=name,
        )
        del qkv, q, k, v
    torch.cuda.empty_cache()
    bf16 = {key: rows["bfloat16"][key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms", "library_ms")}
    return dict(rows["float32"], bfloat16=bf16)


def clustered(seed, n_shot, n_query, classes, dim, device):
    """Seeded shot and query descriptors around class centres (float32)."""
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    centers = rng.randn(classes, dim) * 2
    s_cls = rng.randint(0, classes, n_shot)
    q_cls = rng.randint(0, classes, n_query)
    shots = centers[s_cls] + rng.randn(n_shot, dim)
    queries = centers[q_cls] + rng.randn(n_query, dim) * 1.5
    return tuple(torch.from_numpy(np.asarray(a, t)).to(device)
                 for a, t in ((shots, np.float32), (s_cls, np.int64), (queries, np.float32)))


def verify_reference_check(tag):
    """A narrow ViT at float32 (depth 2, dim 128, 2 heads, patch 16, 224
    crops: N = 197, not a multiple of any tile) on the card (kernel) and on
    the CPU (plain version) from the same weights: CLS descriptors within
    1e-5 of the largest |descriptor|. Then knn_vote on the card and on the
    CPU on seeded clustered descriptors: similarities within 1e-5, and equal
    top-k labels and modes where the k-th and (k+1)-th similarities are more
    than 1e-4 apart (all but near-ties, which are counted)."""
    import numpy as np
    import torch

    from lvc_tpu_torch.modeling.backbone.vit import VisionTransformer, random_init
    from lvc_tpu_torch.ops.attention import flash_attention
    from lvc_tpu_torch.ops.knn import knn_vote, similarity

    cpu = random_init(VisionTransformer(16, 128, 2, 2), seed=1).eval()
    gpu = VisionTransformer(16, 128, 2, 2).cuda().eval()
    gpu.load_state_dict(cpu.state_dict())
    x = torch.from_numpy(np.random.RandomState(2).randn(4, 224, 224, 3).astype(np.float32))
    before = flash_attention.launches
    with torch.no_grad():
        want = cpu(x)
        got = gpu(x.cuda()).cpu()
    launched = flash_attention.launches - before
    rel = float((got - want).abs().max() / want.abs().max())
    if launched != 2 or rel > 1e-5:
        raise AssertionError(f"narrow ViT card vs CPU: rel err {rel}, kernel launches {launched}")

    k = 10
    cs, cl, cq = clustered(3, 600, 2000, 12, 128, "cpu")
    sim_c = similarity(cs, cq)
    sim_g = similarity(cs.cuda(), cq.cuda()).cpu()
    sim_err = float((sim_c - sim_g).abs().max())
    top = sim_c.sort(dim=-1, descending=True).values
    clear = (top[:, k - 1] - top[:, k]) > 1e-4
    tk_c, mode_c = knn_vote(cs, cl, cq, k=k)
    tk_g, mode_g = knn_vote(cs.cuda(), cl.cuda(), cq.cuda(), k=k)
    tk_g, mode_g = tk_g.cpu(), mode_g.cpu()
    if sim_err > 1e-5 or not torch.equal(tk_c[clear], tk_g[clear]) or not torch.equal(mode_c[clear], mode_g[clear]):
        raise AssertionError(f"knn_vote card vs CPU: sim err {sim_err}, labels or modes differ")
    print(f"verify reference: narrow ViT (patch 16, dim 128, depth 2, N=197) card vs CPU at float32 "
          f"rel err {rel:.2e} (tol 1e-5), {launched} kernel launches; knn_vote S=600 Q=2000 D=128 k={k}: "
          f"sim err {sim_err:.2e} (tol 1e-5), top-k labels and modes equal on {int(clear.sum())} queries "
          f"({int((~clear).sum())} near-ties skipped; modes equal on all: {torch.equal(mode_c, mode_g)}) {tag}")


def verify_main_path(tag, kernels):
    """DINO ViT-S/8 at full width, seeded random weights, B=64 uint8 crops of
    224 through DescriptorExtractor.embed_crops, float32 (the CLI's dtype)
    and bf16: 1 warm-up and 5 timed calls each, with the kernel's count set to
    0 just before and read just after (12 launches per forward), one profiled
    call with the device time of the ViT's profiler ranges. Then knn_vote at
    a COCO size: S = 2,400 shots (30 x 80 classes), Q = 50,000 candidates,
    D = 384, k = 10, cosine."""
    import numpy as np
    import torch

    from lvc_tpu_torch.ops.attention import flash_attention
    from lvc_tpu_torch.ops.knn import knn_vote
    from lvc_tpu_torch.pipeline.verification import DescriptorExtractor, build_dino

    B, iters = 64, 5
    crops = (np.random.RandomState(0).rand(B, 224, 224, 3) * 255).astype(np.uint8)
    mean, std = [103.530, 116.280, 123.675], [57.375, 57.120, 58.395]
    desc = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        model = build_dino("dino_vits8", compute_dtype=dtype)
        ext = DescriptorExtractor(model, mean, std, batch=B)
        ext.embed_crops(crops)  # warm-up
        flash_attention.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(iters):
            out = ext.embed_crops(crops)  # returns numpy: synchronised
        ms = (time.perf_counter() - t0) * 1e3 / iters
        launches = flash_attention.launches
        peak = torch.cuda.max_memory_allocated()
        if launches != 12 * iters:
            raise AssertionError(f"verify main path {name}: {launches} kernel launches, want {12 * iters}")
        if out.shape != (B, 384) or not np.isfinite(out).all():
            raise AssertionError(f"verify main path {name}: descriptors {out.shape} or non-finite")
        if dtype == torch.float32:
            kernels["flash_attention_fwd"]["launches"] = launches
        desc[name] = out
        print(f"verify main path DINO ViT-S/8 224 {name} B={B}: {ms:.2f} ms/batch {B * 1e3 / ms:.1f} crops/s, "
              f"launches {launches} ({iters} forwards), peak memory {peak / 2 ** 30:.2f} GiB {tag}")
        profile_call(lambda: ext.embed_crops(crops), ms, f"{name} forward", tag, VIT_STAGES)
        del model, ext
        torch.cuda.empty_cache()
    # the host's share of embed_crops: its float32 normalisation in numpy
    mean32, std32 = np.asarray(mean, np.float32), np.asarray(std, np.float32)
    t0 = time.perf_counter()
    for _ in range(3):
        (crops.astype(np.float32) - mean32) / std32
    norm_ms = (time.perf_counter() - t0) * 1e3 / 3
    print(f"verify main path: host normalisation of {B} crops in numpy {norm_ms:.2f} ms (host clock) {tag}")
    a, b = desc["float32"], desc["bfloat16"]
    cos = (a * b).sum(-1) / np.linalg.norm(a, axis=-1) / np.linalg.norm(b, axis=-1)
    print(f"verify main path: bf16 vs float32 descriptor cosine min {cos.min():.6f} mean {cos.mean():.6f} {tag}")

    shots, classes, queries = clustered(4, 2400, 50000, 80, 384, "cuda")
    topk, mode = knn_vote(shots, classes, queries, k=10)
    torch.cuda.synchronize()
    if tuple(topk.shape) != (50000, 10) or int(mode.min()) < 0 or int(mode.max()) >= 80:
        raise AssertionError(f"knn_vote: top-k {tuple(topk.shape)}, modes in [{int(mode.min())}, {int(mode.max())}]")
    knn_ms = cuda_ms(lambda: knn_vote(shots, classes, queries, k=10), 10)
    print(f"knn_vote S=2400 Q=50000 D=384 k=10 cosine: {knn_ms:.3f} ms ({50000 / knn_ms * 1e3:.0f} queries/s) {tag}")


def cli_phase(tag):
    """The port's verification CLI on the card, on a seeded mini COCO tree
    (DINO ViT-S/16 with seeded random weights, k=3): the output JSON must
    exist, and the kernel must have been launched."""
    import json
    import os
    import tempfile

    from lvc_tpu_torch.data import builtin  # noqa: F401
    from lvc_tpu_torch.data.builtin_meta import _get_builtin_metadata
    from lvc_tpu_torch.data.catalog import DatasetCatalog
    from lvc_tpu_torch.data.meta_coco import register_meta_coco
    from lvc_tpu_torch.engine.defaults import default_argument_parser
    from lvc_tpu_torch.ops.attention import flash_attention
    from lvc_tpu_torch.tools import run_nearest_neighbours

    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "datasets")
        candidates = write_mini_coco(root, seed=0)
        os.environ["DETECTRON2_DATASETS"] = root
        os.environ.pop("DINO_WEIGHTS", None)
        register_mini_coco(root, DatasetCatalog, register_meta_coco, _get_builtin_metadata("coco_fewshot"))
        before = flash_attention.launches
        t0 = time.perf_counter()
        run_nearest_neighbours.main(default_argument_parser().parse_args(
            cli_args(root, candidates, os.path.join(tmp, "out"))))
        secs = time.perf_counter() - t0
        out = candidates.replace(".json", "_dino_vits16_03_cosine.json")
        with open(out) as f:
            kept = json.load(f)["annotations"]
        with open(candidates) as f:
            n = len(json.load(f)["annotations"])
    launched = flash_attention.launches - before
    if launched < 12:
        raise AssertionError(f"the CLI launched the attention kernel {launched} times")
    print(f"cli: run_nearest_neighbours on the mini COCO tree (6 images, {n} candidates), DINO ViT-S/16 "
          f"random weights: kept {len(kept)} of {n}, {launched} kernel launches, {secs:.2f} s {tag}")


def write_mini_coco(root: str, seed: int = 0) -> str:
    """A seeded mini COCO tree in the layout the COCO registration reads:
    six PNG images under ``coco/trainval2014``, their instances
    (``cocosplit/datasplit/trainvalno5k.json``), 2-shot files for all 80
    classes (``cocosplit/full_box_2shot_<class>_trainval.json``; person and
    dog have 3 candidates each, so the 2-shot subsample draws) and
    ``candidates.json``, detector candidates on the other images with ids and
    scores, one of them on a truck (a seen class). Returns the candidates'
    path."""
    import json
    import os

    import numpy as np
    from PIL import Image

    from lvc_tpu_torch.data.builtin_meta import COCO_CATEGORIES

    rng = np.random.RandomState(seed)
    img_dir = os.path.join(root, "coco", "trainval2014")
    split_dir = os.path.join(root, "cocosplit", "datasplit")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(split_dir, exist_ok=True)
    H, W = 160, 200
    images = []
    for i in range(1, 7):
        low = rng.randint(0, 256, (H // 8, W // 8, 3)).astype(np.uint8)
        img = np.kron(low, np.ones((8, 8, 1), np.uint8))
        Image.fromarray(img).save(os.path.join(img_dir, f"img_{i}.png"))
        images.append({"id": i, "file_name": f"img_{i}.png", "height": H, "width": W})

    def box():
        w, h = rng.randint(24, 90, 2)
        x, y = rng.randint(0, W - w), rng.randint(0, H - h)
        return [float(x), float(y), float(w), float(h)]

    PERSON, DOG, TRUCK = 1, 18, 8
    gt = []
    for img in images:
        for cat in (PERSON, DOG, TRUCK):
            gt.append({"id": len(gt) + 1, "image_id": img["id"], "category_id": cat, "bbox": box(),
                       "iscrowd": 0})
    for a in gt:
        a["area"] = a["bbox"][2] * a["bbox"][3]
    cats = [{"id": c["id"], "name": c["name"]} for c in COCO_CATEGORIES]

    def dump(path, imgs, anns):
        with open(path, "w") as f:
            json.dump({"images": imgs, "annotations": anns, "categories": cats}, f)

    dump(os.path.join(split_dir, "trainvalno5k.json"), images, gt)
    shot_imgs = {PERSON: (1, 2, 3), DOG: (1, 2, 4)}
    for c in COCO_CATEGORIES:
        ids = shot_imgs.get(c["id"], ())
        anns = [a for a in gt if a["category_id"] == c["id"] and a["image_id"] in ids]
        dump(os.path.join(root, "cocosplit", f"full_box_2shot_{c['name']}_trainval.json"),
             [im for im in images if im["id"] in ids], anns)
    cands = []
    for img in images[3:]:
        for k in range(4):
            cands.append({"id": 1000 + len(cands), "image_id": img["id"], "category_id": (PERSON, DOG)[k % 2],
                          "bbox": box(), "score": float(rng.uniform(0.3, 1.0)), "iscrowd": 0})
        truck = next(a for a in gt if a["image_id"] == img["id"] and a["category_id"] == TRUCK)
        cands.append({"id": 1000 + len(cands), "image_id": img["id"], "category_id": PERSON,
                      "bbox": list(truck["bbox"]), "score": 0.9, "iscrowd": 0})
    for a in cands:
        a["area"] = a["bbox"][2] * a["bbox"][3]
    path = os.path.join(root, "candidates.json")
    dump(path, images[3:], cands)
    return path


def register_mini_coco(root: str, catalog, register_meta_coco, metadata) -> None:
    """(Re)register the splits of ``MINI_SPLITS`` on the mini tree at
    ``root``, as ``register_all_coco(root)`` registers them."""
    import os

    for name, annofile in MINI_SPLITS:
        if name in catalog:
            catalog.remove(name)
        register_meta_coco(name, metadata, os.path.join(root, "coco", "trainval2014"),
                           os.path.join(root, annofile))


def cli_args(root: str, candidates: str, out_dir: str):
    """The verification CLI's arguments on the mini tree: ViT-S/16, k=3,
    cosine, seed 0 (the K-shot subsample draws from numpy's seeded state)."""
    return [
        "--eval-only",
        "QUERY_EXPAND.NN_MODEL", "dino_vits16",
        "QUERY_EXPAND.KNN", "3",
        "QUERY_EXPAND.COSINE_SIM", "True",
        "QUERY_EXPAND.NN_DSET", "('coco_trainval_all_2shot',)",
        "DATASETS.DT_PATH", f"('{candidates}',)",
        "DATASETS.TRAIN", "('coco_trainval_all',)",
        "SEED", "0",
        "OUTPUT_DIR", out_dir,
    ]


# ---------------------------------------------------------------------------
# The opt-in fused residual GEMM (LVC_TPU_FUSED_RESIDUAL=1)
# ---------------------------------------------------------------------------

# (name, B, H, W, K, N, ReLU, calls per R-101-FPN forward): the fused calls of
# the serving path at 8x832x1344 (every bottleneck conv3 and the FPN laterals
# of the sum top-down path); R-50 has 6 res4 blocks, not 23
FUSED_SHAPES = (
    ("res2 conv3", 8, 208, 336, 64, 256, True, 3),
    ("res3 conv3", 8, 104, 168, 128, 512, True, 4),
    ("res4 conv3", 8, 52, 84, 256, 1024, True, 23),
    ("res5 conv3", 8, 26, 42, 512, 2048, True, 3),
    ("lateral p4", 8, 52, 84, 1024, 256, False, 1),
    ("lateral p3", 8, 104, 168, 512, 256, False, 1),
    ("lateral p2", 8, 208, 336, 256, 256, False, 1),
)
FUSED_SOURCE = "lvc_tpu_torch/ops/csrc/fused_matmul.cu"
FUSED_REPLACES = "lvc_tpu/ops/fused_matmul.py:76"


def fused_calls(model):
    """(per forward, recomputed per train step): the Conv2d calls the fused
    gate takes in ``model``'s backbone, one per bottleneck conv3 and one per
    FPN lateral that has a level above it (fuse_type sum); and, under REMAT
    in training, the conv3 of every block that the backward recomputes, which
    is every block with a trainable parameter (the frozen stages take no
    gradient; FREEZE_AT 2 freezes the stem and res2)."""
    fpn = model.backbone
    blocks = [b for name in fpn.bottom_up.stage_names for b in getattr(fpn.bottom_up, name)]
    forward = len(blocks) + (len(fpn.in_features) - 1 if fpn.fuse_type == "sum" else 0)
    recomputed = sum(any(p.requires_grad for p in b.parameters()) for b in blocks) if fpn.bottom_up.remat else 0
    return forward, recomputed


def fused_error(got, want, x2d, w_kn, scale, shift, res2d):
    """Per element, the kernel against its plain version: 1 bf16 ulp of the
    plain result plus 1e-5 * S, S = |x| @ |w| * |scale| + |shift| + |res|
    (the float32 summation orders differ; where the sum cancels towards 0
    the difference is many of the small result's own ulps). Returns (ok, max
    abs err, elements at 1 ulp, elements over 1 ulp alone, max err / S of
    those)."""
    import torch

    g, w = got.float(), want.float()
    S = (x2d.float().abs() @ w_kn.float().abs()) * scale.abs() + shift.abs() + res2d.float().abs()
    err = (g - w).abs()
    ulp = bf16_ulp(w)
    ok = bool((err <= ulp + 1e-5 * S).all())
    over = err > ulp
    n_over = int(over.sum())
    ratio = float((err[over] / S[over]).max()) if n_over else 0.0
    del S
    return ok, float(err.max()), int(((err > 0) & ~over).sum()), n_over, ratio


def fused_bound(M, K, N):
    """Least time for one call: x, w, residual read once and out written once
    (bf16) over the memory rate, against 2*M*K*N operations at the dense bf16
    tensor-core rate."""
    nbytes = 2 * (M * K + K * N + 2 * M * N)
    ops = 2 * M * K * N
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / BF16_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes, ops


def fused_kernel_phase(tag):
    """The fused GEMM kernel and its plain version on seeded bf16 inputs at
    each shape of FUSED_SHAPES (folded-BN-like scale in [0.5, 1.5], shift
    N(0, 1)), ReLU on and off, and a ragged M of 1,000 rows: error
    (``fused_error``), card ms, plain ms and the bound; beside them, as
    information only, the unfused tail of today's Conv2d on the same tensors
    (cuDNN 1x1 conv, FrozenBN, residual add, ReLU; or conv with bias and the
    add) and torch.matmul's bare product. No one PyTorch call computes the
    GEMM with this epilogue, so there is no library time. Returns the
    kernel's row, its times summed over the 36 calls of one R-101-FPN
    forward."""
    import torch
    import torch.nn.functional as F

    from lvc_tpu_torch.modeling.layers import Conv2d, fused_residual
    from lvc_tpu_torch.ops.fused_matmul import matmul_affine_residual as kernel
    from lvc_tpu_torch.ops.fused_matmul import matmul_affine_residual_plain as plain

    total = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, unfused_ms=0.0, matmul_ms=0.0)
    max_err, shapes, host = 0.0, [], []
    g = torch.Generator(device="cuda").manual_seed(0)
    for name, B, H, W, K, N, relu, calls in FUSED_SHAPES:
        x = torch.randn(B, H, W, K, generator=g, device="cuda").to(torch.bfloat16)
        w = (torch.randn(N, K, generator=g, device="cuda") * K ** -0.5).to(torch.bfloat16)
        scale = torch.rand(N, generator=g, device="cuda") + 0.5
        shift = torch.randn(N, generator=g, device="cuda")
        res = torch.randn(B, H, W, N, generator=g, device="cuda").to(torch.bfloat16)
        M = B * H * W
        x2d, res2d, w_kn = x.view(M, K), res.view(M, N), w.t()
        cases = [(M, relu), (M, not relu)] + ([(1000, relu)] if name == "res2 conv3" else [])
        for rows, r in cases:
            args = (x2d[:rows], w_kn, scale, shift, res2d[:rows])
            got = kernel(*args, relu=r)
            torch.cuda.synchronize()
            want = plain(*args, relu=r)
            if tuple(got.shape) != (rows, N) or got.dtype != torch.bfloat16 or not torch.isfinite(got).all():
                raise AssertionError(f"matmul_affine_residual {name}: shape, dtype or non-finite")
            ok, err, at_ulp, over, ratio = fused_error(got, want, *args)
            if not ok:
                raise AssertionError(f"matmul_affine_residual {name} M={rows} relu={r}: max abs err {err}, "
                                     f"over 1 bf16 ulp + 1e-5 * S")
            max_err = max(max_err, err)
            print(f"kernel matmul_affine_residual {name} (M, K, N) ({rows}, {K}, {N}) relu {r}: max_abs_err "
                  f"{err} ({at_ulp} elements at 1 bf16 ulp, {over} over it alone, max err/S {ratio:.2e}; "
                  f"tolerance 1 ulp + 1e-5 * S) {tag}")
            del got, want
        ms = cuda_ms(lambda: kernel(x2d, w_kn, scale, shift, res2d, relu=relu), 20)
        wrapper_us = host_us(lambda: kernel(x2d, w_kn, scale, shift, res2d, relu=relu))
        plain_ms = cuda_ms(lambda: plain(x2d, w_kn, scale, shift, res2d, relu=relu), 3)
        matmul_ms = cuda_ms(lambda: torch.matmul(x2d, w_kn), 20)
        conv = (Conv2d(K, N, kernel_size=1, bias=False, norm="FrozenBN", activation=F.relu) if relu
                else Conv2d(K, N, kernel_size=1, bias=True)).cuda().to(memory_format=torch.channels_last)
        with torch.no_grad():
            conv.weight.copy_(w.float().view(N, K, 1, 1))
            if relu:
                conv.norm.weight.copy_(scale)
                conv.norm.bias.copy_(shift)
            else:
                conv.bias.copy_(shift)
        x_nchw, res_nchw = x.permute(0, 3, 1, 2), res.permute(0, 3, 1, 2)
        with fused_residual(False), torch.no_grad():
            unfused_ms = cuda_ms(lambda: conv(x_nchw, residual=res_nchw), 20)
        bound_ms, bound_by, nbytes, ops = fused_bound(M, K, N)
        print(f"kernel matmul_affine_residual {name} (M, K, N) ({M}, {K}, {N}) x{calls} per R-101 forward: "
              f"ms {ms:.4f} plain_ms {plain_ms:.3f} bound_ms {bound_ms:.4f} ({bound_by}; {nbytes} bytes, "
              f"{ops} flops) share of bound {bound_ms / ms:.3f}; unfused Conv2d tail ms {unfused_ms:.4f}, "
              f"torch.matmul product alone ms {matmul_ms:.4f}; wrapper host us per call {wrapper_us:.1f} {tag}")
        for key, v in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", bound_ms),
                       ("unfused_ms", unfused_ms), ("matmul_ms", matmul_ms)):
            total[key] += calls * v
        host.append(wrapper_us)
        shapes.append(dict(shape=[M, K, N], calls=calls, ms=ms, bound_ms=bound_ms, plain_ms=plain_ms,
                           unfused_ms=unfused_ms, host_us=wrapper_us))
        del x, w, res, x2d, res2d, w_kn, conv, x_nchw, res_nchw
        torch.cuda.empty_cache()
    host_mean = sum(host) / len(host)
    print(f"kernel matmul_affine_residual, the 36 calls of one R-101-FPN forward: ms {total['ms']:.4f} "
          f"bound_ms {total['bound_ms']:.4f} share of bound "
          f"{total['bound_ms'] / total['ms']:.3f} plain_ms {total['plain_ms']:.3f} unfused Conv2d tails ms "
          f"{total['unfused_ms']:.4f} torch.matmul products ms {total['matmul_ms']:.4f}; wrapper host us per "
          f"call {host_mean:.1f} (mean of the seven shapes) {tag}")
    return dict(
        name="matmul_affine_residual", route="cuda", source=FUSED_SOURCE, replaces=FUSED_REPLACES,
        launches=0, max_abs_err=max_err, ms=total["ms"], plain_ms=total["plain_ms"],
        bound_ms=total["bound_ms"], bound_by="bytes", library_ms=None,
        host_us=host_mean, work="the 36 calls of one R-101-FPN forward at 8x832x1344 (times summed)",
        shapes=shapes,
    )


def fused_reference_check(tag):
    """A narrow R-50-FPN in bf16 with the fused path on, on the card (kernel)
    and on the CPU (plain version), from the same weights: FPN outputs within
    2e-2 of each level's max |p| (bf16 convolutions of cuDNN and of the CPU
    round differently through 16 blocks), the kernel launched once per fused
    call (19); proposals as sets, since bf16 near-ties reorder the top-k: the
    same number valid, and in each image at least 85% of the card's valid
    proposals with a CPU proposal at IoU >= 0.9 (95-96% between the fused
    and unfused bf16 forms on the CPU)."""
    import numpy as np
    import torch

    from lvc_tpu_torch.modeling.layers import fused_residual
    from lvc_tpu_torch.modeling.meta_arch.build import build_model
    from lvc_tpu_torch.ops.fused_matmul import matmul_affine_residual
    from lvc_tpu_torch.structures.boxes import pairwise_iou

    rng = np.random.RandomState(3)
    batch = {
        "image": (rng.rand(2, 128, 192, 3) * 255).astype(np.float32),
        "image_size": np.array([[128, 192], [112, 160]], np.int32),
    }
    cfg = narrow_cfg("pallas_fast")
    cfg.MODEL.DTYPE = "bfloat16"
    cfg.MODEL.RPN.PRE_NMS_TOPK_TEST = 200
    cfg.MODEL.RPN.POST_NMS_TOPK_TEST = 100
    cpu = build_model(cfg, device="cpu")
    calibrated_init(cpu, seed=0)
    gpu = build_model(cfg)
    gpu.load_state_dict(cpu.state_dict())
    with fused_residual(True):
        want = cpu.backbone_features(batch)
        before = matmul_affine_residual.launches
        got = gpu.backbone_features(batch)
        torch.cuda.synchronize()
        launched = matmul_affine_residual.launches - before
        c_props, _, c_valid = cpu.proposals(batch)
        g_props, _, g_valid = (t.cpu() for t in gpu.proposals(batch))
    expected = fused_calls(gpu)[0]
    if launched != expected:
        raise AssertionError(f"fused reference: {launched} kernel launches, want {expected}")
    rels = {k: float((got[k].cpu().float() - v.float()).abs().max() / v.float().abs().max()) for k, v in want.items()}
    if max(rels.values()) > 2e-2:
        raise AssertionError(f"fused reference: FPN outputs card vs CPU {rels}")
    matched = []
    for i in range(2):
        best = pairwise_iou(g_props[i][g_valid[i]], c_props[i][c_valid[i]]).max(1).values
        matched.append(float((best >= 0.9).float().mean()))
    if int(c_valid.sum()) != int(g_valid.sum()) or min(matched) < 0.85:
        raise AssertionError(f"fused reference: proposals valid {int(g_valid.sum())} vs {int(c_valid.sum())}, "
                             f"share matched at IoU 0.9 {matched}")
    print(f"fused reference: narrow R-50-FPN bf16 card vs CPU, FPN max err / max |p| "
          + ", ".join(f"{k} {v:.2e}" for k, v in sorted(rels.items()))
          + f" (tol 2e-2), {launched} kernel launches (want {expected}); {int(g_valid.sum())} proposals valid "
          f"on both, share with a CPU proposal at IoU >= 0.9: {matched} (tol 0.85) {tag}")


def fused_main_path(tag, kernels, unfused_ms):
    """R-101-FPN serving as in main_path, fused and unfused on the same model
    in turns (unfused, fused, fused, unfused; 3 timed forwards each after one
    warm-up of each form), so both see the same host and card: every kernel
    count set to 0 just before the first fused turn and read just after (36
    fused launches per forward); ms/batch of both forms beside the unfused
    main path's of this run; one profiled fused forward; then the
    check_fused_serving comparison at B=8."""
    import torch

    from lvc_tpu_torch.modeling.layers import fused_residual
    from lvc_tpu_torch.modeling.meta_arch.build import build_model
    from lvc_tpu_torch.ops import roi_align as ra
    from lvc_tpu_torch.ops.fused_matmul import matmul_affine_residual
    from lvc_tpu_torch.tools import check_fused_serving
    from lvc_tpu_torch.utils.init import damped_init

    wrappers = {"roi_align_band": ra.roi_align_band, "roi_align_paired": ra.roi_align_paired,
                "matmul_affine_residual": matmul_affine_residual}
    model = damped_init(build_model(serving_cfg("pallas_fast")), seed=0)
    per_forward = fused_calls(model)[0]
    g = torch.Generator(device="cuda").manual_seed(0)
    B, H, W = 8, 832, 1344
    batch = {
        "image": torch.rand(B, H, W, 3, generator=g, device="cuda") * 255,
        "image_size": torch.tensor([[H, W]] * B, dtype=torch.int32, device="cuda"),
    }
    iters = 3

    def turn(fused):
        with fused_residual(fused):
            t0 = time.perf_counter()
            for _ in range(iters):
                dets = model(batch)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3 / iters, dets

    for fused in (False, True):  # warm-up
        with fused_residual(fused):
            model(batch)
    torch.cuda.synchronize()
    u1, _ = turn(False)
    for w in wrappers.values():
        w.launches = 0
    f1, dets = turn(True)
    counts = {k: w.launches for k, w in wrappers.items()}
    if counts["matmul_affine_residual"] != per_forward * iters or counts["roi_align_band"] < iters:
        raise AssertionError(f"fused main path: launches {counts}, want {per_forward} fused per forward")
    kernels["matmul_affine_residual"]["launches"] = counts["matmul_affine_residual"]
    check_detections(dets, B)
    f2, _ = turn(True)
    u2, _ = turn(False)
    ms, u_ms = (f1 + f2) / 2, (u1 + u2) / 2
    print(f"fused main path R-101-FPN 832x1344 bf16 pallas_fast B={B} LVC_TPU_FUSED_RESIDUAL=1, in turns "
          f"unfused/fused/fused/unfused: {u1:.2f}, {f1:.2f}, {f2:.2f}, {u2:.2f} ms/batch; fused {ms:.2f} ms/batch "
          f"{B * 1e3 / ms:.2f} img/s, unfused {u_ms:.2f} ms/batch {B * 1e3 / u_ms:.2f} img/s, speedup "
          f"{u_ms / ms:.3f}x (unfused main path earlier in this run: {unfused_ms:.2f} ms/batch); launches "
          f"{counts} ({per_forward} fused per forward) {tag}")
    with fused_residual(True):
        profile_call(lambda: model(batch), ms, "fused forward", tag)
    del model
    torch.cuda.empty_cache()
    print(f"check_fused_serving --batch {B} --iters 3: {tag}")
    res = check_fused_serving.compare(batch=B, height=H, width=W, iters=3)
    if res["valid_fused"] != res["valid_unfused"]:
        raise AssertionError(f"check_fused_serving: valid counts differ {res}")
    torch.cuda.empty_cache()


def fused_train_path(tag, kernels, unfused):
    """The R-50-FPN AMP train step as in train_main_path, fused and unfused on
    the same model in turns (unfused, fused, fused, unfused; 5 timed steps
    each after one warm-up step of each form): every kernel count set to 0
    just before the first fused turn and read just after, the fused launches
    per step derived from the model (``fused_calls``: 19 forward + 13
    recomputed under REMAT), finite losses, ms/step and peak memory of both
    forms beside the unfused train path's of this run, one profiled fused
    step."""
    import torch

    from lvc_tpu_torch.engine.train_loop import make_train_step
    from lvc_tpu_torch.modeling.layers import fused_residual
    from lvc_tpu_torch.modeling.meta_arch.build import build_model
    from lvc_tpu_torch.ops import roi_align as ra
    from lvc_tpu_torch.ops.fused_matmul import matmul_affine_residual
    from lvc_tpu_torch.solver.build import build_lr_schedule, build_optimizer
    from lvc_tpu_torch.utils.init import damped_init

    wrappers = {"roi_align_paired": ra.roi_align_paired, "roi_align_paired_bwd": ra.roi_align_paired_bwd,
                "matmul_affine_residual": matmul_affine_residual}
    cfg = train_cfg()
    model = damped_init(build_model(cfg), seed=0).train()
    opt = build_optimizer(cfg, model)  # sets requires_grad by FREEZE_AT
    forward, recomputed = fused_calls(model)
    step = make_train_step(model, opt, build_lr_schedule(cfg, opt), mixed_precision=cfg.SOLVER.AMP.ENABLED)
    B, H, W = 8, 832, 1344
    batch = train_batch(B, H, W, cfg.PAD.MAX_GT_PER_IMAGE, seed=0, device="cuda",
                        num_classes=cfg.MODEL.ROI_HEADS.NUM_CLASSES)
    gen = torch.Generator(device="cuda").manual_seed(0)
    steps = 5

    def turn(fused):
        with fused_residual(fused):
            t0 = time.perf_counter()
            metrics = [step(batch, gen) for _ in range(steps)]
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3 / steps, metrics

    for fused in (False, True):  # warm-up
        with fused_residual(fused):
            step(batch, gen)
    torch.cuda.synchronize()
    u1, _ = turn(False)
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.reset_peak_memory_stats()
    f1, metrics = turn(True)
    counts = {k: w.launches for k, w in wrappers.items()}
    peak = torch.cuda.max_memory_allocated()
    want = (forward + recomputed) * steps
    if counts["matmul_affine_residual"] != want or min(counts.values()) < steps:
        raise AssertionError(f"fused train path: launches {counts}, want {forward} + {recomputed} fused per step")
    losses = [{k: float(v) for k, v in m.items()} for m in metrics]
    if not all(math.isfinite(v) for m in losses for v in m.values()):
        raise AssertionError(f"fused train path: non-finite losses {losses}")
    kernels["matmul_affine_residual"]["train_launches"] = counts["matmul_affine_residual"]
    f2, _ = turn(True)
    torch.cuda.reset_peak_memory_stats()
    u2, _ = turn(False)
    u_peak = torch.cuda.max_memory_allocated()
    ms, u_ms = (f1 + f2) / 2, (u1 + u2) / 2
    print(f"fused train path R-50-FPN 832x1344 AMP bf16 pallas_train B={B} LVC_TPU_FUSED_RESIDUAL=1, in turns "
          f"unfused/fused/fused/unfused: {u1:.2f}, {f1:.2f}, {f2:.2f}, {u2:.2f} ms/step; fused {ms:.2f} ms/step "
          f"{B * 1e3 / ms:.2f} img/s, peak memory {peak / 2 ** 30:.2f} GiB; unfused {u_ms:.2f} ms/step, peak "
          f"{u_peak / 2 ** 30:.2f} GiB; speedup {u_ms / ms:.3f}x (unfused train path earlier in this run: "
          f"{unfused[0]:.2f} ms/step); launches {counts} ({forward} forward + {recomputed} recomputed under "
          f"REMAT per step) {tag}")
    for i, m in enumerate(losses):
        print(f"  step {i + 1}: " + ", ".join(f"{k} {v:.5f}" for k, v in sorted(m.items())) + f" {tag}")
    with fused_residual(True):
        profile_call(lambda: step(batch, gen), ms, "fused train step", tag, TRAIN_STAGES)
    del model, opt
    torch.cuda.empty_cache()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from lvc_tpu_torch.modeling.layers import fused_residual
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
    with fused_residual(False):
        reference_check(tag)
        serving_ms = main_path(tag, kernels)
        kernels["roi_align_paired_bwd"] = backward_kernel_phase(tag)
        train_reference_check(tag)
        train = train_main_path(tag, kernels)
    kernels["flash_attention_fwd"] = attention_kernel_phase(tag)
    verify_reference_check(tag)
    verify_main_path(tag, kernels)
    cli_phase(tag)
    kernels["matmul_affine_residual"] = fused_kernel_phase(tag)
    fused_reference_check(tag)
    fused_main_path(tag, kernels, serving_ms)
    fused_train_path(tag, kernels, train)
    print(json.dumps({"kernels": list(kernels.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
