"""Operation and byte counts, worked out from the configuration's shapes and
from a kernel call's inputs, never from what the program executes, so that
a change to the program cannot move its own yardstick.

``model_flops``: the multiply-adds (x2) of the detector's convolutions and
linears for one image on a canvas: the ResNet, the FPN, the RPN head on
every level, and the box head and predictor on its boxes. A training step
counts 3x (forward, and the backward's two products) where the weights
train, and the forward alone for FREEZE_AT's frozen stages, whose backward
the step skips; recomputation (REMAT) is not model work and is not
counted. Peaks: NVIDIA's H100 SXM data sheet, dense.

``k2_bound`` / ``k3_bound``: frozen copies (commit 7572f27) of
``chip_smoke.bound`` / ``backward_bound``: the least time the card could
take for one RoIAlign call, the larger of its bytes (each feature element
the taps touch read once, the taps read once, the output written once)
over the memory rate and its float32 operations over the float32 rate.
``K2`` / ``K3``: the same as yardsticks of a wrapper's calls (``record``
keeps the shapes, the item size and the taps of one call, not its feature
maps; ``least_ms`` of a record), as a roofline reader's ``KERNEL`` names
them.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple, Sequence, Tuple

import torch

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
PEAK_FLOPS = {"bf16": 989e12, "tf32": 495e12}

STAGE_BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}


def _out(n: int, k: int, s: int, p: int) -> int:
    return (n + 2 * p - k) // s + 1


def _conv(h, w, cin, cout, k, s, p) -> Tuple[int, int, float]:
    ho, wo = _out(h, k, s, p), _out(w, k, s, p)
    return ho, wo, 2.0 * ho * wo * cout * cin * k * k


def backbone_flops(cfg: Dict, H: int, W: int) -> Tuple[float, float, Dict[str, Tuple[int, int]]]:
    """(FLOPs of the frozen stages, FLOPs of the rest, FPN level shapes)."""
    freeze_at = cfg["MODEL.BACKBONE.FREEZE_AT"]
    frozen = trained = 0.0
    stem = cfg["MODEL.RESNETS.STEM_OUT_CHANNELS"]
    h, w, f = _conv(H, W, 3, stem, 7, 2, 3)
    frozen += f if freeze_at >= 1 else 0.0
    trained += 0.0 if freeze_at >= 1 else f
    h, w = _out(h, 3, 2, 1), _out(w, 3, 2, 1)
    cin, cout, mid = stem, cfg["MODEL.RESNETS.RES2_OUT_CHANNELS"], cfg["MODEL.RESNETS.WIDTH_PER_GROUP"]
    res = {}
    for i, n in enumerate(STAGE_BLOCKS[cfg["MODEL.RESNETS.DEPTH"]]):
        stage = i + 2
        total = 0.0
        for b in range(n):
            s = 2 if (b == 0 and i > 0) else 1
            c_in = cin if b == 0 else cout
            if b == 0:
                total += _conv(h, w, c_in, cout, 1, s, 0)[2]
            h1, w1, f1 = _conv(h, w, c_in, mid, 1, s, 0)
            _, _, f2 = _conv(h1, w1, mid, mid, 3, 1, 1)
            _, _, f3 = _conv(h1, w1, mid, cout, 1, 1, 0)
            total += f1 + f2 + f3
            h, w = h1, w1
        if freeze_at >= stage:
            frozen += total
        else:
            trained += total
        res[stage] = (h, w, cout)
        cin, cout, mid = cout, cout * 2, mid * 2
    fpn = cfg["MODEL.FPN.OUT_CHANNELS"]
    levels = {}
    for stage, (h, w, c) in res.items():
        trained += _conv(h, w, c, fpn, 1, 1, 0)[2] + _conv(h, w, fpn, fpn, 3, 1, 1)[2]
        levels[f"p{stage}"] = (h, w)
    h5, w5 = levels["p5"]
    levels["p6"] = ((h5 + 1) // 2, (w5 + 1) // 2)
    return frozen, trained, levels


def model_flops(cfg: Dict, H: int, W: int, train: bool) -> float:
    """Model FLOPs of one image on an H x W canvas: a training step's
    (x3 where the weights train) or an inference forward's."""
    frozen, trained, levels = backbone_flops(cfg, H, W)
    fpn = cfg["MODEL.FPN.OUT_CHANNELS"]
    A = len(cfg["MODEL.ANCHOR_GENERATOR.ASPECT_RATIOS"][0])
    for h, w in levels.values():
        trained += 2.0 * h * w * fpn * (fpn * 9 + A + 4 * A)
    P = cfg["MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION"]
    fc = cfg["MODEL.ROI_BOX_HEAD.FC_DIM"]
    K = cfg["MODEL.ROI_HEADS.NUM_CLASSES"]
    per_box = 2.0 * (fpn * P * P * fc + (cfg["MODEL.ROI_BOX_HEAD.NUM_FC"] - 1) * fc * fc + fc * (K + 1) + fc * 4 * K)
    boxes = cfg["MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE"] if train else cfg["MODEL.RPN.POST_NMS_TOPK_TEST"]
    trained += per_box * boxes
    return frozen + (3.0 if train else 1.0) * trained


def peak_flops(cfg: Dict, train: bool) -> Tuple[float, str]:
    """The peak the step's products run against: bf16 under AMP (or a
    bfloat16 model), TF32 for a float32 model (PyTorch runs its
    convolutions in TF32 by default)."""
    bf16 = (train and cfg["SOLVER.AMP.ENABLED"]) or cfg["MODEL.DTYPE"] == "bfloat16"
    kind = "bf16" if bf16 else "tf32"
    return PEAK_FLOPS[kind], kind


# ------------------------------------------------------------ RoIAlign

def _touched(level_shapes, taps):
    rows_ok = (taps.wy != 0) & (taps.rows >= 0)
    pixels = 0
    cols_ok_all = torch.zeros(taps.wx.shape, dtype=torch.bool, device=taps.wx.device)
    for lv, (B, H, W, _) in enumerate(level_shapes):
        sel = taps.lvl == lv
        cols = taps.xs[:, None, None].long() + taps.tcol.long()
        cols_ok = (taps.wx != 0) & (cols < W)
        cols_ok_all |= cols_ok & sel[:, None, None]
        r = torch.where(rows_ok & sel[:, None, None], taps.rows.long(), -1)
        c = torch.where(cols_ok & sel[:, None, None], cols, -1)
        lin = r[:, :, :, None, None] * W + c[:, None, None, :, :]
        ok = (r[:, :, :, None, None] >= 0) & (c[:, None, None, :, :] >= 0)
        mark = torch.zeros(B * H * W, dtype=torch.bool, device=taps.wx.device)
        mark[lin[ok]] = True
        pixels += int(mark.sum())
    return rows_ok, cols_ok_all, pixels


def _least_ms(nbytes: float, ops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S) * 1e3


def k2_bound(level_shapes: Sequence[Tuple[int, int, int, int]], itemsize: int, taps) -> float:
    """Least ms of one K2 forward call; ``level_shapes`` (B, H, W, C)."""
    n, P, _ = taps.rows.shape
    C = level_shapes[0][3]
    rows_ok, cols_ok, pixels = _touched(level_shapes, taps)
    meta = sum(t.numel() * t.element_size() for t in taps)
    nbytes = pixels * C * itemsize + n * P * P * C * itemsize + meta
    nr, nt = rows_ok.sum(-1), cols_ok.sum(-1)
    ops = C * int((nt[:, None, :] * (2 * nr[:, :, None] + 2) + 1).sum())
    return _least_ms(nbytes, ops)


def k3_bound(level_shapes: Sequence[Tuple[int, int, int, int]], itemsize: int, taps) -> float:
    """Least ms of one K3 call (d pooled -> d levels): the pooled gradient
    and the taps read once, every level's gradient written once."""
    n, P, _ = taps.rows.shape
    C = level_shapes[0][3]
    rows_ok, cols_ok, _ = _touched(level_shapes, taps)
    meta = sum(t.numel() * t.element_size() for t in taps)
    nbytes = n * P * P * C * itemsize + meta + sum(math.prod(s) for s in level_shapes) * itemsize
    nr, nt = rows_ok.sum(-1), cols_ok.sum(-1)
    ops = C * int((nt[:, None, :] * 2 * nr[:, :, None] + 1).sum())
    return _least_ms(nbytes, ops)


class Yardstick(NamedTuple):
    record: Callable
    least_ms: Callable


# roi_align_paired(levels, taps) and roi_align_paired_bwd(level_shapes, taps, gout)
K2 = Yardstick(lambda levels, taps: ([tuple(f.shape) for f in levels], levels[0].element_size(), taps),
               lambda rec: k2_bound(*rec))
K3 = Yardstick(lambda level_shapes, taps, gout: ([tuple(int(d) for d in s) for s in level_shapes],
                                                 gout.element_size(), taps),
               lambda rec: k3_bound(*rec))
