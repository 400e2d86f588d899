"""Seeded weights, made by the benchmark and loaded into both the port and
the reference: detectron2's initialisation rules (``c2_msra_fill`` for the
ResNet convolutions, ``c2_xavier_fill`` for the FPN and the box head's
fully connected layers, N(0, 0.01) for the RPN head and the classifier,
N(0, 0.001) for the box regressor), with normal draws of the same variance
in place of the Xavier fill's uniform ones, FrozenBN at identity, and the
stem's weights scaled by 1/64 so that raw pixels (PIXEL_STD 1) give
activations of unit scale, as a pretrained stem's frozen statistics do, and
each residual branch's last convolution scaled by 1/4, so that the sum of
16 blocks grows by 1.6x and not by 2^8 as it would with FrozenBN at
identity (a trained network's frozen statistics keep it at unit scale).
All draws come from one ``torch.Generator`` on the device in one call, in
the order of ``spec`` below."""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from benchmark.reference.model import STAGE_BLOCKS

STEM_SCALE = 1.0 / 64
RESIDUAL_SCALE = 0.25


def spec(cfg: Dict) -> List[Tuple[str, tuple, str, float]]:
    """(name, shape, kind, std) of every tensor of the detector's state:
    kind "normal" (std), "zero" or "one"."""
    out: List[Tuple[str, tuple, str, float]] = []

    def frozen_bn(name, c):
        out.extend([(f"{name}.norm.weight", (c,), "one", 0.0), (f"{name}.norm.bias", (c,), "zero", 0.0),
                    (f"{name}.norm.running_mean", (c,), "zero", 0.0), (f"{name}.norm.running_var", (c,), "one", 0.0)])

    def conv(name, cout, cin, k, std=None, bias=False, norm=True, scale=1.0):
        if std is None:
            std = math.sqrt(2.0 / (cout * k * k)) * scale  # c2_msra_fill: fan_out
        out.append((f"{name}.weight", (cout, cin, k, k), "normal", std))
        if bias:
            out.append((f"{name}.bias", (cout,), "zero", 0.0))
        if norm:
            frozen_bn(name, cout)

    bu = "backbone.bottom_up"
    stem = cfg["MODEL.RESNETS.STEM_OUT_CHANNELS"]
    conv(f"{bu}.stem.conv1", stem, 3, 7, scale=STEM_SCALE)
    cin, cout, mid = stem, cfg["MODEL.RESNETS.RES2_OUT_CHANNELS"], cfg["MODEL.RESNETS.WIDTH_PER_GROUP"]
    widths = {}
    for i, n in enumerate(STAGE_BLOCKS[cfg["MODEL.RESNETS.DEPTH"]]):
        stage = f"res{i + 2}"
        for b in range(n):
            name = f"{bu}.{stage}.{b}"
            if b == 0:
                conv(f"{name}.shortcut", cout, cin, 1)
            conv(f"{name}.conv1", mid, cin if b == 0 else cout, 1)
            conv(f"{name}.conv2", mid, mid, 3)
            conv(f"{name}.conv3", cout, mid, 1, scale=RESIDUAL_SCALE)
        widths[i + 2] = cout
        cin, cout, mid = cout, cout * 2, mid * 2
    fpn = cfg["MODEL.FPN.OUT_CHANNELS"]
    for sid in (2, 3, 4, 5):
        conv(f"backbone.fpn_lateral{sid}", fpn, widths[sid], 1, std=math.sqrt(1.0 / widths[sid]), bias=True,
             norm=False)
        conv(f"backbone.fpn_output{sid}", fpn, fpn, 3, std=math.sqrt(1.0 / (9 * fpn)), bias=True, norm=False)
    A = len(cfg["MODEL.ANCHOR_GENERATOR.ASPECT_RATIOS"][0])
    rpn = "proposal_generator.rpn_head"
    conv(f"{rpn}.conv", fpn, fpn, 3, std=0.01, bias=True, norm=False)
    conv(f"{rpn}.objectness_logits", A, fpn, 1, std=0.01, bias=True, norm=False)
    conv(f"{rpn}.anchor_deltas", 4 * A, fpn, 1, std=0.01, bias=True, norm=False)
    P = cfg["MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION"]
    fc = cfg["MODEL.ROI_BOX_HEAD.FC_DIM"]
    d = fpn * P * P
    for k in range(cfg["MODEL.ROI_BOX_HEAD.NUM_FC"]):
        out.append((f"roi_heads.box_head.fc{k + 1}.weight", (fc, d), "normal", math.sqrt(1.0 / d)))
        out.append((f"roi_heads.box_head.fc{k + 1}.bias", (fc,), "zero", 0.0))
        d = fc
    K = cfg["MODEL.ROI_HEADS.NUM_CLASSES"]
    out.append(("roi_heads.box_predictor.cls_score.weight", (K + 1, d), "normal", 0.01))
    if cfg["MODEL.ROI_HEADS.OUTPUT_LAYER"] != "CosineSimOutputLayers":
        out.append(("roi_heads.box_predictor.cls_score.bias", (K + 1,), "zero", 0.0))
    out.append(("roi_heads.box_predictor.bbox_pred.weight", (4 * K, d), "normal", 0.001))
    out.append(("roi_heads.box_predictor.bbox_pred.bias", (4 * K,), "zero", 0.0))
    return out


def make(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every tensor of ``spec``, float32, on ``device``: one normal draw of
    the summed size, cut and scaled per tensor."""
    entries = spec(cfg)
    total = sum(math.prod(s) for _, s, kind, _ in entries if kind == "normal")
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    draws = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for name, shape, kind, std in entries:
        if kind == "normal":
            n = math.prod(shape)
            out[name] = draws[at:at + n].view(shape) * std
            at += n
        elif kind == "one":
            out[name] = torch.ones(shape, device=device)
        else:
            out[name] = torch.zeros(shape, device=device)
    return out
