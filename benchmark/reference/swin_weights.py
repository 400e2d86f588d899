"""Seeded weights of Swin Mask R-CNN, made by the benchmark and loaded into
both the port and the reference, under the port's (the public Swin and
detectron2) names: the Swin's linears, patch embedding and relative
position tables N(0, 0.02) (the published ``trunc_normal_(std=.02)``
without the truncation), its LayerNorms at weight 1, and every bias of the
bottom-up N(0, 0.02), as trained weights have them (from zero biases the
canvas padding stays exactly 0 through every block and each LayerNorm's
backward scales by rsqrt(1e-5)); the FPN, the RPN and the box head by
``weights.py``'s rules; the mask head by detectron2's (``c2_msra_fill`` for
its convolutions and the transposed convolution, N(0, 0.001) for the
predictor, zero biases). All draws come from one ``torch.Generator`` on the
device in one call, in the order of ``spec``."""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from benchmark.reference.swin_mask import swin_dims

SWIN_STD = 0.02


def spec(cfg: Dict) -> List[Tuple[str, tuple, str, float]]:
    """(name, shape, kind, std) of every tensor of the detector's state:
    kind "normal" (std), "zero" or "one"."""
    out: List[Tuple[str, tuple, str, float]] = []

    def linear(name, cout, cin, bias=True, std=SWIN_STD, bias_std=SWIN_STD):
        out.append((f"{name}.weight", (cout, cin), "normal", std))
        if bias:
            out.append((f"{name}.bias", (cout,), "normal", bias_std))

    def norm(name, c):
        out.extend([(f"{name}.weight", (c,), "one", 0.0), (f"{name}.bias", (c,), "normal", SWIN_STD)])

    def conv(name, cout, cin, k, std, bias_kind="zero"):
        out.append((f"{name}.weight", (cout, cin, k, k), "normal", std))
        out.append((f"{name}.bias", (cout,), bias_kind, SWIN_STD if bias_kind == "normal" else 0.0))

    bu = "backbone.bottom_up"
    embed, depths, heads = swin_dims(cfg)
    ws = cfg["MODEL.SWIN.WINDOW_SIZE"]
    p = cfg["MODEL.SWIN.PATCH_SIZE"]
    hidden = cfg["MODEL.SWIN.MLP_RATIO"]
    conv(f"{bu}.patch_embed.proj", embed, 3, p, SWIN_STD, "normal")
    norm(f"{bu}.patch_embed.norm", embed)
    widths = {}
    for i, (depth, h) in enumerate(zip(depths, heads)):
        c = embed * 2 ** i
        for j in range(depth):
            name = f"{bu}.layers.{i}.blocks.{j}"
            norm(f"{name}.norm1", c)
            out.append((f"{name}.attn.relative_position_bias_table", ((2 * ws - 1) ** 2, h), "normal", SWIN_STD))
            linear(f"{name}.attn.qkv", 3 * c, c)
            linear(f"{name}.attn.proj", c, c)
            norm(f"{name}.norm2", c)
            linear(f"{name}.mlp.fc1", int(c * hidden), c)
            linear(f"{name}.mlp.fc2", c, int(c * hidden))
        if i < len(depths) - 1:
            norm(f"{bu}.layers.{i}.downsample.norm", 4 * c)
            linear(f"{bu}.layers.{i}.downsample.reduction", 2 * c, 4 * c, bias=False)
        widths[i + 2] = c
    for i in range(len(depths)):
        norm(f"{bu}.norm{i}", embed * 2 ** i)
    fpn = cfg["MODEL.FPN.OUT_CHANNELS"]
    for sid in (2, 3, 4, 5):
        conv(f"backbone.fpn_lateral{sid}", fpn, widths[sid], 1, math.sqrt(1.0 / widths[sid]))
        conv(f"backbone.fpn_output{sid}", fpn, fpn, 3, math.sqrt(1.0 / (9 * fpn)))
    A = len(cfg["MODEL.ANCHOR_GENERATOR.ASPECT_RATIOS"][0])
    rpn = "proposal_generator.rpn_head"
    conv(f"{rpn}.conv", fpn, fpn, 3, 0.01)
    conv(f"{rpn}.objectness_logits", A, fpn, 1, 0.01)
    conv(f"{rpn}.anchor_deltas", 4 * A, fpn, 1, 0.01)
    P = cfg["MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION"]
    fc = cfg["MODEL.ROI_BOX_HEAD.FC_DIM"]
    d = fpn * P * P
    for k in range(cfg["MODEL.ROI_BOX_HEAD.NUM_FC"]):
        out.append((f"roi_heads.box_head.fc{k + 1}.weight", (fc, d), "normal", math.sqrt(1.0 / d)))
        out.append((f"roi_heads.box_head.fc{k + 1}.bias", (fc,), "zero", 0.0))
        d = fc
    K = cfg["MODEL.ROI_HEADS.NUM_CLASSES"]
    out.append(("roi_heads.box_predictor.cls_score.weight", (K + 1, d), "normal", 0.01))
    out.append(("roi_heads.box_predictor.cls_score.bias", (K + 1,), "zero", 0.0))
    out.append(("roi_heads.box_predictor.bbox_pred.weight", (4 * K, d), "normal", 0.001))
    out.append(("roi_heads.box_predictor.bbox_pred.bias", (4 * K,), "zero", 0.0))
    mh = "roi_heads.mask_head"
    cm = cfg["MODEL.ROI_MASK_HEAD.CONV_DIM"]
    cin = fpn
    for i in range(cfg["MODEL.ROI_MASK_HEAD.NUM_CONV"]):
        conv(f"{mh}.mask_fcn{i + 1}", cm, cin, 3, math.sqrt(2.0 / (cm * 9)))
        cin = cm
    conv(f"{mh}.deconv", cin, cm, 2, math.sqrt(2.0 / (cin * 4)))  # ConvTranspose2d: (in, out, k, k)
    conv(f"{mh}.predictor", K, cm, 1, 0.001)
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
