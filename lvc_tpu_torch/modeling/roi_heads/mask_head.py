"""Mask R-CNN mask head (counterpart of
``lvc_tpu/modeling/roi_heads/mask_head.py``: MaskRCNNConvUpsampleHead:22,
crop_gt_masks:48, mask_rcnn_loss:91, mask_rcnn_inference:111,
paste_masks_in_image:122).

The head takes the (N, P, P, C) pooled features and returns (N, K, 2P, 2P)
mask logits (NCHW; K classes, or 1 class-agnostic). Its modules carry
detectron2's names (``mask_fcn{1..n}``, ``deconv``, ``predictor``), so a
reference ``.pth`` loads as it is. It runs in float32 whatever the pooled
features' dtype, as flax promotes a bf16 input against float32 parameters.
It has no norm: ``ROI_MASK_HEAD.NORM`` is not read, in either package, so
detectron2's SyncBN Mask R-CNN (``NORM "SyncBN"`` in its mask head too)
builds a mask head without one, as the JAX package builds it.

Training crops each sampled slot's matched gt bitmask to the mask size with
JAX's half-pixel bilinear gather (not a RoIAlign), and the loss is the
per-pixel BCE of the gt class's channel, averaged over the foreground slots
through ``global_ratio``.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from lvc_tpu_torch.modeling.sampling import global_ratio


class MaskRCNNConvUpsampleHead(nn.Module):
    """``num_conv`` 3x3 convs with ReLU -> a 2x2 stride-2 transposed conv with
    ReLU -> a 1x1 predictor."""

    def __init__(self, in_channels: int, num_classes: int = 80, num_conv: int = 4, conv_dim: int = 256,
                 cls_agnostic_mask: bool = False):
        super().__init__()
        self.num_conv = num_conv
        c = in_channels
        for i in range(num_conv):
            self.add_module(f"mask_fcn{i + 1}", nn.Conv2d(c, conv_dim, 3, padding=1))
            c = conv_dim
        self.deconv = nn.ConvTranspose2d(c, conv_dim, 2, stride=2)
        self.predictor = nn.Conv2d(conv_dim, 1 if cls_agnostic_mask else num_classes, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (N, P, P, C) pooled features -> (N, K, 2P, 2P) float32 logits."""
        x = x.permute(0, 3, 1, 2).float()
        for i in range(self.num_conv):
            x = F.relu(getattr(self, f"mask_fcn{i + 1}")(x))
        return self.predictor(F.relu(self.deconv(x)))


def crop_gt_masks(
    gt_masks: torch.Tensor,  # (G, Hm, Wm) bitmasks
    boxes: torch.Tensor,  # (S, 4) XYXY in the bitmasks' coordinates
    matched_gt_idx: torch.Tensor,  # (S,)
    out_size: int,
) -> torch.Tensor:
    """Each box's matched gt bitmask sampled bilinearly at the centres of an
    (out_size, out_size) grid over the box, the sample points clamped into
    the bitmask: (S, M, M) float32."""
    M = out_size
    h, w = gt_masks.shape[1:]
    masks = gt_masks[matched_gt_idx.long()].float()  # (S, Hm, Wm)
    boxes = boxes.float()
    t = (torch.arange(M, dtype=torch.float32, device=boxes.device) + 0.5) / M
    x = boxes[:, 0:1] + t[None, :] * (boxes[:, 2:3] - boxes[:, 0:1])  # (S, M)
    y = boxes[:, 1:2] + t[None, :] * (boxes[:, 3:4] - boxes[:, 1:2])
    x = torch.clamp(x - 0.5, 0.0, w - 1.0)
    y = torch.clamp(y - 0.5, 0.0, h - 1.0)
    x0, y0 = torch.floor(x).long(), torch.floor(y).long()
    x1, y1 = torch.clamp(x0 + 1, max=w - 1), torch.clamp(y0 + 1, max=h - 1)
    fx, fy = x - x0, y - y0
    s = torch.arange(masks.shape[0], device=masks.device)[:, None, None]

    def at(yy, xx):  # (S, M, M): masks[s, yy[s, i], xx[s, j]]
        return masks[s, yy[:, :, None], xx[:, None, :]]

    top = at(y0, x0) * (1 - fx)[:, None, :] + at(y0, x1) * fx[:, None, :]
    bot = at(y1, x0) * (1 - fx)[:, None, :] + at(y1, x1) * fx[:, None, :]
    return top * (1 - fy)[:, :, None] + bot * fy[:, :, None]


def _class_channel(mask_logits: torch.Tensor, classes: torch.Tensor) -> torch.Tensor:
    """(N, K, M, M) logits -> the (N, M, M) channel of each row's class (the
    only one when K is 1)."""
    k = mask_logits.shape[1]
    if k == 1:
        return mask_logits[:, 0]
    cls = classes.long().clamp(0, k - 1)
    return mask_logits[torch.arange(len(cls), device=cls.device), cls]


def mask_rcnn_loss(
    mask_logits: torch.Tensor,  # (S, K, M, M)
    gt_mask_crops: torch.Tensor,  # (S, M, M) in [0, 1]
    gt_classes: torch.Tensor,  # (S,)
    fg: torch.Tensor,  # (S,) foreground slots
) -> torch.Tensor:
    """Per-pixel BCE of the gt class's channel against the crop thresholded
    at 0.5, each slot's mean summed over the foreground slots and divided by
    their count (``global_ratio``)."""
    logits = _class_channel(mask_logits, gt_classes)
    target = (gt_mask_crops > 0.5).to(logits.dtype)
    bce = torch.relu(logits) - logits * target + torch.log1p(torch.exp(-logits.abs()))
    per_roi = bce.mean(dim=(1, 2))
    zero = torch.zeros((), dtype=per_roi.dtype, device=per_roi.device)
    return global_ratio(torch.where(fg, per_roi, zero).sum(), fg.sum())


def mask_rcnn_inference(mask_logits: torch.Tensor, classes: torch.Tensor) -> torch.Tensor:
    """(D, K, M, M) logits -> each detection's (D, M, M) probability mask of
    its predicted class, the sigmoid taken in float32."""
    return torch.sigmoid(_class_channel(mask_logits, classes).float())


def paste_masks_in_image(
    masks: torch.Tensor,  # (D, M, M) probability masks
    boxes: torch.Tensor,  # (D, 4) XYXY image coordinates
    image_hw: Tuple[int, int],
    threshold: float = 0.5,
) -> torch.Tensor:
    """Paste roi masks into (D, H, W) image masks, as the reference's
    ``grid_sample`` (align_corners=False, zeros padding) does: every pixel
    centre maps back to its roi coordinate and samples the mask bilinearly,
    taps outside the mask weigh 0, so a mask fades to 0 over the half-cell
    band outside its box. ``threshold >= 0`` binarises at ``>=``."""
    D, M, _ = masks.shape
    H, W = image_hw
    masks, boxes = masks.float(), boxes.float()
    ys = torch.arange(H, dtype=torch.float32, device=masks.device) + 0.5
    xs = torch.arange(W, dtype=torch.float32, device=masks.device) + 0.5

    def axis_taps(coords, lo, size):  # (D, n) indices and weights
        g = (coords[None, :] - lo[:, None]) / size[:, None] * M - 0.5
        i0 = torch.floor(g).long()
        f = g - i0
        i1 = i0 + 1
        zero = torch.zeros((), device=g.device)
        w0 = torch.where((i0 >= 0) & (i0 < M), 1.0 - f, zero)
        w1 = torch.where((i1 >= 0) & (i1 < M), f, zero)
        return i0.clamp(0, M - 1), i1.clamp(0, M - 1), w0, w1

    bw = torch.clamp(boxes[:, 2] - boxes[:, 0], min=1e-4)
    bh = torch.clamp(boxes[:, 3] - boxes[:, 1], min=1e-4)
    x0, x1, wx0, wx1 = axis_taps(xs, boxes[:, 0], bw)
    y0, y1, wy0, wy1 = axis_taps(ys, boxes[:, 1], bh)
    d = torch.arange(D, device=masks.device)[:, None, None]

    def at(yy, xx):  # (D, H, W): masks[d, yy[d, i], xx[d, j]]
        return masks[d, yy[:, :, None], xx[:, None, :]]

    top = at(y0, x0) * wx0[:, None, :] + at(y0, x1) * wx1[:, None, :]
    bot = at(y1, x0) * wx0[:, None, :] + at(y1, x1) * wx1[:, None, :]
    out = top * wy0[:, :, None] + bot * wy1[:, :, None]
    return out >= threshold if threshold >= 0 else out
