"""Keypoint R-CNN head (counterpart of
``lvc_tpu/modeling/roi_heads/keypoint_head.py``:
KRCNNConvDeconvUpsampleHead:21, keypoints_to_heatmap_targets:43,
keypoint_rcnn_loss:69, keypoint_rcnn_inference:87).

The head takes the (N, P, P, C) pooled features and returns (N, K, 4P, 4P)
heatmap logits (NCHW, K keypoints): ``conv_fcn{1..n}`` (3x3, ReLU), the 4x4
stride-2 transposed conv ``score_lowres`` and a 2x bilinear upsample
(half-pixel centres, edges clamped), detectron2's names and layout. It runs
in float32 whatever the pooled features' dtype, as flax promotes a bf16
input against float32 parameters.

Training bins each visible keypoint of a slot's matched gt into its box's
heatmap cell, and the loss is the softmax cross-entropy over the cells,
summed over the visible keypoints of the foreground slots and divided by
their count (``global_ratio``). Inference decodes each heatmap's argmax
cell centre to image coordinates, with its softmax probability as the
score.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from lvc_tpu_torch.modeling.sampling import global_ratio


class KRCNNConvDeconvUpsampleHead(nn.Module):
    def __init__(self, in_channels: int, num_keypoints: int = 17, num_conv: int = 8, conv_dim: int = 512):
        super().__init__()
        self.num_conv = num_conv
        c = in_channels
        for i in range(num_conv):
            self.add_module(f"conv_fcn{i + 1}", nn.Conv2d(c, conv_dim, 3, padding=1))
            c = conv_dim
        self.score_lowres = nn.ConvTranspose2d(c, num_keypoints, 4, stride=2, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (N, P, P, C) pooled features -> (N, K, 4P, 4P) float32 logits."""
        x = x.permute(0, 3, 1, 2).float()
        for i in range(self.num_conv):
            x = F.relu(getattr(self, f"conv_fcn{i + 1}")(x))
        x = self.score_lowres(x)
        return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)


def keypoints_to_heatmap_targets(
    keypoints: torch.Tensor,  # (S, K, 3) (x, y, visibility) image coordinates
    boxes: torch.Tensor,  # (S, 4)
    heatmap_size: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each keypoint's flat heatmap cell (S, K) and whether it counts (S, K):
    visible and inside its box. A keypoint exactly on the box's right or
    bottom edge bins into the last cell and counts (detectron2's
    ``boundary_inds`` rule)."""
    M = heatmap_size
    x, y, vis = keypoints[..., 0], keypoints[..., 1], keypoints[..., 2]
    bw = torch.clamp(boxes[:, 2] - boxes[:, 0], min=1e-4)[:, None]
    bh = torch.clamp(boxes[:, 3] - boxes[:, 1], min=1e-4)[:, None]
    ix = torch.floor((x - boxes[:, 0:1]) / bw * M).long()
    iy = torch.floor((y - boxes[:, 1:2]) / bh * M).long()
    last = torch.full_like(ix, M - 1)
    ix = torch.where(x == boxes[:, 2:3], last, ix)
    iy = torch.where(y == boxes[:, 3:4], last, iy)
    inside = (ix >= 0) & (ix < M) & (iy >= 0) & (iy < M)
    return iy.clamp(0, M - 1) * M + ix.clamp(0, M - 1), inside & (vis > 0)


def keypoint_rcnn_loss(
    kp_logits: torch.Tensor,  # (S, K, M, M)
    keypoints: torch.Tensor,  # (S, K, 3)
    boxes: torch.Tensor,  # (S, 4)
    fg: torch.Tensor,  # (S,)
    normalizer: Optional[float] = None,
) -> torch.Tensor:
    """Softmax CE over the M*M cells of each visible keypoint of the
    foreground slots, summed and divided by ``normalizer`` or by the count
    of such keypoints."""
    S, K, M, _ = kp_logits.shape
    targets, valid = keypoints_to_heatmap_targets(keypoints, boxes, M)
    valid = valid & fg[:, None]
    logp = F.log_softmax(kp_logits.reshape(S, K, M * M).float(), dim=-1)
    ce = -torch.gather(logp, 2, targets[:, :, None])[..., 0]  # (S, K)
    zero = torch.zeros((), dtype=ce.dtype, device=ce.device)
    n = valid.sum() if normalizer is None else float(normalizer)
    return global_ratio(torch.where(valid, ce, zero).sum(), n)


def keypoint_rcnn_inference(kp_logits: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """(D, K, M, M) heatmaps and (D, 4) boxes -> (D, K, 3) image keypoints
    (x, y, score): each heatmap's argmax cell centre (the first cell on
    ties, as ``jnp.argmax``) and its softmax probability."""
    D, K, M, _ = kp_logits.shape
    flat = kp_logits.reshape(D, K, M * M).float()
    idx = torch.argmax(flat, dim=-1)  # (D, K)
    score = torch.gather(torch.softmax(flat, dim=-1), 2, idx[..., None])[..., 0]
    iy = torch.div(idx, M, rounding_mode="floor").float() + 0.5
    ix = (idx % M).float() + 0.5
    boxes = boxes.float()
    bw = torch.clamp(boxes[:, 2] - boxes[:, 0], min=1e-4)[:, None]
    bh = torch.clamp(boxes[:, 3] - boxes[:, 1], min=1e-4)[:, None]
    x = boxes[:, 0:1] + ix / M * bw
    y = boxes[:, 1:2] + iy / M * bh
    return torch.stack([x, y, score], dim=-1)
