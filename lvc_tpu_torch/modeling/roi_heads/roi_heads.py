"""ROI heads, inference branch (counterpart of
``lvc_tpu/modeling/roi_heads/roi_heads.py``: StandardROIHeads:47, pool:218,
inference:422-448). Training-time matching and sampling are not ported yet.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence

import torch
from torch import nn

from lvc_tpu_torch.modeling.box_regression import Box2BoxTransform
from lvc_tpu_torch.modeling.roi_heads.box_head import FastRCNNConvFCHead
from lvc_tpu_torch.modeling.roi_heads.fast_rcnn import (
    Detections,
    FastRCNNOutputLayers,
    fast_rcnn_inference,
)
from lvc_tpu_torch.ops import roi_align


class StandardROIHeads(nn.Module):
    """Pooler -> conv/fc head -> output layer -> fixed-shape inference."""

    def __init__(
        self,
        in_features: Sequence[str],
        strides: Dict[str, int],
        in_channels: int,
        num_classes: int = 80,
        pooler_resolution: int = 7,
        pooler_sampling_ratio: int = 0,
        pooler_max_grid: int = 2,
        num_conv: int = 0,
        conv_dim: int = 256,
        num_fc: int = 2,
        fc_dim: int = 1024,
        head_norm: str = "",
        cls_agnostic_bbox_reg: bool = False,
        bbox_reg_weights=(10.0, 10.0, 5.0, 5.0),
        score_thresh_test: float = 0.05,
        nms_thresh_test: float = 0.5,
        detections_per_image: int = 100,
        pre_nms_candidates: int = 2048,
        pooler_impl: str = "auto",
        canonical_box_size: int = 224,
        canonical_level: int = 4,
    ):
        super().__init__()
        if pooler_impl in ("pallas_train", "pallas_train_flat", "tiled"):
            raise NotImplementedError(
                f"POOLER_IMPL {pooler_impl!r} is not ported yet (ROADMAP.md queue 2: "
                "rows 6-8 of the kernel table are the training PR's; 'tiled' is an XLA form)"
            )
        if pooler_impl not in ("auto", "pallas", "pallas_fast", "pallas_band", "exact"):
            raise ValueError(f"unknown POOLER_IMPL {pooler_impl!r}")
        self.in_features = tuple(in_features)
        self.strides = tuple(strides[f] for f in self.in_features)
        self.pooler_impl = pooler_impl
        self.pooler_resolution = pooler_resolution
        self.pooler_sampling_ratio = pooler_sampling_ratio
        self.pooler_max_grid = pooler_max_grid
        self.canonical_box_size = canonical_box_size
        self.canonical_level = canonical_level
        self.box_head = FastRCNNConvFCHead(
            in_channels, pooler_resolution, num_conv, conv_dim, num_fc, fc_dim, head_norm
        )
        out_dim = fc_dim if num_fc else conv_dim * pooler_resolution ** 2
        self.box_predictor = FastRCNNOutputLayers(out_dim, num_classes, cls_agnostic_bbox_reg)
        self.box2box = Box2BoxTransform(bbox_reg_weights)
        self.score_thresh = score_thresh_test
        self.nms_thresh = nms_thresh_test
        self.detections_per_image = detections_per_image
        self.pre_nms_candidates = pre_nms_candidates

    def pool(self, features: Dict[str, torch.Tensor], boxes: torch.Tensor) -> torch.Tensor:
        """features: per-level (B, C, H, W) in channels_last memory; boxes
        (B, R, 4) -> (B, R, P, P, C) in the feature dtype.

        pallas_fast / pallas_band -> the band kernel (K1); auto / pallas on
        CUDA -> the paired kernel (K2), as "auto -> pallas on the accelerator"
        in JAX; auto off CUDA and exact -> the torch point gather."""
        # NCHW channels_last -> a contiguous (B, H, W, C) view, no copy
        feats = [features[f].permute(0, 2, 3, 1) for f in self.in_features]
        impl = self.pooler_impl
        if impl == "auto":
            impl = "pallas" if feats[0].is_cuda else "exact"
        max_grid = self.pooler_max_grid
        if impl.startswith("pallas"):
            # the kernels' band and pair layouts assume a sampling grid <= 2
            max_grid = min(max_grid, 2)
        kwargs = dict(
            output_size=self.pooler_resolution,
            sampling_ratio=self.pooler_sampling_ratio,
            max_grid=max_grid,
            min_level=int(math.log2(self.strides[0])),
            canonical_box_size=self.canonical_box_size,
            canonical_level=self.canonical_level,
        )
        if impl == "pallas_fast":
            return roi_align.pool_band(feats, boxes, self.strides, patch=True, **kwargs)
        if impl == "pallas_band":
            return roi_align.pool_band(feats, boxes, self.strides, patch=False, **kwargs)
        if impl == "pallas":
            return roi_align.pool_paired(feats, boxes, self.strides, **kwargs)
        return roi_align.batched_multilevel_roi_align(feats, boxes, self.strides, **kwargs)

    def forward(
        self,
        features: Dict[str, torch.Tensor],
        proposals: torch.Tensor,  # (B, R, 4)
        proposal_valid: torch.Tensor,  # (B, R)
        image_sizes: torch.Tensor,  # (B, 2)
    ) -> Detections:
        B, R = proposals.shape[:2]
        pooled = self.pool(features, proposals)
        x = self.box_head(pooled.reshape(B * R, *pooled.shape[2:]))
        scores, deltas = self.box_predictor(x)
        probs = torch.softmax(scores, dim=-1).reshape(B, R, -1)
        boxes = self.box2box.apply_deltas(deltas.reshape(B, R, -1), proposals)
        return fast_rcnn_inference(
            boxes, probs, image_sizes, proposal_valid, self.score_thresh,
            self.nms_thresh, self.detections_per_image, self.pre_nms_candidates,
        )
