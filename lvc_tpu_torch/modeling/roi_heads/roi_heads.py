"""ROI heads (counterpart of ``lvc_tpu/modeling/roi_heads/roi_heads.py``:
SampledProposals:39, StandardROIHeads:47, label_and_sample_proposals:158-215,
pool:218-314, __call__:371-448).

In training mode with gt, the heads append the gt boxes to the proposals,
match and sample them, pool the sampled boxes and return the Fast R-CNN
losses; otherwise they return fixed-shape detections.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Sequence

import torch
from torch import nn

from lvc_tpu_torch.modeling.box_regression import Box2BoxTransform
from lvc_tpu_torch.modeling.matcher import Matcher
from lvc_tpu_torch.modeling.roi_heads.box_head import FastRCNNConvFCHead
from lvc_tpu_torch.modeling.roi_heads.fast_rcnn import (
    Detections,
    FastRCNNOutputLayers,
    fast_rcnn_inference,
    fast_rcnn_losses,
)
from lvc_tpu_torch.modeling.sampling import subsample_labels
from lvc_tpu_torch.ops import roi_align
from lvc_tpu_torch.structures import boxes as box_ops

_POOLER_IMPLS = ("auto", "pallas", "pallas_fast", "pallas_band", "pallas_train",
                 "pallas_train_flat", "exact")


class SampledProposals(NamedTuple):
    boxes: torch.Tensor  # (B, S, 4)
    gt_boxes: torch.Tensor  # (B, S, 4) matched gt (garbage for background rows)
    gt_classes: torch.Tensor  # (B, S) in [0, K] (K = background); -1 = ignore
    valid: torch.Tensor  # (B, S)
    gt_idx: torch.Tensor  # (B, S) matched gt row


class StandardROIHeads(nn.Module):
    """Pooler -> conv/fc head -> output layer, with train-time sampling."""

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
        iou_thresholds: Sequence[float] = (0.5,),
        iou_labels: Sequence[int] = (0, 1),
        batch_size_per_image: int = 512,
        positive_fraction: float = 0.25,
        proposal_append_gt: bool = True,
        dropout: float = 0.0,
        smooth_l1_beta: float = 0.0,
        box_reg_loss_type: str = "smooth_l1",
        reg_off: bool = False,
    ):
        super().__init__()
        if pooler_impl == "tiled":
            raise NotImplementedError(
                "POOLER_IMPL 'tiled' (an XLA slice-gather form) is not ported; "
                "use exact or a pallas* pool"
            )
        if pooler_impl not in _POOLER_IMPLS:
            raise ValueError(f"unknown POOLER_IMPL {pooler_impl!r}")
        self.in_features = tuple(in_features)
        self.strides = tuple(strides[f] for f in self.in_features)
        self.num_classes = num_classes
        self.pooler_impl = pooler_impl
        self.pooler_resolution = pooler_resolution
        self.pooler_sampling_ratio = pooler_sampling_ratio
        self.pooler_max_grid = pooler_max_grid
        self.canonical_box_size = canonical_box_size
        self.canonical_level = canonical_level
        self.box_head = FastRCNNConvFCHead(
            in_channels, pooler_resolution, num_conv, conv_dim, num_fc, fc_dim, head_norm, dropout
        )
        out_dim = fc_dim if num_fc else conv_dim * pooler_resolution ** 2
        self.box_predictor = FastRCNNOutputLayers(out_dim, num_classes, cls_agnostic_bbox_reg)
        self.box2box = Box2BoxTransform(bbox_reg_weights)
        self.proposal_matcher = Matcher(iou_thresholds, iou_labels, allow_low_quality_matches=False)
        self.pos_threshold = iou_thresholds[0]
        self.batch_size_per_image = batch_size_per_image
        self.positive_fraction = positive_fraction
        self.proposal_append_gt = proposal_append_gt
        self.smooth_l1_beta = smooth_l1_beta
        self.box_reg_loss_type = box_reg_loss_type
        self.reg_off = reg_off
        self.score_thresh = score_thresh_test
        self.nms_thresh = nms_thresh_test
        self.detections_per_image = detections_per_image
        self.pre_nms_candidates = pre_nms_candidates

    # ------------------------------------------------------------- sampling
    def label_and_sample_proposals(
        self,
        proposals: torch.Tensor,  # (B, P, 4)
        proposal_valid: torch.Tensor,  # (B, P)
        gt_boxes: torch.Tensor,  # (B, G, 4)
        gt_classes: torch.Tensor,  # (B, G)
        gt_valid: torch.Tensor,  # (B, G)
        gt_ignores: Optional[torch.Tensor] = None,  # (B, G)
        generator: Optional[torch.Generator] = None,
    ) -> SampledProposals:
        """Append gt, match (ignore gt never matches; a proposal over an
        ignore region above the fg threshold, or in an invalid slot, is never
        sampled), label fg with the gt class, bg with K and ignore with -1,
        then sample per image."""
        if self.proposal_append_gt:
            proposals = torch.cat([proposals, gt_boxes.to(proposals.dtype)], dim=1)
            proposal_valid = torch.cat([proposal_valid, gt_valid], dim=1)
        iou = box_ops.pairwise_iou(gt_boxes, proposals)  # (B, G, P)
        real = gt_valid if gt_ignores is None else gt_valid & ~gt_ignores
        matched_idx, labels = self.proposal_matcher(iou, real)
        minus = torch.full_like(labels, -1)
        if gt_ignores is not None:
            zero = torch.zeros((), device=iou.device)
            max_ig = torch.where((gt_valid & gt_ignores)[..., None], iou, zero).amax(1)
            labels = torch.where(max_ig > self.pos_threshold, minus, labels)
        labels = torch.where(proposal_valid, labels, minus)
        cls = torch.where(
            labels == 1,
            torch.gather(gt_classes.long(), 1, matched_idx),
            torch.where(labels == 0, self.num_classes, -1),
        )

        out = []
        for b in range(proposals.shape[0]):
            idxs, _, slot_valid = subsample_labels(
                labels[b], self.batch_size_per_image, self.positive_fraction, generator
            )
            gt_idx = matched_idx[b][idxs]
            out.append((
                proposals[b][idxs], gt_boxes[b][gt_idx],
                torch.where(slot_valid, cls[b][idxs], -1), slot_valid, gt_idx,
            ))
        return SampledProposals(*(torch.stack(t) for t in zip(*out)))

    # --------------------------------------------------------------- pooling
    def pool(self, features: Dict[str, torch.Tensor], boxes: torch.Tensor) -> torch.Tensor:
        """features: per-level (B, C, H, W) in channels_last memory; boxes
        (B, R, 4) -> (B, R, P, P, C) in the feature dtype.

        In eval mode: pallas_fast / pallas_band -> the band kernel (K1); auto
        / pallas on CUDA -> the paired kernel (K2), as "auto -> pallas on the
        accelerator" in JAX; auto off CUDA and exact -> the torch point
        gather. In training mode: auto -> pallas_train on CUDA and exact off
        it; every other pallas* -> pallas_train. pallas_train and
        pallas_train_flat (either mode) -> the differentiable paired pool
        (K2 forward, K3 backward)."""
        # NCHW channels_last -> a contiguous (B, H, W, C) view, no copy
        feats = [features[f].permute(0, 2, 3, 1) for f in self.in_features]
        impl = self.pooler_impl
        on_cuda = feats[0].is_cuda
        if self.training:
            if impl == "auto":
                impl = "pallas_train" if on_cuda else "exact"
            elif impl.startswith("pallas") and not impl.startswith("pallas_train"):
                impl = "pallas_train"
        elif impl == "auto":
            impl = "pallas" if on_cuda else "exact"
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
        if impl in ("pallas_train", "pallas_train_flat"):
            return roi_align.pool_paired_train(feats, boxes, self.strides, **kwargs)
        return roi_align.batched_multilevel_roi_align(feats, boxes, self.strides, **kwargs)

    # --------------------------------------------------------------- forward
    def forward(
        self,
        features: Dict[str, torch.Tensor],
        proposals: torch.Tensor,  # (B, R, 4)
        proposal_valid: torch.Tensor,  # (B, R)
        image_sizes: torch.Tensor,  # (B, 2)
        gt: Optional[Dict[str, torch.Tensor]] = None,
        generator: Optional[torch.Generator] = None,
    ):
        """Detections, or in training mode with ``gt`` (boxes, classes, valid,
        optional ignores) the dict of ``loss_cls`` and ``loss_box_reg``."""
        if self.training and gt is not None:
            return self._losses(features, proposals, proposal_valid, gt, generator)
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

    def _losses(self, features, proposals, proposal_valid, gt, generator):
        sampled = self.label_and_sample_proposals(
            proposals, proposal_valid, gt["boxes"], gt["classes"], gt["valid"],
            gt.get("ignores"), generator,
        )
        B, S = sampled.gt_classes.shape
        pooled = self.pool(features, sampled.boxes)  # (B, S, P, P, C)
        x = self.box_head(pooled.reshape(B * S, *pooled.shape[2:]))
        scores, deltas = self.box_predictor(x)
        if self.reg_off:
            # REG_OFF (roi_heads.py:397-400): the regression branch is off
            deltas = deltas * 0.0
        return fast_rcnn_losses(
            scores, deltas, sampled.boxes.reshape(B * S, 4), sampled.gt_boxes.reshape(B * S, 4),
            sampled.gt_classes.reshape(B * S), sampled.valid.reshape(B * S), self.box2box,
            self.smooth_l1_beta, self.box_reg_loss_type,
        )
