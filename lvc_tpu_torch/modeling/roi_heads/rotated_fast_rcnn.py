"""Rotated Fast R-CNN: ``RROIHeads`` and the fixed-shape rotated inference.

Counterpart of ``lvc_tpu/modeling/roi_heads/rotated_fast_rcnn.py``
(fast_rcnn_inference_rotated_single_image:33, fast_rcnn_inference_rotated:81,
RROIHeads:96). Boxes are XYWHA (degrees, counter-clockwise), regression is
5-dim (``Box2BoxTransformRotated``), the pool is the rotated RoIAlign on
each box's FPN level and the NMS the polygon-clip one; every shape is
static (padded slots and masks), the whole batch at once.

As in JAX, ``RROIHeads`` is built directly (no ``ROI_HEADS.NAME`` entry
names it), has no ignore regions, and its training step appends the gt
boxes, matches by rotated IoU, samples each image with the caller's
generators (``modeling/sampling.py``) and returns ``loss_cls`` and
``loss_box_reg``; evaluation returns ``Detections`` whose boxes are
(B, D, 5).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
from torch import nn

from lvc_tpu_torch.modeling.box_regression import Box2BoxTransformRotated
from lvc_tpu_torch.modeling.matcher import Matcher
from lvc_tpu_torch.modeling.roi_heads.box_head import FastRCNNConvFCHead
from lvc_tpu_torch.modeling.roi_heads.fast_rcnn import Detections, FastRCNNOutputLayers, fast_rcnn_losses
from lvc_tpu_torch.modeling.sampling import Generators, image_generator, subsample_labels
from lvc_tpu_torch.ops import roi_align
from lvc_tpu_torch.ops.nms import batched_nms_rotated_mask, masked_topk
from lvc_tpu_torch.structures import rotated_boxes as rbox_ops


def fast_rcnn_inference_rotated(
    boxes: torch.Tensor,  # (B, R, K*5) or (B, R, 5) XYWHA
    scores: torch.Tensor,  # (B, R, K+1) softmax probabilities
    image_sizes: torch.Tensor,  # (B, 2) true (h, w)
    proposal_valid: torch.Tensor,  # (B, R)
    score_thresh: float,
    nms_thresh: float,
    topk_per_image: int,
    pre_nms_candidates: int = 2048,
) -> Detections:
    """Clip the near-horizontal boxes, keep (box, class) pairs above
    ``score_thresh`` (the best ``pre_nms_candidates``), class-aware rotated
    NMS, then the top ``topk_per_image``."""
    B, r, k1 = scores.shape
    k = k1 - 1
    fg_scores = scores[..., :-1]
    num_reg = boxes.shape[-1] // 5
    sizes = image_sizes.to(boxes.dtype)
    boxes = rbox_ops.clip_rotated(boxes.reshape(B, r, num_reg, 5), sizes[:, 0, None, None], sizes[:, 1, None, None])
    cand_valid = (fg_scores > score_thresh) & proposal_valid[..., None]
    flat_scores = fg_scores.reshape(B, -1)
    cand_idx, cand_ok = masked_topk(flat_scores, cand_valid.reshape(B, -1), min(pre_nms_candidates, r * k))
    prop_idx = torch.div(cand_idx, k, rounding_mode="floor")
    cls_idx = cand_idx % k
    reg_idx = torch.zeros_like(cls_idx) if num_reg == 1 else cls_idx
    sel = (prop_idx * num_reg + reg_idx)[..., None].expand(-1, -1, 5)
    cand_boxes = torch.gather(boxes.reshape(B, r * num_reg, 5), 1, sel)
    cand_scores = torch.gather(flat_scores, 1, cand_idx)

    keep = batched_nms_rotated_mask(cand_boxes, cand_scores, cls_idx, cand_ok, nms_thresh)
    order, det_valid = masked_topk(cand_scores, keep, topk_per_image)
    return Detections(
        boxes=torch.gather(cand_boxes, 1, order[..., None].expand(-1, -1, 5)),
        scores=torch.gather(cand_scores, 1, order),
        classes=torch.gather(cls_idx, 1, order),
        valid=det_valid,
        proposal_idx=torch.gather(prop_idx, 1, order),
    )


class RROIHeads(nn.Module):
    """Rotated StandardROIHeads: rotated matching and sampling, the rotated
    pool on each box's level, the conv/fc head, a (K+1)-way classifier and
    a 5-dim regressor (class-specific: detectron2's RROIHeads forces it)."""

    def __init__(
        self,
        in_features: Sequence[str],
        strides: Dict[str, int],
        in_channels: int,
        num_classes: int = 80,
        iou_thresholds: Sequence[float] = (0.5,),
        iou_labels: Sequence[int] = (0, 1),
        batch_size_per_image: int = 512,
        positive_fraction: float = 0.25,
        proposal_append_gt: bool = True,
        pooler_resolution: int = 7,
        pooler_sampling_ratio: int = 0,
        canonical_box_size: int = 224,
        canonical_level: int = 4,
        num_conv: int = 0,
        conv_dim: int = 256,
        num_fc: int = 2,
        fc_dim: int = 1024,
        head_norm: str = "",
        cls_agnostic_bbox_reg: bool = False,
        bbox_reg_weights: Sequence[float] = (10.0, 10.0, 5.0, 5.0, 1.0),
        smooth_l1_beta: float = 0.0,
        score_thresh_test: float = 0.05,
        nms_thresh_test: float = 0.5,
        detections_per_image: int = 100,
        pre_nms_candidates: int = 2048,
    ):
        super().__init__()
        self.in_features = tuple(in_features)
        self.strides = tuple(strides[f] for f in self.in_features)
        self.num_classes = num_classes
        self.batch_size_per_image = batch_size_per_image
        self.positive_fraction = positive_fraction
        self.proposal_append_gt = proposal_append_gt
        self.pooler_resolution = pooler_resolution
        self.pooler_sampling_ratio = pooler_sampling_ratio
        self.canonical_box_size = canonical_box_size
        self.canonical_level = canonical_level
        self.cls_agnostic_bbox_reg = cls_agnostic_bbox_reg
        self.smooth_l1_beta = smooth_l1_beta
        self.score_thresh = score_thresh_test
        self.nms_thresh = nms_thresh_test
        self.detections_per_image = detections_per_image
        self.pre_nms_candidates = pre_nms_candidates
        self.box_head = FastRCNNConvFCHead(in_channels, pooler_resolution, num_conv, conv_dim, num_fc, fc_dim,
                                           head_norm)
        head_dim = fc_dim if num_fc else conv_dim * pooler_resolution ** 2
        self.box_predictor = FastRCNNOutputLayers(head_dim, num_classes, cls_agnostic_bbox_reg, box_dim=5)
        self.box2box = Box2BoxTransformRotated(bbox_reg_weights)
        self.proposal_matcher = Matcher(iou_thresholds, iou_labels, allow_low_quality_matches=False)

    def label_and_sample_proposals(self, proposals, proposal_valid, gt_boxes, gt_classes, gt_valid,
                                   generator: Generators = None):
        """(sampled boxes, their matched gt boxes, their classes in [0, K]
        or -1, slot validity), each (B, S, ...)."""
        if self.proposal_append_gt:
            proposals = torch.cat([proposals, gt_boxes.to(proposals.dtype)], dim=1)
            proposal_valid = torch.cat([proposal_valid, gt_valid], dim=1)
        iou = rbox_ops.pairwise_iou_rotated(gt_boxes.to(proposals.dtype), proposals)  # (B, G, P)
        matched_idx, labels = self.proposal_matcher(iou, gt_valid)
        labels = torch.where(proposal_valid, labels, torch.full_like(labels, -1))
        cls = torch.where(labels == 1, torch.gather(gt_classes.long(), 1, matched_idx),
                          torch.where(labels == 0, self.num_classes, -1))
        out = []
        for b in range(proposals.shape[0]):
            idxs, _, slot_valid = subsample_labels(labels[b], self.batch_size_per_image, self.positive_fraction,
                                                   image_generator(generator, b))
            out.append((proposals[b][idxs], gt_boxes[b][matched_idx[b][idxs]],
                        torch.where(slot_valid, cls[b][idxs], -1), slot_valid))
        return tuple(torch.stack(t) for t in zip(*out))

    def pool(self, features: Dict[str, torch.Tensor], boxes: torch.Tensor) -> torch.Tensor:
        """features: per-level (B, C, H, W); boxes (B, R, 5) -> (B, R, P, P,
        C): each box on the level the FPN rule gives its w*h."""
        feats = [features[f].permute(0, 2, 3, 1) for f in self.in_features]
        min_level = int(math.log2(self.strides[0]))
        zeros = torch.zeros_like(boxes[..., 0])
        proxy = torch.stack([zeros, zeros, boxes[..., 2], boxes[..., 3]], dim=-1)  # area w*h
        levels = roi_align.assign_boxes_to_levels(proxy, min_level, min_level + len(feats) - 1,
                                                  self.canonical_box_size, self.canonical_level)
        return roi_align.multilevel_roi_align_rotated(feats, boxes, self.strides, levels, self.pooler_resolution,
                                                      self.pooler_sampling_ratio)

    def forward(
        self,
        features: Dict[str, torch.Tensor],
        proposals: torch.Tensor,  # (B, P, 5)
        proposal_valid: torch.Tensor,  # (B, P)
        image_sizes: torch.Tensor,  # (B, 2)
        gt: Optional[Dict[str, torch.Tensor]] = None,
        generator: Generators = None,
    ):
        """Detections, or in training mode with ``gt`` (``boxes`` (B, G, 5),
        ``classes``, ``valid``) ``loss_cls`` and ``loss_box_reg``."""
        if self.training and gt is not None:
            boxes, gt_boxes, gt_classes, valid = self.label_and_sample_proposals(
                proposals, proposal_valid, gt["boxes"], gt["classes"], gt["valid"], generator)
            B, S = gt_classes.shape
            pooled = self.pool(features, boxes)
            scores, deltas = self.box_predictor(self.box_head(pooled.reshape((B * S,) + pooled.shape[2:])))
            return fast_rcnn_losses(scores, deltas, boxes.reshape(B * S, 5), gt_boxes.reshape(B * S, 5).to(
                boxes.dtype), gt_classes.reshape(B * S), valid.reshape(B * S), self.box2box, self.smooth_l1_beta)
        B, P = proposals.shape[:2]
        pooled = self.pool(features, proposals)
        scores, deltas = self.box_predictor(self.box_head(pooled.reshape((B * P,) + pooled.shape[2:])))
        probs = torch.softmax(scores, dim=-1).reshape(B, P, -1)
        num_reg = 1 if self.cls_agnostic_bbox_reg else self.num_classes
        boxes = self.box2box.apply_deltas(deltas.reshape(B, P, num_reg, 5), proposals[:, :, None, :])
        return fast_rcnn_inference_rotated(
            boxes.reshape(B, P, num_reg * 5), probs, image_sizes, proposal_valid, self.score_thresh,
            self.nms_thresh, self.detections_per_image, self.pre_nms_candidates,
        )
