"""RetinaNet (counterpart of ``lvc_tpu/modeling/meta_arch/retinanet.py``:
sigmoid_focal_loss:33, RetinaNetHead:47, RetinaNet:101, losses:180,
inference:223).

A single-stage detector over the FPN's p3-p7 (``LastLevelP6P7`` on top):
one shared tower of 3x3 convs + ReLU per branch across the levels, then
A*K class logits and A*4 box deltas a location. Module names are
detectron2's (``head.cls_subnet.{0,2,4,6}``, ``head.bbox_subnet.*``,
``head.cls_score``, ``head.bbox_pred``). The towers are 256 wide whatever
the FPN's width, as in JAX (its head never reads the input's channels).

Training labels the whole batch at once (JAX vmaps ``label_one``): every
anchor is matched to the padded gt with low-quality matches allowed, the
sigmoid focal loss is summed over every non-ignored anchor and class, the
box loss (smooth L1 of the deltas) over the foreground anchors, and both
are divided by the positive count through ``global_ratio`` (summed over
the data-parallel group before the clamp at 1, so N ranks equal one
process). JAX drops the reference's EMA normaliser (a mutable buffer) and
so does the port. No sampling happens: the step's generator is ignored.

Inference takes, per level and per image, the top ``topk_candidates_test``
(anchor, class) pairs whose sigmoid score exceeds ``score_thresh_test``
(``masked_topk``, ties to the lower index), decodes and clips them, pads
the levels to a common length with ``NEG_INF`` scores, then runs
class-aware NMS and keeps the best ``detections_per_image``: padded
``Detections`` whose ``proposal_idx`` is the slot in the merged candidate
list. The head's convolutions run in the compute dtype; its outputs, the
losses and the selection run in float32.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from lvc_tpu_torch.modeling.anchors import AnchorGenerator
from lvc_tpu_torch.modeling.box_regression import Box2BoxTransform
from lvc_tpu_torch.modeling.layers import Conv2d
from lvc_tpu_torch.modeling.matcher import Matcher
from lvc_tpu_torch.modeling.meta_arch.rcnn import GeneralizedRCNN
from lvc_tpu_torch.modeling.proposal_generator.rpn import smooth_l1
from lvc_tpu_torch.modeling.roi_heads.fast_rcnn import Detections
from lvc_tpu_torch.modeling.sampling import global_ratio
from lvc_tpu_torch.ops.nms import NEG_INF, batched_nms_mask, masked_topk
from lvc_tpu_torch.structures import boxes as box_ops
from lvc_tpu_torch.utils.tracing import span


def sigmoid_focal_loss(logits: torch.Tensor, targets: torch.Tensor, alpha: float, gamma: float) -> torch.Tensor:
    """fvcore's sigmoid focal loss, element-wise, with the stable BCE
    ``max(x, 0) - x t + log1p(exp(-|x|))``; ``alpha < 0`` leaves out the
    class weighting."""
    p = torch.sigmoid(logits)
    ce = logits.clamp(min=0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))
    p_t = p * targets + (1.0 - p) * (1.0 - targets)
    loss = ce * (1.0 - p_t) ** gamma
    if alpha >= 0:
        loss = (alpha * targets + (1.0 - alpha) * (1.0 - targets)) * loss
    return loss


class RetinaNetHead(nn.Module):
    """The shared towers and the two predictors. Initialised as JAX's module
    is: N(0, 0.01) weights, zero biases, and ``cls_score``'s bias
    ``-log((1 - p) / p)`` so that every score starts at the prior ``p``
    (``init_weights``; the trainer's ``he_init`` overwrites it, as JAX's
    ``materialize_variables`` does)."""

    def __init__(self, in_channels: int, num_classes: int, num_anchors: int, num_convs: int = 4,
                 conv_dim: int = 256, prior_prob: float = 0.01):
        super().__init__()
        self.prior_prob = prior_prob
        for name in ("cls_subnet", "bbox_subnet"):
            layers = []
            for i in range(num_convs):
                layers += [Conv2d(in_channels if i == 0 else conv_dim, conv_dim, kernel_size=3, padding=1), nn.ReLU()]
            self.add_module(name, nn.Sequential(*layers))
        width = conv_dim if num_convs else in_channels
        self.cls_score = Conv2d(width, num_anchors * num_classes, kernel_size=3, padding=1)
        self.bbox_pred = Conv2d(width, num_anchors * 4, kernel_size=3, padding=1)
        self.init_weights()

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator = None) -> "RetinaNetHead":
        for m in self.modules():
            if isinstance(m, Conv2d):
                m.weight.copy_(torch.randn(m.weight.shape, generator=generator, device=m.weight.device) * 0.01)
                m.bias.zero_()
        self.cls_score.bias.fill_(-math.log((1.0 - self.prior_prob) / self.prior_prob))
        return self

    def forward(self, features):
        return ([self.cls_score(self.cls_subnet(x)) for x in features],
                [self.bbox_pred(self.bbox_subnet(x)) for x in features])


class RetinaNet(GeneralizedRCNN):
    """backbone (FPN p3-p7) -> ``RetinaNetHead`` -> the losses
    ``loss_cls``/``loss_box_reg`` in training mode with gt in the batch, else
    padded ``Detections``. The batch contract is ``GeneralizedRCNN``'s."""

    def __init__(
        self,
        backbone,
        in_features: Sequence[str],
        strides: Dict[str, int],
        in_channels: int,
        num_classes: int = 80,
        anchor_sizes=(),
        anchor_aspect_ratios=((0.5, 1.0, 2.0),),
        anchor_offset: float = 0.0,
        num_convs: int = 4,
        prior_prob: float = 0.01,
        iou_thresholds=(0.4, 0.5),
        iou_labels=(0, -1, 1),
        focal_loss_alpha: float = 0.25,
        focal_loss_gamma: float = 2.0,
        smooth_l1_beta: float = 0.1,
        bbox_reg_weights=(1.0, 1.0, 1.0, 1.0),
        score_thresh_test: float = 0.05,
        topk_candidates_test: int = 1000,
        nms_thresh_test: float = 0.5,
        detections_per_image: int = 100,
        **kwargs,
    ):
        super().__init__(backbone, None, None, **kwargs)
        self.in_features = tuple(in_features)
        self.num_classes = num_classes
        self.anchor_generator = AnchorGenerator(
            anchor_sizes, anchor_aspect_ratios, [strides[f] for f in self.in_features], anchor_offset
        )
        num_anchors = self.anchor_generator.num_anchors
        if len(set(num_anchors)) != 1:
            raise ValueError("all levels must have the same number of anchors")
        self.head = RetinaNetHead(in_channels, num_classes, num_anchors[0], num_convs, prior_prob=prior_prob)
        self.box2box = Box2BoxTransform(bbox_reg_weights)
        self.matcher = Matcher(iou_thresholds, iou_labels, allow_low_quality_matches=True)
        self.focal_loss_alpha = focal_loss_alpha
        self.focal_loss_gamma = focal_loss_gamma
        self.smooth_l1_beta = smooth_l1_beta
        self.score_thresh_test = score_thresh_test
        self.topk_candidates_test = topk_candidates_test
        self.nms_thresh_test = nms_thresh_test
        self.detections_per_image = detections_per_image

    def head_outputs(self, features: Dict[str, torch.Tensor]):
        """(anchors per level (HWA, 4), logits per level (B, HWA, K) and
        deltas per level (B, HWA, 4), both float32). The NCHW outputs go to
        NHWC before the flatten, so the flat index is (y, x, anchor) with
        the class fastest, as JAX's NHWC reshape orders it."""
        feats = [features[f] for f in self.in_features]
        logits, deltas = self.head(feats)
        anchors = self.anchor_generator.grid_anchors([f.shape[2:4] for f in feats], feats[0].device)
        B, K = feats[0].shape[0], self.num_classes
        logits = [x.permute(0, 2, 3, 1).reshape(B, -1, K).float() for x in logits]
        deltas = [x.permute(0, 2, 3, 1).reshape(B, -1, 4).float() for x in deltas]
        return anchors, logits, deltas

    def forward(self, batch: Dict, generator=None):
        if self.training and "gt_boxes" in batch:
            with span("backbone"):
                features = self.backbone(self.model_images(batch))
            with span("head"):
                anchors, logits, deltas = self.head_outputs(features)
            gt = self._gt(batch, ignores=False)
            with span("losses"):
                return self.losses(anchors, logits, deltas, gt["boxes"], gt["classes"], gt["valid"])
        with torch.no_grad():
            features = self.backbone(self.model_images(batch))
            return self.inference(*self.head_outputs(features), self._as_tensor(batch["image_size"]))

    def label_anchors(self, anchors: torch.Tensor, gt_boxes, gt_classes, gt_valid):
        """(B, R) class labels (K = background, -1 = ignored) and (B, R, 4)
        matched gt boxes of every anchor of the batch."""
        iou = box_ops.pairwise_iou(gt_boxes, anchors)  # (B, G, R)
        matched_idx, match_labels = self.matcher(iou, gt_valid)
        matched_cls = torch.gather(gt_classes.long(), 1, matched_idx)
        cls = torch.where(match_labels == 1, matched_cls,
                          torch.where(match_labels == 0, self.num_classes, -1))
        matched = torch.gather(gt_boxes, 1, matched_idx[..., None].expand(-1, -1, 4))
        return cls, matched

    def losses(self, anchors_lvl, logits_lvl, deltas_lvl, gt_boxes, gt_classes, gt_valid) -> Dict[str, torch.Tensor]:
        anchors = torch.cat(anchors_lvl, dim=0)
        logits = torch.cat(logits_lvl, dim=1)  # (B, R, K)
        deltas = torch.cat(deltas_lvl, dim=1)  # (B, R, 4)
        cls_labels, matched_gt = self.label_anchors(anchors, gt_boxes, gt_classes, gt_valid)
        valid = cls_labels >= 0
        fg = valid & (cls_labels < self.num_classes)
        # the raw count: global_ratio sums it over the group first and clamps after
        num_pos = fg.sum().float()
        onehot = F.one_hot(cls_labels.clamp(0, self.num_classes - 1), self.num_classes).float() * fg[..., None]
        zero = torch.zeros((), device=logits.device)
        cls_loss = sigmoid_focal_loss(logits, onehot, self.focal_loss_alpha, self.focal_loss_gamma).sum(-1)
        gt_deltas = self.box2box.get_deltas(anchors.expand_as(deltas), matched_gt)
        reg = smooth_l1(deltas, gt_deltas, self.smooth_l1_beta).sum(-1)
        return {
            "loss_cls": global_ratio(torch.where(valid, cls_loss, zero).sum(), num_pos),
            "loss_box_reg": global_ratio(torch.where(fg, reg, zero).sum(), num_pos),
        }

    def inference(self, anchors_lvl, logits_lvl, deltas_lvl, image_sizes) -> Detections:
        K = self.num_classes
        B = logits_lvl[0].shape[0]
        k_max = min(self.topk_candidates_test, max(x.shape[1] * K for x in logits_lvl))
        sizes = image_sizes.to(torch.float32)
        lvl = {"boxes": [], "scores": [], "classes": [], "valid": []}
        for anchors, logit, delta in zip(anchors_lvl, logits_lvl, deltas_lvl):
            probs = torch.sigmoid(logit).reshape(B, -1)  # (B, HWA*K)
            k = min(self.topk_candidates_test, probs.shape[1])
            idx, idx_ok = masked_topk(probs, probs > self.score_thresh_test, k)
            anchor_idx = torch.div(idx, K, rounding_mode="floor")
            boxes = self.box2box.apply_deltas(torch.gather(delta, 1, anchor_idx[..., None].expand(-1, -1, 4)),
                                              anchors[anchor_idx])
            boxes = box_ops.clip(boxes, sizes[:, 0:1], sizes[:, 1:2])
            scores = torch.gather(probs, 1, idx)
            classes, pad = idx % K, k_max - k
            if pad > 0:
                boxes = F.pad(boxes, (0, 0, 0, pad))
                scores = F.pad(scores, (0, pad), value=NEG_INF)
                classes = F.pad(classes, (0, pad))
                idx_ok = F.pad(idx_ok, (0, pad))
            for key, t in zip(lvl, (boxes, scores, classes, idx_ok)):
                lvl[key].append(t)
        boxes, scores, classes, valid = (torch.cat(lvl[key], dim=1) for key in lvl)
        keep = batched_nms_mask(boxes, scores, classes, valid, self.nms_thresh_test)
        order, det_valid = masked_topk(scores, keep, self.detections_per_image)
        return Detections(
            boxes=torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4)),
            scores=torch.gather(scores, 1, order),
            classes=torch.gather(classes, 1, order),
            valid=det_valid,
            proposal_idx=order,
        )
