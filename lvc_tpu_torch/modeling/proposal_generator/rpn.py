"""Region Proposal Network (PyTorch).

Counterpart of ``lvc_tpu/modeling/proposal_generator/rpn.py``
(StandardRPNHead:26, smooth_l1:48, RPN.__call__:105, losses:149,
predict_proposals:234). In training mode with gt in the call it also returns
the losses: anchors matched and sampled per image, only the sampled anchors'
logits and deltas gathered, the constant normalizer
``batch_size_per_image * B``, and with ``ignore_regions`` (``RPN_Ignore``)
anchors mostly inside an ignore region left out. The proposals stay
differentiable in the deltas, as in the JAX package.

Proposal selection keeps the JAX package's fixed shapes: per level the top
``pre_nms_topk`` anchors, levels padded to a common length, NMS per level,
then the top ``post_nms_topk`` kept boxes of the image in padded slots with a
validity mask. Box decode, top-k and NMS run in float32 whatever the conv
dtype (``rpn.py:122-134``).

``MODEL.RPN.APPROX_TOPK`` selects ``jax.lax.approx_max_k`` in the JAX package,
a TPU serving approximation. The port maps it to the exact top-k.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from lvc_tpu_torch.modeling.anchors import AnchorGenerator
from lvc_tpu_torch.modeling.box_regression import Box2BoxTransform
from lvc_tpu_torch.modeling.layers import Conv2d
from lvc_tpu_torch.modeling.matcher import Matcher
from lvc_tpu_torch.modeling.sampling import Generators, global_ratio, image_generator, subsample_labels
from lvc_tpu_torch.ops.nms import NEG_INF, masked_topk, nms_mask
from lvc_tpu_torch.structures import boxes as box_ops
from lvc_tpu_torch.utils.tracing import span


class StandardRPNHead(nn.Module):
    """3x3 conv + ReLU, then 1x1 objectness and 1x1 deltas."""

    def __init__(self, in_channels: int, num_anchors: int, conv_dim: int = 256):
        super().__init__()
        self.conv = Conv2d(in_channels, conv_dim, kernel_size=3, padding=1, activation=F.relu)
        self.objectness_logits = Conv2d(conv_dim, num_anchors, kernel_size=1)
        self.anchor_deltas = Conv2d(conv_dim, num_anchors * 4, kernel_size=1)

    def forward(self, features: List[torch.Tensor]):
        logits, deltas = [], []
        for x in features:
            t = self.conv(x)
            logits.append(self.objectness_logits(t))
            deltas.append(self.anchor_deltas(t))
        return logits, deltas


def smooth_l1(pred: torch.Tensor, target: torch.Tensor, beta: float) -> torch.Tensor:
    """fvcore smooth_l1_loss semantics: pure L1 when beta == 0."""
    diff = torch.abs(pred - target)
    if beta <= 1e-8:
        return diff
    return torch.where(diff < beta, 0.5 * diff * diff / beta, diff - 0.5 * beta)


class RPN(nn.Module):
    """Returns (proposals (B, K, 4), objectness (B, K), valid (B, K), losses);
    ``losses`` is empty unless training with gt."""

    def __init__(
        self,
        in_features: Sequence[str],
        strides: Dict[str, int],
        in_channels: int,
        anchor_sizes,
        anchor_aspect_ratios,
        anchor_offset: float = 0.0,
        bbox_reg_weights=(1.0, 1.0, 1.0, 1.0),
        pre_nms_topk_test: int = 1000,
        post_nms_topk_test: int = 1000,
        nms_thresh: float = 0.7,
        min_box_size: float = 0.0,
        head_conv_dim: int = 256,
        iou_thresholds=(0.3, 0.7),
        iou_labels=(0, -1, 1),
        batch_size_per_image: int = 256,
        positive_fraction: float = 0.5,
        smooth_l1_beta: float = 0.0,
        loss_weight: float = 1.0,
        pre_nms_topk_train: int = 2000,
        post_nms_topk_train: int = 1000,
        ignore_regions: bool = False,
    ):
        super().__init__()
        self.in_features = tuple(in_features)
        self.anchor_generator = AnchorGenerator(
            anchor_sizes, anchor_aspect_ratios,
            [strides[f] for f in self.in_features], anchor_offset,
        )
        num_anchors = self.anchor_generator.num_anchors
        if len(set(num_anchors)) != 1:
            raise ValueError("all levels must have the same number of anchors")
        self.rpn_head = StandardRPNHead(in_channels, num_anchors[0], head_conv_dim)
        self.box2box = Box2BoxTransform(bbox_reg_weights)
        self.pre_nms_topk_test = pre_nms_topk_test
        self.post_nms_topk_test = post_nms_topk_test
        self.pre_nms_topk_train = pre_nms_topk_train
        self.post_nms_topk_train = post_nms_topk_train
        self.nms_thresh = nms_thresh
        self.min_box_size = min_box_size
        self.matcher = Matcher(iou_thresholds, iou_labels, allow_low_quality_matches=True)
        self.batch_size_per_image = batch_size_per_image
        self.positive_fraction = positive_fraction
        self.smooth_l1_beta = smooth_l1_beta
        self.loss_weight = loss_weight
        self.ignore_regions = ignore_regions

    def forward(
        self,
        features: Dict[str, torch.Tensor],
        image_sizes: torch.Tensor,
        gt_boxes: Optional[torch.Tensor] = None,  # (B, G, 4)
        gt_valid: Optional[torch.Tensor] = None,  # (B, G)
        gt_ignores: Optional[torch.Tensor] = None,  # (B, G)
        generator: Generators = None,
    ):
        feats = [features[f] for f in self.in_features]
        logits_lvl, deltas_lvl = self.rpn_head(feats)
        anchors_lvl = self.anchor_generator.grid_anchors(
            [f.shape[2:4] for f in feats], feats[0].device
        )
        B = feats[0].shape[0]
        # NCHW head outputs go to NHWC before flattening, so the flat index
        # is (y, x, anchor) row-major and lines up with the anchors
        logits = [l.permute(0, 2, 3, 1).reshape(B, -1).float() for l in logits_lvl]
        deltas = [d.permute(0, 2, 3, 1).reshape(B, -1, 4) for d in deltas_lvl]
        losses = {}
        if self.training and gt_boxes is not None:
            losses = self.losses(anchors_lvl, logits, deltas, gt_boxes, gt_valid, gt_ignores, generator)
        return (*self.predict_proposals(anchors_lvl, logits, deltas, image_sizes), losses)

    def losses(self, anchors_lvl, logits_lvl, deltas_lvl, gt_boxes, gt_valid, gt_ignores=None,
               generator=None) -> Dict[str, torch.Tensor]:
        """Objectness BCE and box L1 over the sampled anchors only; deltas stay
        in the conv dtype until the sampled rows are gathered. The matching
        and sampling of every image run in the span ``rpn.match``."""
        anchors = torch.cat(anchors_lvl, dim=0)  # (R, 4)
        logits = torch.cat(logits_lvl, dim=1)  # (B, R) f32
        deltas = torch.cat(deltas_lvl, dim=1)  # (B, R, 4)
        B = logits.shape[0]
        if not self.ignore_regions:
            gt_ignores = None  # JAX zeroes them: the labels are those with no ignore rows
        with span("rpn.match"):
            sampled = [self._label_one(anchors, gt_boxes[b], gt_valid[b],
                                       None if gt_ignores is None else gt_ignores[b], image_generator(generator, b))
                       for b in range(B)]
            idxs, is_pos, slot_valid, s_anchors, s_gt = (torch.stack(t) for t in zip(*sampled))

        s_logits = torch.gather(logits, 1, idxs).float()  # (B, S)
        s_deltas = torch.gather(deltas, 1, idxs[..., None].expand(-1, -1, 4)).float()
        gt_deltas = self.box2box.get_deltas(s_anchors, s_gt)
        loc = smooth_l1(s_deltas, gt_deltas, self.smooth_l1_beta).sum(-1)
        zero = torch.zeros((), device=loc.device)
        localization_loss = torch.where(is_pos, loc, zero).sum()
        # BCE with logits over the sampled anchors
        lab = is_pos.float()
        bce = s_logits.clamp(min=0) - s_logits * lab + torch.log1p(torch.exp(-s_logits.abs()))
        objectness_loss = torch.where(slot_valid, bce, zero).sum()
        normalizer = self.batch_size_per_image * B
        return {
            "loss_rpn_cls": global_ratio(objectness_loss, normalizer) * self.loss_weight,
            "loss_rpn_loc": global_ratio(localization_loss, normalizer) * self.loss_weight,
        }

    def _label_one(self, anchors, gt_b, gt_v, gt_ig, generator):
        """Match, label and sample one image's anchors (``label_one``,
        ``rpn.py:172-199``): ignore rows never act as real matches, and an
        anchor whose intersection-over-anchor-area with an ignore region
        exceeds 0.5 is left out. With no ignore rows (``gt_ig`` None) the
        dense IoA is skipped: it could exclude nothing."""
        iou = box_ops.pairwise_iou(gt_b, anchors)  # (G, R)
        matched_idx, labels = self.matcher(iou, gt_v if gt_ig is None else gt_v & ~gt_ig)
        if gt_ig is not None:
            ioa = box_ops.pairwise_ioa(gt_b, anchors)
            max_ig = torch.where((gt_v & gt_ig)[:, None], ioa, torch.zeros((), device=ioa.device)).amax(0)
            labels = torch.where(max_ig > 0.5, torch.full_like(labels, -1), labels)
        idxs, is_pos, slot_valid = subsample_labels(
            labels, self.batch_size_per_image, self.positive_fraction, generator
        )
        return idxs, is_pos, slot_valid, anchors[idxs], gt_b[matched_idx[idxs]]

    def predict_proposals(self, anchors_lvl, logits_lvl, deltas_lvl, image_sizes):
        """Per-level top-k, decode, clip, per-level NMS, top-k of the image;
        the ``*_TRAIN`` sizes in training mode. The selection runs in the
        span ``rpn.select``, the NMS and the image's top-k in ``rpn.nms``."""
        pre_nms_topk = self.pre_nms_topk_train if self.training else self.pre_nms_topk_test
        post_nms_topk = self.post_nms_topk_train if self.training else self.post_nms_topk_test
        B = logits_lvl[0].shape[0]
        k_max = min(pre_nms_topk, max(l.shape[1] for l in logits_lvl))
        sizes = image_sizes.to(torch.float32)
        lvl_boxes, lvl_scores, lvl_valid = [], [], []
        with span("rpn.select"):
            for anchors, logit, delta in zip(anchors_lvl, logits_lvl, deltas_lvl):
                k = min(pre_nms_topk, logit.shape[1])
                # exact top-k with ties toward the lower index (stable sort)
                order = torch.sort(logit, dim=1, descending=True, stable=True).indices[:, :k]
                scores = torch.gather(logit, 1, order)
                d_k = torch.gather(delta, 1, order[..., None].expand(B, k, 4)).float()
                boxes = self.box2box.apply_deltas(d_k, anchors[order])
                boxes = box_ops.clip(boxes, sizes[:, 0:1], sizes[:, 1:2])
                valid = box_ops.nonempty(boxes, self.min_box_size) & torch.isfinite(scores)
                pad = k_max - k
                if pad > 0:
                    boxes = F.pad(boxes, (0, 0, 0, pad))
                    scores = F.pad(scores, (0, pad), value=NEG_INF)
                    valid = F.pad(valid, (0, pad))
                lvl_boxes.append(boxes)
                lvl_scores.append(scores)
                lvl_valid.append(valid)

            boxes = torch.stack(lvl_boxes, dim=1)  # (B, L, K, 4)
            scores = torch.stack(lvl_scores, dim=1)
            valid = torch.stack(lvl_valid, dim=1)
        with span("rpn.nms"):
            # per-level NMS, all images and levels in one call
            keep = nms_mask(boxes, scores, valid, self.nms_thresh) & valid
            boxes = boxes.reshape(B, -1, 4)
            scores = scores.reshape(B, -1)
            order, topk_valid = masked_topk(scores, keep.reshape(B, -1), post_nms_topk)
            boxes = torch.gather(boxes, 1, order[..., None].expand(order.shape + (4,)))
            return boxes, torch.gather(scores, 1, order), topk_valid
