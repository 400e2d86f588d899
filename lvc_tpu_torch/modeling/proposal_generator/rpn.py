"""Region Proposal Network, inference (PyTorch).

Counterpart of ``lvc_tpu/modeling/proposal_generator/rpn.py``
(StandardRPNHead:26, RPN.__call__:105, predict_proposals:234). Training
(anchor matching, sampling, losses) is not ported yet.

Proposal selection keeps the JAX package's fixed shapes: per level the top
``pre_nms_topk`` anchors, levels padded to a common length, NMS per level,
then the top ``post_nms_topk`` kept boxes of the image in padded slots with a
validity mask. Box decode, top-k and NMS run in float32 whatever the conv
dtype (``rpn.py:122-134``).

``MODEL.RPN.APPROX_TOPK`` selects ``jax.lax.approx_max_k`` in the JAX package,
a TPU serving approximation. The port maps it to the exact top-k.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from lvc_tpu_torch.modeling.anchors import AnchorGenerator
from lvc_tpu_torch.modeling.box_regression import Box2BoxTransform
from lvc_tpu_torch.modeling.layers import Conv2d
from lvc_tpu_torch.ops.nms import NEG_INF, masked_topk, nms_mask
from lvc_tpu_torch.structures import boxes as box_ops


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


class RPN(nn.Module):
    """Returns (proposals (B, K, 4), objectness (B, K), valid (B, K))."""

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
        self.pre_nms_topk = pre_nms_topk_test
        self.post_nms_topk = post_nms_topk_test
        self.nms_thresh = nms_thresh
        self.min_box_size = min_box_size

    def forward(self, features: Dict[str, torch.Tensor], image_sizes: torch.Tensor):
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
        return self.predict_proposals(anchors_lvl, logits, deltas, image_sizes)

    def predict_proposals(self, anchors_lvl, logits_lvl, deltas_lvl, image_sizes):
        B = logits_lvl[0].shape[0]
        k_max = min(self.pre_nms_topk, max(l.shape[1] for l in logits_lvl))
        sizes = image_sizes.to(torch.float32)
        lvl_boxes, lvl_scores, lvl_valid = [], [], []
        for anchors, logit, delta in zip(anchors_lvl, logits_lvl, deltas_lvl):
            k = min(self.pre_nms_topk, logit.shape[1])
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
        # per-level NMS, all images and levels in one call
        keep = nms_mask(boxes, scores, valid, self.nms_thresh) & valid
        boxes = boxes.reshape(B, -1, 4)
        scores = scores.reshape(B, -1)
        order, topk_valid = masked_topk(scores, keep.reshape(B, -1), self.post_nms_topk)
        boxes = torch.gather(boxes, 1, order[..., None].expand(order.shape + (4,)))
        return boxes, torch.gather(scores, 1, order), topk_valid
