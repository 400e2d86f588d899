"""Fast R-CNN output layers and fixed-shape inference.

Counterpart of ``lvc_tpu/modeling/roi_heads/fast_rcnn.py``
(FastRCNNOutputLayers:24, fast_rcnn_losses:123-173, Detections:181,
fast_rcnn_inference:198-261). The whole batch is processed at once on padded
(B, R, ...) slots with validity masks.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from lvc_tpu_torch.modeling.box_regression import Box2BoxTransform
from lvc_tpu_torch.modeling.proposal_generator.rpn import smooth_l1
from lvc_tpu_torch.modeling.sampling import global_ratio
from lvc_tpu_torch.ops.nms import batched_nms_mask, masked_topk
from lvc_tpu_torch.structures import boxes as box_ops


class FastRCNNOutputLayers(nn.Module):
    """Linear classifier (K+1) + box regressor (4K, or 4 class-agnostic). The
    linears run in the input dtype and hand float32 to decode and softmax."""

    def __init__(self, in_features: int, num_classes: int, cls_agnostic_bbox_reg: bool = False):
        super().__init__()
        self.cls_score = nn.Linear(in_features, num_classes + 1)
        self.bbox_pred = nn.Linear(in_features, (1 if cls_agnostic_bbox_reg else num_classes) * 4)

    def forward(self, x: torch.Tensor):
        x = x.reshape(x.shape[0], -1)
        scores = F.linear(x, self.cls_score.weight.to(x.dtype), self.cls_score.bias.to(x.dtype))
        deltas = F.linear(x, self.bbox_pred.weight.to(x.dtype), self.bbox_pred.bias.to(x.dtype))
        return scores.float(), deltas.float()


def fast_rcnn_losses(
    class_logits: torch.Tensor,  # (N, K+1)
    proposal_deltas: torch.Tensor,  # (N, K*4) or (N, 4)
    proposal_boxes: torch.Tensor,  # (N, 4)
    gt_boxes: torch.Tensor,  # (N, 4) matched gt per proposal
    gt_classes: torch.Tensor,  # (N,) in [0, K] (K = background), -1 = ignore
    valid: torch.Tensor,  # (N,) slot validity
    box2box: Box2BoxTransform,
    smooth_l1_beta: float = 0.0,
    box_reg_loss_type: str = "smooth_l1",
) -> Dict[str, torch.Tensor]:
    """Softmax CE as the mean over valid non-ignore slots; box regression as
    the sum over foreground slots divided by ALL valid slots (the reference's
    normalization). The loss math runs in float32."""
    if box_reg_loss_type == "giou":
        raise NotImplementedError(
            "BBOX_REG_LOSS_TYPE 'giou' (the UBBR heads) is not ported yet "
            "(ROADMAP.md queue 1, item 5: it comes with the LVC pipeline)"
        )
    if box_reg_loss_type != "smooth_l1":
        raise ValueError(box_reg_loss_type)
    num_classes = class_logits.shape[-1] - 1
    class_logits = class_logits.float()
    proposal_deltas = proposal_deltas.float()
    zero = torch.zeros((), device=class_logits.device)
    n_valid = valid.sum()

    ce_valid = valid & (gt_classes >= 0)
    safe_cls = gt_classes.clamp(0, num_classes).long()
    logp = F.log_softmax(class_logits, dim=-1)
    ce = -torch.gather(logp, 1, safe_cls[:, None])[:, 0]
    loss_cls = global_ratio(torch.where(ce_valid, ce, zero).sum(), ce_valid.sum())

    fg = ce_valid & (gt_classes < num_classes)
    box_dim = proposal_boxes.shape[-1]
    if proposal_deltas.shape[-1] == box_dim:
        pred_deltas = proposal_deltas
    else:
        d = proposal_deltas.reshape(proposal_deltas.shape[0], num_classes, box_dim)
        cls = gt_classes.clamp(0, num_classes - 1).long()
        pred_deltas = torch.gather(d, 1, cls[:, None, None].expand(-1, 1, box_dim))[:, 0]
    gt_deltas = box2box.get_deltas(proposal_boxes, gt_boxes)
    reg = smooth_l1(pred_deltas, gt_deltas, smooth_l1_beta).sum(-1)
    loss_box_reg = global_ratio(torch.where(fg, reg, zero).sum(), n_valid)
    return {"loss_cls": loss_cls, "loss_box_reg": loss_box_reg}


class Detections(NamedTuple):
    """Fixed-shape padded detections per image: check ``valid``."""

    boxes: torch.Tensor  # (B, D, 4)
    scores: torch.Tensor  # (B, D)
    classes: torch.Tensor  # (B, D) int64
    valid: torch.Tensor  # (B, D) bool
    proposal_idx: torch.Tensor  # (B, D) index into the input proposals


def fast_rcnn_inference(
    boxes: torch.Tensor,  # (B, R, K*4) or (B, R, 4)
    scores: torch.Tensor,  # (B, R, K+1) softmax probabilities
    image_sizes: torch.Tensor,  # (B, 2) true (h, w)
    proposal_valid: torch.Tensor,  # (B, R)
    score_thresh: float,
    nms_thresh: float,
    topk_per_image: int,
    pre_nms_candidates: int = 2048,
) -> Detections:
    """Score filter -> per-class NMS -> top-k, all fixed-shape. The static
    ``pre_nms_candidates`` cap on (box, class) pairs entering NMS is the one
    divergence from the reference, as in the JAX package."""
    B, r, k1 = scores.shape
    k = k1 - 1
    fg_scores = scores[..., :-1]
    num_reg = boxes.shape[-1] // 4
    sizes = image_sizes.to(boxes.dtype)
    boxes = box_ops.clip(
        boxes.reshape(B, r, num_reg, 4), sizes[:, 0, None, None], sizes[:, 1, None, None]
    )
    cand_valid = (fg_scores > score_thresh) & proposal_valid[..., None]
    flat_scores = fg_scores.reshape(B, -1)
    cand_idx, cand_ok = masked_topk(flat_scores, cand_valid.reshape(B, -1), min(pre_nms_candidates, r * k))
    prop_idx = torch.div(cand_idx, k, rounding_mode="floor")
    cls_idx = cand_idx % k
    reg_idx = torch.zeros_like(cls_idx) if num_reg == 1 else cls_idx
    flat_boxes = boxes.reshape(B, r * num_reg, 4)
    sel = (prop_idx * num_reg + reg_idx)[..., None].expand(-1, -1, 4)
    cand_boxes = torch.gather(flat_boxes, 1, sel)
    cand_scores = torch.gather(flat_scores, 1, cand_idx)

    keep = batched_nms_mask(cand_boxes, cand_scores, cls_idx, cand_ok, nms_thresh)
    order, det_valid = masked_topk(cand_scores, keep, topk_per_image)
    return Detections(
        boxes=torch.gather(cand_boxes, 1, order[..., None].expand(-1, -1, 4)),
        scores=torch.gather(cand_scores, 1, order),
        classes=torch.gather(cls_idx, 1, order),
        valid=det_valid,
        proposal_idx=torch.gather(prop_idx, 1, order),
    )
