"""Cascade ROI heads: full Cascade R-CNN and the UBBR box corrector
(counterpart of ``lvc_tpu/modeling/roi_heads/cascade_rcnn.py``:
scale_gradient:38, RegOnlyOutput:43, ubbr_box_loss:51, CascadeROIHeads:69,
CascadeUBBRROIHeads:272, UBBRROIHeads:320).

Each stage pools its boxes, scales the pooled features' gradient by
1 / num_stages, runs its head and output layer, and decodes its deltas into
the next stage's boxes (clipped to the image and detached). Stage 0 takes
the base sampler's boxes and labels; every later stage re-labels its boxes
with its own matcher, without resampling. With ``BoxOnlyLayersCascade`` the
loss is ``1 - GIoU`` of the decoded boxes (the corrector); with
``FastRCNNOutputLayers`` it is the Fast R-CNN loss of each stage, and
inference averages the stages' softmax. Reg-only inference regresses the
candidate slots it is given and returns them aligned to those slots.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence

import torch
from torch import nn

from lvc_tpu_torch.modeling.box_regression import Box2BoxTransform
from lvc_tpu_torch.modeling.matcher import Matcher
from lvc_tpu_torch.modeling.roi_heads.box_head import FastRCNNConvFCHead
from lvc_tpu_torch.modeling.roi_heads.fast_rcnn import (
    BoxOnlyLayers,
    FastRCNNOutputLayers,
    fast_rcnn_inference,
    fast_rcnn_losses,
)
from lvc_tpu_torch.modeling.roi_heads.roi_heads import SampledProposals, StandardROIHeads
from lvc_tpu_torch.modeling.sampling import Generators, global_ratio
from lvc_tpu_torch.structures import boxes as box_ops


def scale_gradient(x: torch.Tensor, scale: float) -> torch.Tensor:
    """Forward ``x`` (up to an ulp, as in JAX, whose expression this is),
    gradient ``scale`` times the upstream one."""
    return x * scale + (x * (1.0 - scale)).detach()


class RegOnlyOutput(NamedTuple):
    """Corrected boxes aligned to the input candidate slots."""

    boxes: torch.Tensor  # (B, R, 4)
    classes: torch.Tensor  # (B, R)
    valid: torch.Tensor  # (B, R)


def ubbr_box_loss(pred_boxes, input_boxes, gt_boxes, fg, lambda_: float, iterate: bool) -> torch.Tensor:
    """Mean over foreground rows of ``1 - GIoU(pred, gt)``, or with
    ``iterate`` of ``max(loss_after - lambda * loss_before, 0)``."""
    loss = 1.0 - box_ops.pairwise_giou(pred_boxes, gt_boxes)
    if iterate:
        loss = torch.clamp(loss - lambda_ * (1.0 - box_ops.pairwise_giou(input_boxes, gt_boxes)), min=0.0)
    zero = torch.zeros((), dtype=loss.dtype, device=loss.device)
    return global_ratio(torch.where(fg, loss, zero).sum(), fg.sum())


def _clip_to_images(boxes: torch.Tensor, image_sizes: torch.Tensor) -> torch.Tensor:
    sizes = image_sizes.to(boxes.dtype)
    return box_ops.clip(boxes, sizes[:, 0, None], sizes[:, 1, None])


class CascadeROIHeads(StandardROIHeads):
    """Per-stage heads, output layers, box transforms and matchers
    (``box_head.{k}``, ``box_predictor.{k}``), from the stage options
    ``cascade_ious``, ``cascade_bbox_reg_weights``, ``ubbr_lambda`` and
    ``output_layer``."""

    def _build_box_heads(
        self,
        cls_agnostic_bbox_reg: bool,
        cascade_ious: Sequence[float] = (0.5, 0.6, 0.7),
        cascade_bbox_reg_weights: Sequence[Sequence[float]] = (
            (10.0, 10.0, 5.0, 5.0), (20.0, 20.0, 10.0, 10.0), (30.0, 30.0, 15.0, 15.0),
        ),
        ubbr_lambda: float = 0.6,
        output_layer: str = "FastRCNNOutputLayers",
    ) -> None:
        self.ubbr_lambda = ubbr_lambda
        self.reg_only = output_layer == "BoxOnlyLayersCascade"
        n = len(cascade_ious)
        self.box_head = nn.ModuleList([FastRCNNConvFCHead(*self.head_args) for _ in range(n)])
        if self.reg_only:
            self.box_predictor = nn.ModuleList([BoxOnlyLayers(self.head_dim) for _ in range(n)])
        else:
            self.box_predictor = nn.ModuleList([
                FastRCNNOutputLayers(self.head_dim, self.num_classes, cls_agnostic_bbox_reg=True) for _ in range(n)
            ])
        self.stage_transforms = [Box2BoxTransform(w) for w in cascade_bbox_reg_weights]
        self.stage_matchers = [Matcher([iou], [0, 1], allow_low_quality_matches=False) for iou in cascade_ious]
        # stage 0 samples with the base machinery, under the stage's own
        # threshold and weights
        self.proposal_matcher = self.stage_matchers[0]
        self.box2box = self.stage_transforms[0]

    @property
    def num_stages(self) -> int:
        return len(self.stage_matchers)

    def stage_modules(self, stage: int):
        return self.box_head[stage], self.box_predictor[stage]

    # ------------------------------------------------------------- helpers
    def _match_stage(self, stage: int, boxes, gt_boxes, gt_classes, gt_valid):
        """Re-label boxes against gt with the stage's matcher; no sampling."""
        matched_idx, labels = self.stage_matchers[stage](box_ops.pairwise_iou(gt_boxes, boxes), gt_valid)
        cls = torch.gather(gt_classes.long(), 1, matched_idx)
        cls = torch.where(labels == 1, cls, torch.full_like(cls, self.num_classes))
        return torch.gather(gt_boxes, 1, matched_idx[..., None].expand(-1, -1, 4)), cls

    def _run_stage(self, features, boxes, stage: int):
        pooled = self.pool(features, boxes)
        B, R = pooled.shape[:2]
        x = scale_gradient(pooled.reshape(B * R, *pooled.shape[2:]), 1.0 / self.num_stages)
        head, predictor = self.stage_modules(stage)
        return predictor(head(x))  # deltas, or (scores, deltas)

    def _stage_deltas(self, predictions):
        return predictions if self.reg_only else predictions[1]

    def _decode(self, stage: int, deltas, boxes, image_sizes):
        B, R = boxes.shape[:2]
        new_boxes = self.stage_transforms[stage].apply_deltas(deltas.reshape(B, R, 4), boxes)
        return _clip_to_images(new_boxes, image_sizes).detach()

    # ------------------------------------------------------------- forward
    def forward(
        self,
        features: Dict[str, torch.Tensor],
        proposals: torch.Tensor,
        proposal_valid: torch.Tensor,
        image_sizes: torch.Tensor,
        gt: Optional[Dict[str, torch.Tensor]] = None,
        generator: Generators = None,
        candidates_as_proposals: bool = False,
    ):
        """The per-stage losses in training mode with ``gt``; otherwise
        ``RegOnlyOutput`` (reg-only heads, or candidates as proposals) or
        ``Detections``."""
        if self.training and gt is not None:
            sampled = self.label_and_sample_proposals(
                proposals, proposal_valid, gt["boxes"], gt["classes"], gt["valid"],
                gt.get("ignores"), generator,
            )
            return self.cascade_losses(features, sampled, gt, image_sizes)
        if candidates_as_proposals or self.reg_only:
            return self._inference_reg_only(features, proposals, proposal_valid, image_sizes, gt)
        return self._inference_full(features, proposals, proposal_valid, image_sizes)

    def cascade_losses(self, features, sampled: SampledProposals, gt, image_sizes) -> Dict[str, torch.Tensor]:
        """The stage loop of training from the base sampler's output."""
        boxes, slot_valid = sampled.boxes, sampled.valid
        gt_b, cls = sampled.gt_boxes, sampled.gt_classes
        losses = {}
        for k in range(self.num_stages):
            if k > 0:
                gt_b, cls = self._match_stage(k, boxes, gt["boxes"], gt["classes"], gt["valid"])
            predictions = self._run_stage(features, boxes, k)
            losses.update(self._stage_losses(k, predictions, boxes, gt_b, cls, slot_valid))
            boxes = self._decode(k, self._stage_deltas(predictions), boxes, image_sizes)
        return losses

    def _stage_losses(self, stage, predictions, boxes, gt_b, cls, slot_valid):
        flat_boxes, flat_gt = boxes.reshape(-1, 4), gt_b.reshape(-1, 4)
        cls, valid = cls.reshape(-1), slot_valid.reshape(-1)
        deltas = self._stage_deltas(predictions)
        if self.reg_only:
            fg = valid & (cls >= 0) & (cls < self.num_classes)
            pred_boxes = self.stage_transforms[stage].apply_deltas(deltas, flat_boxes)
            loss = ubbr_box_loss(pred_boxes, flat_boxes, flat_gt, fg, self.ubbr_lambda, iterate=False)
            return {f"loss_box_reg_stage{stage}": loss}
        losses = fast_rcnn_losses(
            predictions[0], deltas, flat_boxes, flat_gt, cls, valid, self.stage_transforms[stage],
            self.smooth_l1_beta, self.box_reg_loss_type,
        )
        return {f"{k}_stage{stage}": v for k, v in losses.items()}

    def _inference_reg_only(self, features, candidates, cand_valid, image_sizes, gt):
        boxes = candidates
        for k in range(self.num_stages):
            boxes = self._decode(k, self._stage_deltas(self._run_stage(features, boxes, k)), boxes, image_sizes)
        classes = gt["classes"] if gt is not None else torch.zeros_like(cand_valid, dtype=torch.int32)
        valid = cand_valid & (classes >= 0) & (classes < self.num_classes)
        return RegOnlyOutput(boxes=boxes, classes=classes, valid=valid)

    def _inference_full(self, features, proposals, proposal_valid, image_sizes):
        boxes = proposals
        scores_sum = None
        for k in range(self.num_stages):
            scores, deltas = self._run_stage(features, boxes, k)
            p = torch.softmax(scores, dim=-1)
            scores_sum = p if scores_sum is None else scores_sum + p
            boxes = self._decode(k, deltas, boxes, image_sizes)
        B, R = proposals.shape[:2]
        # a 0-dim divisor: CUDA divides by a Python number as a multiply
        probs = (scores_sum / scores_sum.new_full((), self.num_stages)).reshape(B, R, -1)
        return fast_rcnn_inference(
            boxes, probs, image_sizes, proposal_valid, self.score_thresh, self.nms_thresh,
            self.detections_per_image, self.pre_nms_candidates,
        )


class CascadeUBBRROIHeads(CascadeROIHeads):
    """One shared head and ``BoxOnlyLayers`` (``box_head``,
    ``box_predictor``) iterated ``cascade_steps`` times with the base
    threshold and box transform, and the lambda-delta loss (stage options
    ``cascade_steps`` and ``ubbr_lambda``)."""

    def _build_box_heads(self, cls_agnostic_bbox_reg: bool, cascade_steps: int = 3, ubbr_lambda: float = 0.6) -> None:
        self.ubbr_lambda = ubbr_lambda
        self.reg_only = True
        self.box_head = FastRCNNConvFCHead(*self.head_args)
        self.box_predictor = BoxOnlyLayers(self.head_dim)
        self.stage_transforms = [self.box2box] * cascade_steps
        self.stage_matchers = [self.proposal_matcher] * cascade_steps

    def stage_modules(self, stage: int):
        return self.box_head, self.box_predictor

    def _stage_losses(self, stage, predictions, boxes, gt_b, cls, slot_valid):
        flat_boxes = boxes.reshape(-1, 4)
        cls, valid = cls.reshape(-1), slot_valid.reshape(-1)
        fg = valid & (cls >= 0) & (cls < self.num_classes)
        pred_boxes = self.stage_transforms[stage].apply_deltas(predictions, flat_boxes)
        loss = ubbr_box_loss(pred_boxes, flat_boxes, gt_b.reshape(-1, 4), fg, self.ubbr_lambda, iterate=True)
        return {f"loss_box_reg_step{stage}": loss}


class UBBRROIHeads(StandardROIHeads):
    """Single-step corrector: trains as ``StandardROIHeads``; inference
    regresses the candidate boxes once and returns them aligned to their
    slots."""

    def forward(self, features, proposals, proposal_valid, image_sizes, gt=None, generator=None,
                candidates_as_proposals: bool = False):
        if self.training and gt is not None:
            return super().forward(features, proposals, proposal_valid, image_sizes, gt, generator)
        pooled = self.pool(features, proposals)
        B, R = pooled.shape[:2]
        _, deltas = self.box_predictor(self.box_head(pooled.reshape(B * R, *pooled.shape[2:])))
        boxes = self.box2box.apply_deltas(deltas.reshape(B, R, -1)[..., :4], proposals)
        classes = gt["classes"] if gt is not None else torch.zeros_like(proposal_valid, dtype=torch.int32)
        return RegOnlyOutput(boxes=_clip_to_images(boxes, image_sizes), classes=classes, valid=proposal_valid)
