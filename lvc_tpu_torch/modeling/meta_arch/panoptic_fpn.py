"""Panoptic FPN (counterpart of ``lvc_tpu/modeling/meta_arch/panoptic_fpn.py``:
PanopticFPN:21, combine_semantic_and_instance_outputs:76).

A ``GeneralizedRCNN`` instance branch (the RPN and the ROI heads, with the
mask head under ``MODEL.MASK_ON``) and a ``SemSegFPNHead`` stuff branch over
one FPN. The semantic head runs before the RPN, as in JAX. In training mode
with gt in the batch it returns ``loss_sem_seg`` and the instance losses
times ``instance_loss_weight``; the batch adds ``sem_seg`` (B, H, W), and
``gt_masks`` reach the ROI heads when the batch has them (neither the gt
ignore flags nor keypoints do, as in JAX). In eval mode it returns
``{"instances": Detections, "sem_seg": logits}`` (NCHW float32 logits on the
canvas).

``combine_semantic_and_instance_outputs`` is the panoptic fusion on the host,
a numpy copy of JAX's: instances by descending score above a confidence
threshold claim their unclaimed pixels unless more than ``overlap_threshold``
of them is taken, then each stuff class of the semantic argmax (0 is the
things' placeholder) takes its unclaimed pixels when they reach
``stuff_area_limit``.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from lvc_tpu_torch.modeling.meta_arch.rcnn import GeneralizedRCNN
from lvc_tpu_torch.modeling.meta_arch.semantic_seg import SemSegFPNHead
from lvc_tpu_torch.utils.tracing import span


class PanopticFPN(GeneralizedRCNN):
    """backbone -> {``SemSegFPNHead``, RPN -> ROI heads}."""

    def __init__(self, backbone, proposal_generator, roi_heads, sem_seg_head: SemSegFPNHead,
                 instance_loss_weight: float = 1.0, **kwargs):
        super().__init__(backbone, proposal_generator, roi_heads, **kwargs)
        self.sem_seg_head = sem_seg_head
        self.instance_loss_weight = instance_loss_weight

    def forward(self, batch: Dict, generator=None):
        if self.training and "gt_boxes" in batch:
            return self._panoptic_losses(batch, generator)
        with torch.no_grad():
            features = self.backbone(self.model_images(batch))
            sem_logits = self.sem_seg_head(features)
            image_sizes = self._as_tensor(batch["image_size"])
            proposals, _, prop_valid, _ = self._propose(batch, features, image_sizes)
            return {"instances": self.roi_heads(features, proposals, prop_valid, image_sizes),
                    "sem_seg": sem_logits}

    def _panoptic_losses(self, batch: Dict, generator) -> Dict[str, torch.Tensor]:
        with span("backbone"):
            features = self.backbone(self.model_images(batch))
        with span("sem_seg_head"):
            losses = self.sem_seg_head.losses(self.sem_seg_head(features), self._as_tensor(batch["sem_seg"]))
        image_sizes = self._as_tensor(batch["image_size"])
        gt = self._gt(batch, ignores=False)
        if "gt_masks" in batch:
            gt["masks"] = self._as_tensor(batch["gt_masks"])
        with span("rpn"):
            proposals, _, prop_valid, rpn_losses = self._propose(batch, features, image_sizes, gt, generator)
        with span("roi_heads"):
            out = self.roi_heads(features, proposals, prop_valid, image_sizes, gt, generator)
        losses.update({k: v * self.instance_loss_weight for k, v in {**out, **rpn_losses}.items()})
        return losses


def combine_semantic_and_instance_outputs(
    boxes: np.ndarray,
    scores: np.ndarray,
    classes: np.ndarray,
    valid: np.ndarray,
    masks: np.ndarray,
    semantic_logits: np.ndarray,
    overlap_threshold: float = 0.5,
    stuff_area_limit: int = 4096,
    instances_confidence_threshold: float = 0.5,
):
    """One image's panoptic segmentation.

    Args:
        masks: (D, H, W) bool instance masks pasted at the image's size.
        semantic_logits: (H, W, C_stuff), the semantic head's logits moved
            to NHWC (``logits[i].permute(1, 2, 0)``).
    Returns:
        ``panoptic_seg`` (H, W) int32 segment ids (0 = unassigned) and the
        segment-info dicts (``id``, ``isthing``, ``category_id``, and
        ``score``/``instance_id`` for things, ``area`` for stuff).
    """
    H, W = semantic_logits.shape[:2]
    panoptic = np.zeros((H, W), np.int32)
    segments = []
    current_id = 0

    for i in np.argsort(-scores):
        if not valid[i] or scores[i] < instances_confidence_threshold:
            continue
        mask = masks[i].astype(bool)
        area = int(mask.sum())
        if area == 0:
            continue
        intersect = int((mask & (panoptic > 0)).sum())
        if intersect * 1.0 / area > overlap_threshold:
            continue
        if intersect > 0:
            mask = mask & (panoptic == 0)
        current_id += 1
        panoptic[mask] = current_id
        segments.append({"id": current_id, "isthing": True, "score": float(scores[i]),
                         "category_id": int(classes[i]), "instance_id": int(i)})

    semantic = np.argmax(semantic_logits, axis=-1)
    for cat in np.unique(semantic):
        if cat == 0:  # the things' placeholder in detectron2's stuff maps
            continue
        mask = (semantic == cat) & (panoptic == 0)
        if int(mask.sum()) < stuff_area_limit:
            continue
        current_id += 1
        panoptic[mask] = current_id
        segments.append({"id": current_id, "isthing": False, "category_id": int(cat), "area": int(mask.sum())})
    return panoptic, segments
