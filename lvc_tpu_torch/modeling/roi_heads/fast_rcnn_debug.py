"""Debug Fast R-CNN inference that keeps the top-2 class scores per box
(counterpart of ``lvc_tpu/modeling/roi_heads/fast_rcnn_debug.py``:
DetectionsDebug:26, fast_rcnn_inference_debug_single_image:36,
fast_rcnn_inference_debug:69).

``StandardROIHeads`` runs it in place of ``fast_rcnn_inference`` under
``cfg.DEBUG``: the same detections, plus the two highest foreground class
probabilities of each kept box's proposal and their class indices, gathered
at the same fixed slots.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from lvc_tpu_torch.modeling.roi_heads.fast_rcnn import fast_rcnn_inference


class DetectionsDebug(NamedTuple):
    """``Detections`` plus the top-2 foreground classes: check ``valid``."""

    boxes: torch.Tensor  # (B, D, 4)
    scores: torch.Tensor  # (B, D)
    classes: torch.Tensor  # (B, D) int64
    valid: torch.Tensor  # (B, D) bool
    proposal_idx: torch.Tensor  # (B, D)
    top2_scores: torch.Tensor  # (B, D, 2) the two highest class probabilities
    top2_inds: torch.Tensor  # (B, D, 2) int64, their class indices


def fast_rcnn_inference_debug(
    boxes: torch.Tensor,  # (B, R, K*4) or (B, R, 4)
    scores: torch.Tensor,  # (B, R, K+1) softmax probabilities
    image_sizes: torch.Tensor,  # (B, 2)
    proposal_valid: torch.Tensor,  # (B, R)
    score_thresh: float,
    nms_thresh: float,
    topk_per_image: int,
    pre_nms_candidates: int = 2048,
) -> DetectionsDebug:
    """``fast_rcnn_inference`` plus each detection's proposal's top-2
    foreground scores; equal scores keep the lower class first, as
    ``jax.lax.top_k`` does."""
    dets = fast_rcnn_inference(
        boxes, scores, image_sizes, proposal_valid, score_thresh, nms_thresh,
        topk_per_image, pre_nms_candidates,
    )
    fg = scores[..., :-1]
    fg = torch.gather(fg, 1, dets.proposal_idx[..., None].expand(-1, -1, fg.shape[-1]))  # (B, D, K)
    inds = torch.sort(fg, dim=-1, descending=True, stable=True).indices[..., :2]
    return DetectionsDebug(*dets[:5], top2_scores=torch.gather(fg, 2, inds), top2_inds=inds)
