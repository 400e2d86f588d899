"""Box primitives as plain functions on ``(..., 4)`` XYXY tensors.

Counterpart of ``lvc_tpu/structures/boxes.py:45-131`` (area, clip, nonempty,
pairwise_iou, pairwise_ioa, matched_pairwise_iou, pairwise_giou), with the same formulas in the same operation order so the
NMS decisions made from these IoUs match the JAX package bit for bit.
``BoxMode`` is the dataset dicts' box encoding, converted in numpy.
"""
from __future__ import annotations

import enum

import numpy as np
import torch


class BoxMode(enum.IntEnum):
    """The reference's encoding (``lvc_tpu/structures/boxes.py:20``)."""

    XYXY_ABS = 0
    XYWH_ABS = 1
    XYXY_REL = 2
    XYWH_REL = 3
    XYWHA_ABS = 4

    @staticmethod
    def convert(box, from_mode: "BoxMode", to_mode: "BoxMode") -> np.ndarray:
        """Convert (..., 4) numpy boxes between XYXY_ABS and XYWH_ABS."""
        if from_mode == to_mode:
            return box
        box = np.asarray(box)
        if from_mode == BoxMode.XYWH_ABS and to_mode == BoxMode.XYXY_ABS:
            x, y, w, h = box[..., 0], box[..., 1], box[..., 2], box[..., 3]
            return np.stack([x, y, x + w, y + h], axis=-1)
        if from_mode == BoxMode.XYXY_ABS and to_mode == BoxMode.XYWH_ABS:
            x0, y0, x1, y1 = box[..., 0], box[..., 1], box[..., 2], box[..., 3]
            return np.stack([x0, y0, x1 - x0, y1 - y0], axis=-1)
        raise NotImplementedError(f"Conversion {from_mode} -> {to_mode} not supported")


def area(boxes: torch.Tensor) -> torch.Tensor:
    """Box areas."""
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def clip(boxes: torch.Tensor, height, width) -> torch.Tensor:
    """Clip boxes to ``[0, width] x [0, height]``. ``height``/``width`` are
    scalars or tensors broadcastable against ``boxes[..., 0]``."""
    height = torch.as_tensor(height, dtype=boxes.dtype, device=boxes.device)
    width = torch.as_tensor(width, dtype=boxes.dtype, device=boxes.device)
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    x0 = torch.minimum(torch.maximum(boxes[..., 0], zero), width)
    y0 = torch.minimum(torch.maximum(boxes[..., 1], zero), height)
    x1 = torch.minimum(torch.maximum(boxes[..., 2], zero), width)
    y1 = torch.minimum(torch.maximum(boxes[..., 3], zero), height)
    return torch.stack([x0, y0, x1, y1], dim=-1)


def nonempty(boxes: torch.Tensor, threshold: float = 0.0) -> torch.Tensor:
    """Mask of boxes with both sides > threshold."""
    widths = boxes[..., 2] - boxes[..., 0]
    heights = boxes[..., 3] - boxes[..., 1]
    return (widths > threshold) & (heights > threshold)


def pairwise_intersection(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """(..., N, M) intersection areas between two box sets."""
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    return wh[..., 0] * wh[..., 1]


def pairwise_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """(..., N, M) IoU; 0 where the intersection is 0 (covers empty and
    degenerate boxes)."""
    area1 = area(boxes1)
    area2 = area(boxes2)
    inter = pairwise_intersection(boxes1, boxes2)
    union = area1[..., :, None] + area2[..., None, :] - inter
    safe = torch.where(union > 0, union, torch.ones_like(union))
    return torch.where(inter > 0, inter / safe, torch.zeros_like(inter))


def pairwise_ioa(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """(..., N, M) intersection over the area of ``boxes2``; 0 where the
    intersection is 0 (``lvc_tpu/structures/boxes.py:88``). The RPN's
    ignore-region filter uses it."""
    area2 = area(boxes2)
    inter = pairwise_intersection(boxes1, boxes2)
    safe = torch.where(area2 > 0, area2, torch.ones_like(area2))[..., None, :]
    return torch.where(inter > 0, inter / safe, torch.zeros_like(inter))


def _matched_overlap(boxes1: torch.Tensor, boxes2: torch.Tensor):
    """Intersection and union of aligned box lists."""
    lt = torch.maximum(boxes1[..., :2], boxes2[..., :2])
    rb = torch.minimum(boxes1[..., 2:], boxes2[..., 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    return inter, area(boxes1) + area(boxes2) - inter


def matched_pairwise_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Elementwise IoU of aligned (..., 4) box lists; 0 where the
    intersection is 0 (``lvc_tpu/structures/boxes.py:98``)."""
    inter, union = _matched_overlap(boxes1, boxes2)
    safe = torch.where(union > 0, union, torch.ones_like(union))
    return torch.where(inter > 0, inter / safe, torch.zeros_like(inter))


def pairwise_giou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Elementwise generalized IoU of aligned (..., 4) box lists
    (``lvc_tpu/structures/boxes.py:111``): a union or an enclosing area that
    is not positive divides by 1."""
    inter, union = _matched_overlap(boxes1, boxes2)
    iou = inter / torch.where(union > 0, union, torch.ones_like(union))
    lt_c = torch.minimum(boxes1[..., :2], boxes2[..., :2])
    rb_c = torch.maximum(boxes1[..., 2:], boxes2[..., 2:])
    wh_c = (rb_c - lt_c).clamp(min=0)
    area_c = wh_c[..., 0] * wh_c[..., 1]
    return iou - (area_c - union) / torch.where(area_c > 0, area_c, torch.ones_like(area_c))
