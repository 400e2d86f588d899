"""Box primitives as plain functions on ``(..., 4)`` XYXY tensors.

Counterpart of ``lvc_tpu/structures/boxes.py:45-95`` (area, clip, nonempty,
pairwise_iou, pairwise_ioa), with the same formulas in the same operation order so the
NMS decisions made from these IoUs match the JAX package bit for bit.
"""
from __future__ import annotations

import torch


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
