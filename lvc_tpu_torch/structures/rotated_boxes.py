"""Rotated-box primitives on ``(..., 5)`` XYWHA tensors.

Counterpart of ``lvc_tpu/structures/rotated_boxes.py`` (area_rotated:24,
normalize_angles:29, clip_rotated:38, nonempty_rotated:55, corners:60,
pairwise_intersection_rotated:147, pairwise_iou_rotated:165). A box is
``(cx, cy, w, h, angle)``, the angle in degrees counter-clockwise in image
coordinates (detectron2's convention).

The intersection of two boxes is computed for the whole (..., N, M) pair
grid at once, as JAX does: 24 candidate vertices a pair (16 edge-edge
intersections and the 2x4 corners inside the other box), masked, sorted by
angle about their centroid (stable sorts, as ``jnp.argsort``'s default) and
summed by the shoelace formula. Leading batch dimensions are independent
sets.
"""
from __future__ import annotations

import math

import torch


def area_rotated(boxes: torch.Tensor) -> torch.Tensor:
    return boxes[..., 2] * boxes[..., 3]


def normalize_angles(boxes: torch.Tensor, angle_bound: float = 180.0) -> torch.Tensor:
    """Angles into ``[-angle_bound, angle_bound)``."""
    a = torch.remainder(boxes[..., 4] + angle_bound, 2.0 * angle_bound) - angle_bound
    return torch.cat([boxes[..., :4], a[..., None]], dim=-1)


def clip_rotated(boxes: torch.Tensor, height, width, clip_angle_threshold: float = 1.0) -> torch.Tensor:
    """Clip the near-horizontal boxes (``|angle| <= threshold``) to the image
    through their XYXY form; leave the rotated ones alone."""
    cx, cy, w, h, a = boxes.unbind(-1)
    height = torch.as_tensor(height, dtype=boxes.dtype, device=boxes.device)
    width = torch.as_tensor(width, dtype=boxes.dtype, device=boxes.device)
    x0 = torch.minimum(torch.clamp(cx - w / 2.0, min=0), width)
    y0 = torch.minimum(torch.clamp(cy - h / 2.0, min=0), height)
    x1 = torch.minimum(torch.clamp(cx + w / 2.0, min=0), width)
    y1 = torch.minimum(torch.clamp(cy + h / 2.0, min=0), height)
    new = torch.stack([(x0 + x1) / 2.0, (y0 + y1) / 2.0, x1 - x0, y1 - y0, a], dim=-1)
    return torch.where((a.abs() <= clip_angle_threshold)[..., None], new, boxes)


def nonempty_rotated(boxes: torch.Tensor, threshold: float = 0.0) -> torch.Tensor:
    return (boxes[..., 2] > threshold) & (boxes[..., 3] > threshold)


def corners(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 4, 2) corner points, in ring order."""
    theta = boxes[..., 4] * (math.pi / 180.0)
    c, s = torch.cos(theta)[..., None], torch.sin(theta)[..., None]
    w2, h2 = boxes[..., 2] / 2.0, boxes[..., 3] / 2.0
    dx = torch.stack([-w2, w2, w2, -w2], dim=-1)
    dy = torch.stack([-h2, -h2, h2, h2], dim=-1)
    x = boxes[..., 0:1] + dx * c + dy * s
    y = boxes[..., 1:2] - dx * s + dy * c
    return torch.stack([x, y], dim=-1)


def _cross(o, a, b):
    return (a[..., 0] - o[..., 0]) * (b[..., 1] - o[..., 1]) - (a[..., 1] - o[..., 1]) * (b[..., 0] - o[..., 0])


def _points_in_quad(pts: torch.Tensor, quad: torch.Tensor) -> torch.Tensor:
    """pts (..., P, 2) inside the convex quad (..., 4, 2), edges included."""
    q0 = quad[..., None, :, :]
    q1 = torch.roll(quad, -1, dims=-2)[..., None, :, :]
    cr = _cross(q0, q1, pts[..., :, None, :])
    return (cr >= -1e-9).all(-1) | (cr <= 1e-9).all(-1)


def _segment_intersections(quad1: torch.Tensor, quad2: torch.Tensor):
    """The 16 edge-edge intersection points (..., 16, 2) and their validity."""
    p0 = quad1[..., :, None, :]
    p1 = torch.roll(quad1, -1, dims=-2)[..., :, None, :]
    q0 = quad2[..., None, :, :]
    q1 = torch.roll(quad2, -1, dims=-2)[..., None, :, :]
    d1 = p1 - p0
    d2 = q1 - q0
    denom = d1[..., 0] * d2[..., 1] - d1[..., 1] * d2[..., 0]
    ok = denom.abs() > 1e-12
    safe = torch.where(ok, denom, torch.ones_like(denom))
    diff = q0 - p0
    t = (diff[..., 0] * d2[..., 1] - diff[..., 1] * d2[..., 0]) / safe
    u = (diff[..., 0] * d1[..., 1] - diff[..., 1] * d1[..., 0]) / safe
    hit = ok & (t >= 0) & (t <= 1) & (u >= 0) & (u <= 1)
    pt = p0 + t[..., None] * d1
    return pt.reshape(pt.shape[:-3] + (16, 2)), hit.reshape(hit.shape[:-2] + (16,))


def _convex_polygon_area(pts: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Area of the convex polygon of the valid candidate vertices; the
    invalid slots become copies of the first vertex in angle order and add
    nothing."""
    big = 1e9
    num = valid.sum(-1, keepdim=True).clamp(min=1)
    zero = torch.zeros((), dtype=pts.dtype, device=pts.device)
    centroid = torch.where(valid[..., None], pts, zero).sum(-2, keepdim=True) / num[..., None]
    ang = torch.atan2(pts[..., 1] - centroid[..., 1], pts[..., 0] - centroid[..., 0])
    order = torch.sort(torch.where(valid, ang, torch.full_like(ang, big)), dim=-1, stable=True).indices
    anchor = torch.gather(pts, -2, order[..., :1, None].expand(order.shape[:-1] + (1, 2)))
    filled = torch.where(valid[..., None], pts, anchor)
    order = torch.sort(torch.where(valid, ang, torch.full_like(ang, -big)), dim=-1, stable=True).indices
    ring = torch.gather(filled, -2, order[..., None].expand(order.shape + (2,)))
    nxt = torch.roll(ring, -1, dims=-2)
    area2 = (ring[..., 0] * nxt[..., 1] - nxt[..., 0] * ring[..., 1]).sum(-1)
    return area2.abs() / 2.0


def pairwise_intersection_rotated(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """(..., N, M) intersection areas."""
    n, m = boxes1.shape[-2], boxes2.shape[-2]
    q1 = corners(boxes1)[..., :, None, :, :]
    q2 = corners(boxes2)[..., None, :, :, :]
    lead = torch.broadcast_shapes(q1.shape[:-4], q2.shape[:-4])
    q1 = q1.expand(lead + (n, m, 4, 2))
    q2 = q2.expand(lead + (n, m, 4, 2))
    ipts, ivalid = _segment_intersections(q1, q2)
    pts = torch.cat([ipts, q1, q2], dim=-2)
    valid = torch.cat([ivalid, _points_in_quad(q1, q2), _points_in_quad(q2, q1)], dim=-1)
    area = _convex_polygon_area(pts, valid)
    return torch.where(valid.sum(-1) >= 3, area, torch.zeros_like(area))


def pairwise_iou_rotated(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """(..., N, M) IoU; 0 where the boxes do not intersect."""
    inter = pairwise_intersection_rotated(boxes1, boxes2)
    union = area_rotated(boxes1)[..., :, None] + area_rotated(boxes2)[..., None, :] - inter
    safe = torch.where(union > 0, union, torch.ones_like(union))
    return torch.where(inter > 0, inter / safe, torch.zeros_like(inter))
