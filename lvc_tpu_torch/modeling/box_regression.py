"""R-CNN box-to-box transforms (counterpart of
``lvc_tpu/modeling/box_regression.py:19-87``: get_deltas, apply_deltas;
``Box2BoxTransformRotated``, ``:90-146``), including the ``log(1000/16)``
clamp on dw/dh."""
from __future__ import annotations

import math
from typing import Sequence

import torch

SCALE_CLAMP = math.log(1000.0 / 16)


class Box2BoxTransform:
    """Box regression by (dx, dy, dw, dh) deltas."""

    def __init__(self, weights: Sequence[float], scale_clamp: float = SCALE_CLAMP):
        self.weights = tuple(float(w) for w in weights)
        self.scale_clamp = float(scale_clamp)

    def get_deltas(self, src_boxes: torch.Tensor, target_boxes: torch.Tensor) -> torch.Tensor:
        """(..., 4) deltas that take ``src_boxes`` to ``target_boxes``. Widths
        and heights <= 0 are replaced by 1 before the division and the log,
        so padded (all-zero) rows stay finite; callers mask them."""
        src_w = src_boxes[..., 2] - src_boxes[..., 0]
        src_h = src_boxes[..., 3] - src_boxes[..., 1]
        src_cx = src_boxes[..., 0] + 0.5 * src_w
        src_cy = src_boxes[..., 1] + 0.5 * src_h
        tgt_w = target_boxes[..., 2] - target_boxes[..., 0]
        tgt_h = target_boxes[..., 3] - target_boxes[..., 1]
        tgt_cx = target_boxes[..., 0] + 0.5 * tgt_w
        tgt_cy = target_boxes[..., 1] + 0.5 * tgt_h

        wx, wy, ww, wh = self.weights
        one = torch.ones((), dtype=src_w.dtype, device=src_w.device)
        safe_w = torch.where(src_w > 0, src_w, one)
        safe_h = torch.where(src_h > 0, src_h, one)
        dx = wx * (tgt_cx - src_cx) / safe_w
        dy = wy * (tgt_cy - src_cy) / safe_h
        dw = ww * torch.log(torch.where(tgt_w > 0, tgt_w, one) / safe_w)
        dh = wh * torch.log(torch.where(tgt_h > 0, tgt_h, one) / safe_h)
        return torch.stack([dx, dy, dw, dh], dim=-1)

    def apply_deltas(self, deltas: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
        """Apply (..., K*4) deltas to (..., 4) boxes -> (..., K*4) boxes."""
        boxes = boxes.to(deltas.dtype)
        widths = boxes[..., 2] - boxes[..., 0]
        heights = boxes[..., 3] - boxes[..., 1]
        ctr_x = boxes[..., 0] + 0.5 * widths
        ctr_y = boxes[..., 1] + 0.5 * heights

        # 0-dim device tensors: CUDA divides by a Python float as a multiply
        # by its reciprocal, up to 1 ulp off the IEEE quotient of XLA and CPU
        wx, wy, ww, wh = (deltas.new_full((), w) for w in self.weights)
        d = deltas.reshape(deltas.shape[:-1] + (-1, 4))
        dx = d[..., 0] / wx
        dy = d[..., 1] / wy
        dw = torch.clamp(d[..., 2] / ww, max=self.scale_clamp)
        dh = torch.clamp(d[..., 3] / wh, max=self.scale_clamp)

        pred_cx = dx * widths[..., None] + ctr_x[..., None]
        pred_cy = dy * heights[..., None] + ctr_y[..., None]
        pred_w = torch.exp(dw) * widths[..., None]
        pred_h = torch.exp(dh) * heights[..., None]
        out = torch.stack(
            [
                pred_cx - 0.5 * pred_w,
                pred_cy - 0.5 * pred_h,
                pred_cx + 0.5 * pred_w,
                pred_cy + 0.5 * pred_h,
            ],
            dim=-1,
        )
        return out.reshape(deltas.shape)


class Box2BoxTransformRotated:
    """Rotated-box regression by (dx, dy, dw, dh, da) deltas
    (``Box2BoxTransformRotated``, ``box_regression.py:90``): dx and dy are
    axis-aligned centre offsets over the source w and h, da the angle
    difference wrapped to [-180, 180) degrees, in radians times ``wa``."""

    def __init__(self, weights: Sequence[float], scale_clamp: float = SCALE_CLAMP):
        if len(weights) != 5:
            raise ValueError(f"rotated box weights {weights}: want 5")
        self.weights = tuple(float(w) for w in weights)
        self.scale_clamp = float(scale_clamp)

    def get_deltas(self, src_boxes: torch.Tensor, target_boxes: torch.Tensor) -> torch.Tensor:
        """(..., 5) XYWHA source and target -> (..., 5) deltas; a w or h <= 0
        is replaced by 1, so padded rows stay finite."""
        wx, wy, ww, wh, wa = self.weights
        one = torch.ones((), dtype=src_boxes.dtype, device=src_boxes.device)
        safe_w = torch.where(src_boxes[..., 2] > 0, src_boxes[..., 2], one)
        safe_h = torch.where(src_boxes[..., 3] > 0, src_boxes[..., 3], one)
        dx = wx * (target_boxes[..., 0] - src_boxes[..., 0]) / safe_w
        dy = wy * (target_boxes[..., 1] - src_boxes[..., 1]) / safe_h
        dw = ww * torch.log(torch.where(target_boxes[..., 2] > 0, target_boxes[..., 2], one) / safe_w)
        dh = wh * torch.log(torch.where(target_boxes[..., 3] > 0, target_boxes[..., 3], one) / safe_h)
        da = torch.remainder(target_boxes[..., 4] - src_boxes[..., 4] + 180.0, 360.0) - 180.0
        da = da * (math.pi / 180.0) * wa
        return torch.stack([dx, dy, dw, dh, da], dim=-1)

    def apply_deltas(self, deltas: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
        """(..., 5) deltas on (..., 5) boxes, one box a delta, dw and dh
        clamped at ``scale_clamp``, the angle wrapped to [-180, 180)."""
        boxes = boxes.to(deltas.dtype)
        wx, wy, ww, wh, wa = (deltas.new_full((), w) for w in self.weights)
        dx = deltas[..., 0] / wx
        dy = deltas[..., 1] / wy
        dw = torch.clamp(deltas[..., 2] / ww, max=self.scale_clamp)
        dh = torch.clamp(deltas[..., 3] / wh, max=self.scale_clamp)
        da = deltas[..., 4] / wa * (180.0 / math.pi)
        pred_a = torch.remainder(boxes[..., 4] + da + 180.0, 360.0) - 180.0
        return torch.stack([dx * boxes[..., 2] + boxes[..., 0], dy * boxes[..., 3] + boxes[..., 1],
                            torch.exp(dw) * boxes[..., 2], torch.exp(dh) * boxes[..., 3], pred_a], dim=-1)
