"""R-CNN box-to-box transform (counterpart of
``lvc_tpu/modeling/box_regression.py:19,55``), including the
``log(1000/16)`` clamp on dw/dh."""
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
