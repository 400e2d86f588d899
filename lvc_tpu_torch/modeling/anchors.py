"""Anchor grids (counterpart of ``lvc_tpu/modeling/anchors.py:16,32``).

Anchors are a pure function of sizes, aspect ratios, strides and grid shapes.
They are computed in numpy float64 then cast to float32, exactly as the JAX
package does, and cached per grid shape and device.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch


def generate_cell_anchors(
    sizes: Sequence[float] = (32, 64, 128, 256, 512),
    aspect_ratios: Sequence[float] = (0.5, 1.0, 2.0),
) -> np.ndarray:
    """(len(sizes)*len(aspect_ratios), 4) XYXY anchors centred at (0, 0),
    with the area-preserving aspect warp."""
    anchors = []
    for size in sizes:
        area = size ** 2.0
        for ar in aspect_ratios:
            w = np.sqrt(area / ar)
            h = ar * w
            anchors.append([-w / 2.0, -h / 2.0, w / 2.0, h / 2.0])
    return np.asarray(anchors, dtype=np.float32)


class AnchorGenerator:
    """Per-level anchor grids. ``sizes``/``aspect_ratios`` hold one entry for
    all levels or one entry per level."""

    def __init__(
        self,
        sizes: Sequence[Sequence[float]],
        aspect_ratios: Sequence[Sequence[float]],
        strides: Sequence[int],
        offset: float = 0.0,
    ):
        self.strides = list(strides)
        num_levels = len(strides)

        def broadcast(params):
            params = list(params)
            if len(params) == 1:
                return params * num_levels
            if len(params) != num_levels:
                raise ValueError(f"{len(params)} anchor settings for {num_levels} levels")
            return params

        sizes = broadcast([list(s) for s in sizes])
        aspect_ratios = broadcast([list(a) for a in aspect_ratios])
        self.cell_anchors = [generate_cell_anchors(s, a) for s, a in zip(sizes, aspect_ratios)]
        if not 0.0 <= offset < 1.0:
            raise ValueError(f"anchor offset {offset} outside [0, 1)")
        self.offset = offset
        self._cache: Dict[Tuple, List[torch.Tensor]] = {}

    @property
    def num_anchors(self) -> List[int]:
        return [len(c) for c in self.cell_anchors]

    def grid_anchors(self, grid_sizes: Sequence[Sequence[int]], device) -> List[torch.Tensor]:
        """Per-level (H*W*A, 4) float32 anchors, row-major over (y, x, anchor)."""
        key = (tuple(tuple(int(v) for v in g) for g in grid_sizes), str(device))
        if key not in self._cache:
            out = []
            for (h, w), stride, cell in zip(grid_sizes, self.strides, self.cell_anchors):
                shift_x = (np.arange(w) + self.offset) * stride
                shift_y = (np.arange(h) + self.offset) * stride
                sx, sy = np.meshgrid(shift_x, shift_y)
                shifts = np.stack([sx.ravel(), sy.ravel(), sx.ravel(), sy.ravel()], axis=1)
                anchors = (shifts[:, None, :] + cell[None, :, :]).reshape(-1, 4)
                out.append(torch.from_numpy(anchors.astype(np.float32)).to(device))
            self._cache[key] = out
        return self._cache[key]
