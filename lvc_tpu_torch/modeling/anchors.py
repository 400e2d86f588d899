"""Anchor grids (counterpart of ``lvc_tpu/modeling/anchors.py``:
generate_cell_anchors:16, AnchorGenerator:32, generate_rotated_cell_anchors:79,
RotatedAnchorGenerator:97).

Anchors are a pure function of sizes, aspect ratios (and angles), strides and
grid shapes. They are computed in numpy float64 then cast to float32, exactly
as the JAX package does, and cached per grid shape and device; a call that
``torch.export`` traces computes them afresh and leaves the cache alone, so
that no traced tensor stays behind in it.
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

    def _shifts(self, h: int, w: int, stride: int) -> np.ndarray:
        """(h*w, 4) float64 offsets of the cell anchors, row-major over (y, x)."""
        shift_x = (np.arange(w) + self.offset) * stride
        shift_y = (np.arange(h) + self.offset) * stride
        sx, sy = np.meshgrid(shift_x, shift_y)
        return np.stack([sx.ravel(), sy.ravel(), sx.ravel(), sy.ravel()], axis=1)

    def grid_anchors(self, grid_sizes: Sequence[Sequence[int]], device) -> List[torch.Tensor]:
        """Per-level (H*W*A, D) float32 anchors, row-major over (y, x, anchor)."""
        key = (tuple(tuple(int(v) for v in g) for g in grid_sizes), str(device))
        if key in self._cache:
            return self._cache[key]
        out = []
        for (h, w), stride, cell in zip(grid_sizes, self.strides, self.cell_anchors):
            shifts = self._shifts(int(h), int(w), stride)
            anchors = (shifts[:, None, :] + cell[None, :, :]).reshape(-1, cell.shape[1])
            out.append(torch.from_numpy(anchors.astype(np.float32)).to(device))
        if not torch.compiler.is_compiling():
            self._cache[key] = out
        return out


def generate_rotated_cell_anchors(
    sizes: Sequence[float] = (32, 64, 128, 256, 512),
    aspect_ratios: Sequence[float] = (0.5, 1.0, 2.0),
    angles: Sequence[float] = (-90, -60, -30, 0, 30, 60, 90),
) -> np.ndarray:
    """(S*A*T, 5) XYWHA anchors centred at (0, 0): for each size and aspect
    ratio the area-preserving (w, h), then every angle (degrees)."""
    anchors = []
    for size in sizes:
        area = size ** 2.0
        for ar in aspect_ratios:
            w = np.sqrt(area / ar)
            h = ar * w
            anchors.extend([0.0, 0.0, w, h, a] for a in angles)
    return np.asarray(anchors, dtype=np.float32)


class RotatedAnchorGenerator(AnchorGenerator):
    """Per-level rotated (XYWHA) anchor grids; ``sizes``, ``aspect_ratios`` and
    ``angles`` hold one entry for all levels or one per level. Centres move
    with the grid; w, h and the angle stay."""

    def __init__(
        self,
        sizes: Sequence[Sequence[float]],
        aspect_ratios: Sequence[Sequence[float]],
        strides: Sequence[int],
        angles: Sequence[Sequence[float]] = ((-90, -60, -30, 0, 30, 60, 90),),
        offset: float = 0.0,
    ):
        super().__init__(sizes, aspect_ratios, strides, offset)
        num_levels = len(self.strides)
        params = [list(s) for s in sizes], [list(a) for a in aspect_ratios], [list(t) for t in angles]
        for p in params:
            if len(p) not in (1, num_levels):
                raise ValueError(f"{len(p)} anchor settings for {num_levels} levels")
        sizes, aspect_ratios, angles = (p * num_levels if len(p) == 1 else p for p in params)
        self.cell_anchors = [
            generate_rotated_cell_anchors(s, a, t) for s, a, t in zip(sizes, aspect_ratios, angles)
        ]

    def _shifts(self, h: int, w: int, stride: int) -> np.ndarray:
        shifts = super()._shifts(h, w, stride)
        zeros = np.zeros_like(shifts[:, :1])
        return np.concatenate([shifts[:, :2], zeros, zeros, zeros], axis=1)
