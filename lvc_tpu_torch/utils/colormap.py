"""Deterministic category colormap for visualization.

A copy of ``lvc_tpu/utils/colormap.py`` (the port keeps its own); counterpart
of detectron2/utils/colormap.py — a fixed palette of visually
distinct colors for drawing per-category boxes/masks. Generated
procedurally (golden-ratio hue walk at fixed saturation/value) instead of
a hard-coded table.
"""
from __future__ import annotations

import colorsys

import numpy as np

_GOLDEN = 0.61803398875


def colormap(rgb: bool = False, maximum: int = 255, n: int = 80) -> np.ndarray:
    """(n, 3) palette. ``rgb=False`` returns BGR like the reference."""
    out = []
    h = 0.15
    for i in range(n):
        h = (h + _GOLDEN) % 1.0
        s = 0.65 if i % 2 == 0 else 0.9
        v = 0.95 if i % 3 else 0.75
        r, g, b = colorsys.hsv_to_rgb(h, s, v)
        c = [r, g, b] if rgb else [b, g, r]
        out.append([x * maximum for x in c])
    arr = np.array(out, np.float32)
    return arr if maximum != 255 else arr.astype(np.uint8).astype(np.float32)


def random_color(rgb: bool = False, maximum: int = 255, seed: int | None = None) -> np.ndarray:
    rng = np.random.RandomState(seed)
    cmap = colormap(rgb=rgb, maximum=maximum)
    return cmap[rng.randint(len(cmap))]
