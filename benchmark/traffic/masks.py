"""Device-resident batches of COCO-like images with instance bitmasks.

``images.make_pool``'s batches, each gt also given ``gt_masks`` (B, G, H, W)
bool at canvas resolution: a random simple polygon of ``vertices`` [lo, hi]
corners (a count uniform in the range, sorted uniform angles around the
box's centre, radii uniform in [0.35, 1]), scaled so that its bounding box is
the gt box (as a COCO box bounds its polygon), rasterised by the even-odd
rule at the pixel centres. The polygons come from the run's seed, so the
structure stays ``images.py``'s.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from benchmark.reference import boxes as bx
from benchmark.traffic.images import make_pool

RADIUS = (0.35, 1.0)


def polygon(rng: np.random.RandomState, box: np.ndarray, vertices) -> np.ndarray:
    """(k, 2) XY corners of a polygon whose bounding box is ``box``."""
    k = rng.randint(vertices[0], vertices[1] + 1)
    angle = np.sort(rng.uniform(0.0, 2 * np.pi, k))
    r = rng.uniform(*RADIUS, k)
    pts = np.stack([r * np.cos(angle), r * np.sin(angle)], 1)
    lo, hi = pts.min(0), pts.max(0)
    span = np.maximum(hi - lo, 1e-6)
    x0, y0, x1, y1 = (float(v) for v in box)
    return np.stack([x0 + (pts[:, 0] - lo[0]) / span[0] * (x1 - x0), y0 + (pts[:, 1] - lo[1]) / span[1] * (y1 - y0)], 1)


def rasterise(poly: np.ndarray, H: int, W: int, device) -> torch.Tensor:
    """(H, W) bool: the pixels whose centre lies inside ``poly`` (even-odd
    rule), looked for only inside its bounding box."""
    x0, y0 = (int(np.floor(v)) for v in poly.min(0))
    x1, y1 = (int(np.ceil(v)) for v in poly.max(0))
    x0, y0, x1, y1 = max(x0, 0), max(y0, 0), min(x1, W), min(y1, H)
    out = torch.zeros((H, W), dtype=torch.bool, device=device)
    if x1 <= x0 or y1 <= y0:
        return out
    py = torch.arange(y0, y1, device=device, dtype=torch.float64)[:, None] + 0.5
    px = torch.arange(x0, x1, device=device, dtype=torch.float64)[None, :] + 0.5
    inside = torch.zeros((y1 - y0, x1 - x0), dtype=torch.bool, device=device)
    for (xi, yi), (xj, yj) in zip(poly, np.roll(poly, -1, axis=0)):
        if yi == yj:
            continue
        cross = ((yi > py) != (yj > py)) & (px < (xj - xi) * (py - yi) / (yj - yi) + xi)
        inside ^= cross
    out[y0:y1, x0:x1] = inside
    return out


def make_mask_pool(traffic: Dict, cfg: Dict, seed: int, device) -> List[Dict[str, torch.Tensor]]:
    """``make_pool``'s batches with ``gt_masks``; invalid gt slots' masks
    are empty."""
    pool = make_pool(traffic, cfg, seed, device)
    rng = np.random.RandomState(bx.fold_in(seed, 5) % (2 ** 32))
    for batch in pool:
        B, H, W = batch["image"].shape[:3]
        boxes = batch["gt_boxes"].cpu().numpy()
        valid = batch["gt_valid"].cpu().numpy()
        masks = torch.zeros((B,) + tuple(valid.shape[1:]) + (H, W), dtype=torch.bool, device=device)
        for b, g in zip(*np.nonzero(valid)):
            masks[b, g] = rasterise(polygon(rng, boxes[b, g], traffic["vertices"]), H, W, device)
        batch["gt_masks"] = masks
    return pool
