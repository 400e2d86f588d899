"""Device-resident batches of COCO-like images.

Parameters (the cell file's ``traffic``, over those of the mix it names,
``benchmark/traffic/<mix>.json``: ``coco.json`` holds the photo sizes and
the boxes that every COCO-like cell shares):

- ``batch``: images a batch; ``pool``: distinct batches, cycled by the run;
- ``canvases``: the pool's canvas per batch, as indices into the
  configuration's PAD.CANVAS_BUCKETS, in pool order (a fixed pattern, so
  the share of each canvas is the same in every run);
- ``photos``: [h, w, weight] of the source photos; a batch takes photos
  whose resized size picks its canvas;
- ``min_sizes``: the shortest-edge choices (training: MIN_SIZE_TRAIN;
  inference: [MIN_SIZE_TEST]), with the configuration's maximum size;
- ``boxes``: the gt count a photo, a lognormal [mu, sigma] cut to
  [lo, hi], and COCO's area mix in source pixels: [[min side, max side,
  share], ...] (small, medium, large).

The structure (photo sizes, resize choices, box counts) is drawn once from
``structure_seed`` and only its order changes with the run's seed; the
pixels, box places and shapes and classes are drawn from the run's seed,
the pixels on the device by one ``torch.Generator``.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch


def resized(h: int, w: int, short: int, max_size: int) -> Tuple[int, int]:
    """detectron2's ResizeShortestEdge output size (the +0.5 rounding)."""
    scale = short * 1.0 / min(h, w)
    newh, neww = (short, scale * w) if h < w else (scale * h, short)
    if max(newh, neww) > max_size:
        s2 = max_size * 1.0 / max(newh, neww)
        newh, neww = newh * s2, neww * s2
    return int(newh + 0.5), int(neww + 0.5)


def pick_canvas(h: int, w: int, buckets: Sequence[Sequence[int]]) -> int:
    for i, (bh, bw) in enumerate(buckets):
        if h <= bh and w <= bw:
            return i
    raise ValueError(f"a {h}x{w} image fits no canvas of {buckets}")


def gt_count(rng: np.random.RandomState, box: Dict) -> int:
    mu, sigma = box["count_lognormal"]
    lo, hi = box["count_range"]
    return int(np.clip(round(float(np.exp(rng.normal(mu, sigma)))), lo, hi))


def draw_boxes(rng: np.random.RandomState, h: int, w: int, n: int, box: Dict) -> np.ndarray:
    """``n`` XYXY boxes in an h x w photo: a size class by COCO's area mix,
    a side uniform in it (capped by the photo), an aspect ratio
    log-uniform in [1/3, 3], a uniform place."""
    bands = np.asarray(box["area_mix"], np.float64)
    kind = rng.choice(len(bands), size=n, p=bands[:, 2] / bands[:, 2].sum())
    side = rng.uniform(bands[kind, 0], bands[kind, 1])
    ar = np.exp(rng.uniform(np.log(1 / 3), np.log(3), n))
    bw = np.clip(side * np.sqrt(ar), 2, w - 1)
    bh = np.clip(side / np.sqrt(ar), 2, h - 1)
    x0 = rng.uniform(0, w - bw)
    y0 = rng.uniform(0, h - bh)
    return np.stack([x0, y0, x0 + bw, y0 + bh], 1).astype(np.float32)


def structure(traffic: Dict, buckets, max_size: int) -> List[List[Tuple[int, int, int, int]]]:
    """Per pool batch, per image: (photo h, photo w, short side, gt count),
    drawn from ``structure_seed``; each batch's photos all resize into its
    canvas."""
    rng = np.random.RandomState(traffic["structure_seed"])
    photos = np.asarray(traffic["photos"], np.float64)
    fits = {}
    for i, (h, w, _) in enumerate(photos):
        for s in traffic["min_sizes"]:
            fits.setdefault(pick_canvas(*resized(int(h), int(w), s, max_size), buckets), set()).add(i)
    out = []
    for c in traffic["canvases"]:
        ids = sorted(fits[c])
        p = photos[ids, 2] / photos[ids, 2].sum()
        rows = []
        while len(rows) < traffic["batch"]:
            h, w = (int(v) for v in photos[ids[rng.choice(len(ids), p=p)], :2])
            s = int(traffic["min_sizes"][rng.randint(len(traffic["min_sizes"]))])
            if pick_canvas(*resized(h, w, s, max_size), buckets) == c:
                rows.append((h, w, s, gt_count(rng, traffic["boxes"])))
        out.append(rows)
    return out


def make_pool(traffic: Dict, cfg: Dict, seed: int, device, with_gt: bool = True) -> List[Dict[str, torch.Tensor]]:
    """The pool's batches on ``device``: ``image`` (B, H, W, 3) float32 raw
    pixels in [0, 255] (0 outside the image), ``image_size`` (B, 2) int32,
    and with ``with_gt`` ``gt_boxes`` (B, G, 4), ``gt_classes`` (B, G) and
    ``gt_valid`` (B, G), G = PAD.MAX_GT_PER_IMAGE."""
    buckets = cfg["PAD.CANVAS_BUCKETS"]
    max_size = cfg["INPUT.MAX_SIZE_TRAIN" if with_gt else "INPUT.MAX_SIZE_TEST"]
    plan = structure(traffic, buckets, max_size)
    rng = np.random.RandomState(seed % (2 ** 32))
    # the run's seed reorders the images among the batches of each canvas
    by_canvas: Dict[int, List] = {}
    for c, rows in zip(traffic["canvases"], plan):
        by_canvas.setdefault(c, []).extend(rows)
    for c in by_canvas:
        rng.shuffle(by_canvas[c])
    gen = torch.Generator(device=device).manual_seed(seed % (2 ** 63))
    G = cfg["PAD.MAX_GT_PER_IMAGE"]
    K = cfg["MODEL.ROI_HEADS.NUM_CLASSES"]
    pool = []
    for c in traffic["canvases"]:
        rows = [by_canvas[c].pop() for _ in range(traffic["batch"])]
        H, W = buckets[c]
        B = len(rows)
        sizes = np.zeros((B, 2), np.int32)
        boxes = np.zeros((B, G, 4), np.float32)
        classes = np.zeros((B, G), np.int64)
        valid = np.zeros((B, G), bool)
        for b, (h0, w0, s, n) in enumerate(rows):
            h, w = resized(h0, w0, s, max_size)
            sizes[b] = (h, w)
            n = min(n, G)
            src = draw_boxes(rng, h0, w0, n, traffic["boxes"]).astype(np.float64)
            src[:, 0::2] *= w / w0
            src[:, 1::2] *= h / h0
            boxes[b, :n] = src.astype(np.float32)
            classes[b, :n] = rng.randint(0, K, n)
            valid[b, :n] = True
        image = torch.floor(torch.rand((B, H, W, 3), generator=gen, device=device) * 256.0)
        size_t = torch.from_numpy(sizes).to(device)
        rows_i = torch.arange(H, device=device)[None, :, None, None]
        cols_i = torch.arange(W, device=device)[None, None, :, None]
        inside = (rows_i < size_t[:, 0, None, None, None]) & (cols_i < size_t[:, 1, None, None, None])
        batch = {"image": image * inside, "image_size": size_t}
        if with_gt:
            batch.update(gt_boxes=torch.from_numpy(boxes).to(device), gt_classes=torch.from_numpy(classes).to(device),
                         gt_valid=torch.from_numpy(valid).to(device))
        pool.append(batch)
    return pool
