"""A seeded COCO-like JPEG tree for the program's own loader.

Parameters (the cell file's ``traffic.tree``, boxes from ``traffic.boxes``):
``images`` files, ``photos`` [h, w, weight] as in ``images.py`` (the
tree's own, not the mix's; their order fixed by ``structure_seed``), ``block``/``noise``/``quality``: each
image is blocky noise (one colour per ``block`` px square) plus uniform
per-pixel noise of +-``noise``, saved at JPEG ``quality``, which gives
files of a photograph's size (about 100-250 KB at 640x480) rather than of
pure noise or of flat colour. Boxes are drawn as for the device batches,
with classes in [0, NUM_CLASSES) (contiguous ids, as the program's dataset
registration maps them)."""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List

import numpy as np
from PIL import Image

from benchmark.traffic.images import draw_boxes, gt_count


def _photo_order(tree: Dict, seed: int) -> List[tuple]:
    rng = np.random.RandomState(tree["structure_seed"])
    photos = np.asarray(tree["photos"], np.float64)
    idx = rng.choice(len(photos), size=tree["images"], p=photos[:, 2] / photos[:, 2].sum())
    sizes = [tuple(int(v) for v in photos[i, :2]) for i in idx]
    np.random.RandomState(seed % (2 ** 32)).shuffle(sizes)
    return sizes


def _write_one(path: str, h: int, w: int, seed: int, tree: Dict) -> None:
    rng = np.random.default_rng(seed)
    b = tree["block"]
    low = rng.integers(0, 256, (h // b + 1, w // b + 1, 3), dtype=np.int16)
    img = np.repeat(np.repeat(low, b, 0), b, 1)[:h, :w]
    img = img + rng.integers(-tree["noise"], tree["noise"] + 1, img.shape, dtype=np.int16)
    Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(path, format="JPEG", quality=tree["quality"])


def write_tree(root: str, traffic: Dict, num_classes: int, seed: int, threads: int = 8) -> List[Dict]:
    """Writes the JPEGs under ``root`` and returns detectron2-style dataset
    dicts (XYWH_ABS boxes, ``iscrowd`` 0)."""
    tree = dict(traffic["tree"], structure_seed=traffic["structure_seed"])
    sizes = _photo_order(tree, seed)
    rng = np.random.RandomState((seed + 1) % (2 ** 32))
    counts = np.random.RandomState(tree["structure_seed"] + 1)
    os.makedirs(root, exist_ok=True)
    dicts, jobs = [], []
    for i, (h, w) in enumerate(sizes):
        n = gt_count(counts, traffic["boxes"])
        boxes = draw_boxes(rng, h, w, n, traffic["boxes"])
        classes = rng.randint(0, num_classes, n)
        path = os.path.join(root, f"{i:06d}.jpg")
        jobs.append((path, h, w, int(rng.randint(2 ** 31))))
        dicts.append({
            "file_name": path, "height": h, "width": w, "image_id": i + 1,
            "annotations": [{"bbox": [float(x0), float(y0), float(x1 - x0), float(y1 - y0)], "bbox_mode": 1,
                             "category_id": int(c), "iscrowd": 0, "id": 1000 * (i + 1) + j}
                            for j, ((x0, y0, x1, y1), c) in enumerate(zip(boxes, classes))],
        })
    with ThreadPoolExecutor(threads) as pool:
        for f in [pool.submit(_write_one, *job, tree) for job in jobs]:
            f.result()
    return dicts
