"""YOLO-style mosaic augmentation (the port's copy of
``lvc_tpu/data/mosaic.py``: get_mosaic4:29, get_mosaic9:69,
MosaicDatasetMapper:94).

Counterpart of lvc/data/mosaic.py (get_mosaic:23-69 4-image,
get_mosaic9:72-127 9-image, MapDatasetMosaic:130-167 probability mixing).
Host-side numpy composition; the composed dict then flows through the
standard mapper's ``_map_loaded``, so crop, resize, flip, colour jitter,
blur and padding apply to the composite.
"""
from __future__ import annotations

import copy
from typing import List, Sequence

import numpy as np

from lvc_tpu_torch.data.dataset_mapper import DatasetMapper, read_image
from lvc_tpu_torch.structures.boxes import BoxMode


def _anns_xyxy_list(d: dict) -> List[List[float]]:
    out = []
    for a in d["annotations"]:
        b = list(map(float, a["bbox"]))
        if a.get("bbox_mode", BoxMode.XYWH_ABS) == BoxMode.XYWH_ABS:
            b = [b[0], b[1], b[0] + b[2], b[1] + b[3]]
        out.append(b)
    return out


def get_mosaic4(dicts: Sequence[dict], images: Sequence[np.ndarray]):
    """Compose 4 images around a center; returns (image, merged dict with
    XYXY annotations in the mosaic frame)."""
    s = max(max(im.shape[0], im.shape[1]) for im in images)
    canvas = np.full((2 * s, 2 * s, images[0].shape[2]), 114, np.uint8)
    yc = xc = s
    anns_out = []
    x_lo, y_lo, x_hi, y_hi = 2 * s, 2 * s, 0, 0
    for i, (d, img) in enumerate(zip(dicts, images)):
        h, w = img.shape[:2]
        if i == 0:  # top-left: bottom-right corner at center
            x1, y1 = xc - w, yc - h
        elif i == 1:  # top-right
            x1, y1 = xc, yc - h
        elif i == 2:  # bottom-left
            x1, y1 = xc - w, yc
        else:  # bottom-right
            x1, y1 = xc, yc
        canvas[y1 : y1 + h, x1 : x1 + w] = img
        x_lo, y_lo = min(x_lo, x1), min(y_lo, y1)
        x_hi, y_hi = max(x_hi, x1 + w), max(y_hi, y1 + h)
        for a, b in zip(d["annotations"], _anns_xyxy_list(d)):
            na = copy.deepcopy(a)
            na["bbox"] = [b[0] + x1, b[1] + y1, b[2] + x1, b[3] + y1]
            na["bbox_mode"] = BoxMode.XYXY_ABS
            anns_out.append(na)
    image = canvas[y_lo:y_hi, x_lo:x_hi]
    for a in anns_out:
        a["bbox"] = [
            a["bbox"][0] - x_lo,
            a["bbox"][1] - y_lo,
            a["bbox"][2] - x_lo,
            a["bbox"][3] - y_lo,
        ]
    out = dict(dicts[0])
    out["annotations"] = anns_out
    out["height"], out["width"] = image.shape[:2]
    return image, out


def get_mosaic9(dicts: Sequence[dict], images: Sequence[np.ndarray]):
    """3x3 grid mosaic: tile k at grid cell (k // 3, k % 3), each cell s x s,
    image anchored top-left in its cell."""
    s = max(max(im.shape[0], im.shape[1]) for im in images)
    canvas = np.full((3 * s, 3 * s, images[0].shape[2]), 114, np.uint8)
    anns_out = []
    x_hi, y_hi = 0, 0
    for k, (d, img) in enumerate(zip(dicts, images)):
        r, c = divmod(k, 3)
        y1, x1 = r * s, c * s
        h, w = img.shape[:2]
        canvas[y1 : y1 + h, x1 : x1 + w] = img
        x_hi, y_hi = max(x_hi, x1 + w), max(y_hi, y1 + h)
        for a, b in zip(d["annotations"], _anns_xyxy_list(d)):
            na = copy.deepcopy(a)
            na["bbox"] = [b[0] + x1, b[1] + y1, b[2] + x1, b[3] + y1]
            na["bbox_mode"] = BoxMode.XYXY_ABS
            anns_out.append(na)
    image = canvas[:y_hi, :x_hi]
    out = dict(dicts[0])
    out["annotations"] = anns_out
    out["height"], out["width"] = image.shape[:2]
    return image, out


class MosaicDatasetMapper:
    """Wraps a DatasetMapper: with probability ``mosaic_prob`` compose a
    4- or 9-image mosaic (9 with probability ``mosaic49split``) from random
    dataset dicts, then run the standard mapping on the composite. Its
    ``RandomState(seed + 1234)`` is its own, apart from the base mapper's."""

    def __init__(
        self,
        base_mapper: DatasetMapper,
        dataset_dicts: List[dict],
        mosaic_prob: float,
        mosaic49split: float = 0.0,
        seed: int = 0,
    ):
        self.base = base_mapper
        self.dataset_dicts = dataset_dicts
        self.prob = mosaic_prob
        self.split49 = mosaic49split
        self.rng = np.random.RandomState(seed + 1234)

    def __call__(self, dataset_dict: dict):
        if self.rng.rand() >= self.prob:
            return self.base(dataset_dict)
        n = 4 if self.rng.rand() >= self.split49 else 9
        picks = [dataset_dict] + [
            self.dataset_dicts[self.rng.randint(len(self.dataset_dicts))]
            for _ in range(n - 1)
        ]
        picks = [copy.deepcopy(p) for p in picks]
        images = [read_image(p["file_name"], self.base.fmt) for p in picks]
        if n == 4:
            image, merged = get_mosaic4(picks, images)
        else:
            image, merged = get_mosaic9(picks, images)
        return self.base._map_loaded(merged, image)
