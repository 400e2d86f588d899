"""Test-time augmentation: multi-scale and flip inference with an NMS merge.

Counterpart of ``lvc_tpu/modeling/test_time_augmentation.py``
(``DatasetMapperTTA``:27, ``_boxes_to_original``:66, ``merge_tta_detections``:79,
``GeneralizedRCNNWithTTA``:95), driven by ``cfg.TEST.AUG.*``. The host makes
one padded canvas per (min size, flip) variant, each variant runs through the
model's eval forward on its device (the serving pool, K1 or K2, once a
variant), its detections are mapped back to the original image in numpy as
in JAX, and the merge is one class-aware NMS and top-k over the union of the
variants' detections on the model's device (``ops/nms.py``).

As in JAX, the mapper pads each variant into the smallest of
``PAD.CANVAS_BUCKETS`` that holds it and raises ``ValueError`` when none
does: at the defaults (short sides 400-1200, buckets up to 1344 x 1344) a
480 x 640 image at short side 1100 is 1100 x 1467 and fits no bucket. Give
buckets that hold every variant.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from lvc_tpu_torch.data import transforms as T
from lvc_tpu_torch.data.dataset_mapper import pick_canvas
from lvc_tpu_torch.ops.nms import batched_nms_mask, masked_topk


class DatasetMapperTTA:
    """One model batch per (scale, flip) variant of an image:
    ``min_sizes x {identity, hflip}``. Each dict carries ``tta_scale``
    (resized / original (h, w)), ``tta_flip`` and ``tta_width`` so that the
    detections can be mapped back."""

    def __init__(self, cfg):
        self.min_sizes: Sequence[int] = tuple(cfg.TEST.AUG.MIN_SIZES)
        self.max_size: int = cfg.TEST.AUG.MAX_SIZE
        self.flip: bool = cfg.TEST.AUG.FLIP
        self.buckets = [tuple(b) for b in cfg.PAD.CANVAS_BUCKETS]

    def __call__(self, image: np.ndarray) -> List[Dict[str, np.ndarray]]:
        orig_h, orig_w = image.shape[:2]
        out = []
        for short in self.min_sizes:
            resized, _, _ = T.resize_shortest_edge(image, None, short, self.max_size)
            for flip in (False, True) if self.flip else (False,):
                img = resized[:, ::-1] if flip else resized
                h, w = img.shape[:2]
                ch, cw = pick_canvas(h, w, self.buckets)
                padded = np.zeros((ch, cw, 3), np.float32)
                padded[:h, :w] = img
                out.append(
                    {
                        "image": padded,
                        "image_size": np.array([h, w], np.int32),
                        "tta_scale": np.array([h / orig_h, w / orig_w], np.float32),
                        "tta_flip": flip,
                        "tta_width": w,
                    }
                )
        return out


def _boxes_to_original(
    boxes: np.ndarray, scale_hw: np.ndarray, flip: bool, variant_width: int
) -> np.ndarray:
    """Undo the flip, then rescale XYXY boxes to the original image."""
    b = boxes.copy()
    if flip:
        x0 = variant_width - b[:, 2]
        x1 = variant_width - b[:, 0]
        b[:, 0], b[:, 2] = x0, x1
    b[:, [0, 2]] /= scale_hw[1]
    b[:, [1, 3]] /= scale_hw[0]
    return b


def merge_tta_detections(
    boxes: torch.Tensor,  # (N, 4) boxes in the original image, all variants
    scores: torch.Tensor,  # (N,)
    classes: torch.Tensor,  # (N,)
    valid: torch.Tensor,  # (N,) bool
    nms_thresh: float,
    topk: int,
):
    """Class-aware NMS over the union of all variants' detections, then the
    top-k kept: (boxes, scores, classes, ok), k slots."""
    keep = batched_nms_mask(boxes, scores, classes, valid, nms_thresh)
    order, ok = masked_topk(scores, keep, topk)
    return boxes[order], scores[order], classes[order], ok


class GeneralizedRCNNWithTTA:
    """Multi-scale and flip TTA around an eval forward.

    ``eval_fn(batch) -> Detections`` takes the eval batch dict and returns
    padded Detections: the port's model in eval mode is one. The merge runs
    on the device of the detections (the model's)."""

    def __init__(self, cfg, eval_fn: Callable, tta_mapper: Optional[DatasetMapperTTA] = None):
        self.cfg = cfg
        self.eval_fn = eval_fn
        self.tta_mapper = tta_mapper or DatasetMapperTTA(cfg)
        self.nms_thresh = cfg.MODEL.ROI_HEADS.NMS_THRESH_TEST
        self.topk = cfg.TEST.DETECTIONS_PER_IMAGE

    def variant_detections(self, image: np.ndarray):
        """Each variant's detections in the original image, as numpy
        (boxes, scores, classes, valid) concatenated over the variants, and
        the device they were computed on."""
        all_boxes, all_scores, all_classes, all_valid = [], [], [], []
        for v in self.tta_mapper(image):
            batch = {"image": v["image"][None], "image_size": v["image_size"][None]}
            dets = self.eval_fn(batch)
            boxes = dets.boxes[0].cpu().numpy()
            all_boxes.append(_boxes_to_original(boxes, v["tta_scale"], v["tta_flip"], v["tta_width"]))
            all_scores.append(dets.scores[0].cpu().numpy())
            all_classes.append(dets.classes[0].cpu().numpy())
            all_valid.append(dets.valid[0].cpu().numpy())
        cat = [np.concatenate(x) for x in (all_boxes, all_scores, all_classes, all_valid)]
        return cat, dets.boxes.device

    def __call__(self, image: np.ndarray):
        """image: (H, W, 3) in cfg INPUT.FORMAT order. Returns numpy
        (boxes, scores, classes, valid) in original coordinates."""
        (boxes, scores, classes, valid), device = self.variant_detections(image)
        merged = merge_tta_detections(
            *(torch.from_numpy(x).to(device) for x in (boxes, scores, classes, valid)),
            self.nms_thresh, self.topk,
        )
        return tuple(t.cpu().numpy() for t in merged)
