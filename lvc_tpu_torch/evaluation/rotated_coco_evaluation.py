"""COCO-style evaluation of rotated (XYWHA) detections.

Counterpart of ``lvc_tpu/evaluation/rotated_coco_evaluation.py``
(_to_xywha:27, rotated_iou_xywha:41, RotatedCOCOeval:57, rotated_detections_to_coco_json:76,
RotatedCOCOEvaluator:104): the COCOeval protocol of the port's
``COCOeval``, with the IoU of detections and ground truth the rotated
polygon-clip IoU (``structures/rotated_boxes.py``, float32 as in JAX) and
4-dim XYWH ground truth promoted to XYWHA at angle 0. A crowd gt scores
intersection over the detection's area. The evaluator keeps the rows'
contiguous class ids until ``evaluate`` maps them to the dataset's, writes
``coco_instances_results.json`` and reports ``bbox`` AP over every class (no
all/base/novel splits, no ``segm``), as JAX's does.
"""
from __future__ import annotations

import copy
import json
import os
from collections import OrderedDict
from typing import List

import numpy as np
import torch

from lvc_tpu_torch.evaluation.coco_eval import COCOeval
from lvc_tpu_torch.evaluation.coco_evaluation import COCOEvaluator, host_detections
from lvc_tpu_torch.modeling.roi_heads.fast_rcnn import index_detections
from lvc_tpu_torch.structures import rotated_boxes as rb


def _to_xywha(boxes: np.ndarray) -> np.ndarray:
    """(N, 4) XYWH rows -> (N, 5) XYWHA (centre form, angle 0); (N, 5) as is."""
    boxes = np.asarray(boxes, np.float64)
    if boxes.shape[-1] == 5:
        return boxes
    cx = boxes[:, 0] + boxes[:, 2] / 2.0
    cy = boxes[:, 1] + boxes[:, 3] / 2.0
    return np.stack([cx, cy, boxes[:, 2], boxes[:, 3], np.zeros(len(boxes))], axis=1)


def rotated_iou_xywha(dets: np.ndarray, gts: np.ndarray, iscrowd: np.ndarray) -> np.ndarray:
    """(D, G) rotated IoU in float64 from float32 intersections and areas."""
    if len(dets) == 0 or len(gts) == 0:
        return np.zeros((len(dets), len(gts)))
    d = torch.from_numpy(_to_xywha(dets).astype(np.float32))
    g = torch.from_numpy(_to_xywha(gts).astype(np.float32))
    inter = rb.pairwise_intersection_rotated(d, g).numpy().astype(np.float64)
    darea = rb.area_rotated(d).numpy().astype(np.float64)[:, None]
    garea = rb.area_rotated(g).numpy().astype(np.float64)[None, :]
    union = np.where(np.asarray(iscrowd, bool)[None, :], darea, darea + garea - inter)
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


class RotatedCOCOeval(COCOeval):
    """COCOeval with the rotated IoU."""

    def computeIoU(self, imgId, catId):
        p = self.params
        gt = self._gts[imgId, catId]
        dt = self._dts[imgId, catId]
        if len(gt) == 0 or len(dt) == 0:
            return np.zeros((len(dt), len(gt)))
        inds = np.argsort([-d["score"] for d in dt], kind="mergesort")
        dt = [dt[i] for i in inds][: p.maxDets[-1]]
        d = np.array([x["bbox"] for x in dt], dtype=np.float64)
        g = np.array([x["bbox"] for x in gt], dtype=np.float64)
        iscrowd = np.array([x.get("iscrowd", 0) for x in gt], dtype=bool)
        return rotated_iou_xywha(d, g, iscrowd)


def rotated_detections_to_coco_json(dets, meta: dict) -> List[dict]:
    """One image's padded rotated detections -> COCO rows with a 5-dim
    ``bbox`` (XYWHA), centre and size rescaled to the original image (the
    angle is kept: the test resize is isotropic)."""
    boxes = np.asarray(dets.boxes, np.float64)
    scores = np.asarray(dets.scores, np.float64)
    classes = np.asarray(dets.classes)
    valid = np.asarray(dets.valid)
    rh, rw = [int(x) for x in meta["image_size"]]
    oh, ow = [int(x) for x in meta["orig_size"]]
    sx, sy = ow / rw, oh / rh
    return [
        {"image_id": int(meta["image_id"]), "category_id": int(c),
         "bbox": [b[0] * sx, b[1] * sy, b[2] * sx, b[3] * sy, float(b[4])], "score": float(s)}
        for b, s, c, v in zip(boxes, scores, classes, valid) if v
    ]


class RotatedCOCOEvaluator(COCOEvaluator):
    """``COCOEvaluator`` over rotated detections, evaluated with
    ``RotatedCOCOeval``; a data-parallel run gathers the rows to the main
    rank first."""

    def process_detections(self, dets, metas: List[dict]):
        dets = host_detections(dets)
        for i, meta in enumerate(metas):
            if not meta.get("padding"):
                self._predictions.extend(rotated_detections_to_coco_json(index_detections(dets, i), meta))

    def evaluate(self) -> "OrderedDict":
        if not self._gather():
            return OrderedDict()
        coco_results = copy.deepcopy(self._predictions)
        if self._reverse_id_map:
            for r in coco_results:
                r["category_id"] = self._reverse_id_map[r["category_id"]]
        if self._output_dir:
            os.makedirs(self._output_dir, exist_ok=True)
            with open(os.path.join(self._output_dir, "coco_instances_results.json"), "w") as f:
                json.dump(coco_results, f)
        results = OrderedDict()
        if not self._do_evaluation or not coco_results:
            return results
        coco_eval = RotatedCOCOeval(self._coco_api, self._coco_api.loadRes(coco_results))
        coco_eval.evaluate()
        coco_eval.accumulate()
        coco_eval.summarize()
        results["bbox"] = self._derive_coco_results(coco_eval, class_names=self._metadata.get("thing_classes"))
        return results
