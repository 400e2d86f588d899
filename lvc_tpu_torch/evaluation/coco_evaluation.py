"""COCO evaluator over padded model outputs (the port's counterpart of
``lvc_tpu/evaluation/coco_evaluation.py``).

Counterpart of lvc/evaluation/coco_evaluation.py (COCOEvaluator:28):
converts fixed-shape Detections to COCO result rows (rescaled to original
image size — the reference's detector_postprocess), writes
``coco_instances_{trainval|unlabeled|test}_results.json``, skips metric
computation on training sets (:318-320), and reports all/base/novel AP
splits with b/n prefixes (:323-358) plus per-category tables.

It takes the port's ``Detections`` (torch tensors, on the card or the CPU;
or the context model's ``{"detections", "image_scores"}`` dict, whose
detections it reads) through one copy to the host per batch
(``host_detections``). In a data-parallel run each rank holds the
rows of its shard; ``evaluate`` gathers them to the main rank in rank order
(the whole dataset's order, as the test shards are contiguous) and returns
an empty dict on the others (``lvc_tpu/evaluation/coco_evaluation.py:143-151``).
Detections with ``masks`` (Mask R-CNN) give each row an uncompressed RLE
``segmentation``: the roi masks pasted on the host at the original size
(``paste_masks_np``); on a dataset without the all/base/novel splits the
``segm`` task is then evaluated beside ``bbox``, with each row's area and
box taken from its mask (``lvc_tpu/evaluation/coco_evaluation.py:56-67,
91-96,206-210``).
"""
from __future__ import annotations

import copy
import json
import logging
import os
from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np
import torch

from lvc_tpu_torch.data.catalog import MetadataCatalog
from lvc_tpu_torch.data.coco_api import COCO
from lvc_tpu_torch.evaluation.coco_eval import COCOeval
from lvc_tpu_torch.evaluation.fast_eval_api import COCOeval_opt
from lvc_tpu_torch.modeling.roi_heads.fast_rcnn import index_detections
from lvc_tpu_torch.structures.masks import bitmask_to_rle, paste_masks_np
from lvc_tpu_torch.utils import comm

logger = logging.getLogger(__name__)

# dataset (non-contiguous) category ids of the FSOD split
# (lvc coco_evaluation.py:70-77)
BASE_CLASS_IDS = [
    8, 10, 11, 13, 14, 15, 22, 23, 24, 25, 27, 28, 31, 32, 33, 34, 35, 36, 37,
    38, 39, 40, 41, 42, 43, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 65, 70, 73, 74, 75, 76, 77, 78, 79, 80, 81, 82, 84, 85, 86, 87,
    88, 89, 90,
]
NOVEL_CLASS_IDS = [1, 2, 3, 4, 5, 6, 7, 9, 16, 17, 18, 19, 20, 21, 44, 62, 63, 64, 67, 72]


def host_detections(out):
    """The detections of a model output (``Detections`` or
    ``DetectionsDebug``, or ``GeneralizedRCNN_Context``'s dict holding them
    under ``"detections"``) as numpy arrays: one copy to the host."""
    if isinstance(out, dict):
        out = out["detections"]
    return type(out)(*[f.cpu().numpy() if isinstance(f, torch.Tensor) else f for f in out])


def detections_to_coco_json(dets, meta: dict, reverse_id_map=None) -> List[dict]:
    """One image's padded Detections -> COCO result rows, rescaled from the
    resized canvas coords to the original image size. ``reverse_id_map``
    maps contiguous class indices to dataset category ids at process time,
    like the reference (lvc/evaluation/coco_evaluation.py:96-117); without
    it the contiguous index is emitted as-is. Fields may be numpy arrays or
    CPU tensors. With ``masks``, each valid detection's probability mask is
    pasted at the original resolution and emitted as an uncompressed RLE
    ``segmentation`` (the reference emits compressed RLE; the port's COCO
    api decodes both)."""
    rows = []
    boxes = np.asarray(dets.boxes, np.float64)
    scores = np.asarray(dets.scores, np.float64)
    classes = np.asarray(dets.classes)
    valid = np.asarray(dets.valid)
    rh, rw = [int(x) for x in meta["image_size"]]
    oh, ow = [int(x) for x in meta["orig_size"]]
    sx, sy = ow / rw, oh / rh
    masks = None
    if getattr(dets, "masks", None) is not None:
        scaled = boxes * np.array([sx, sy, sx, sy], np.float64)
        keep = np.flatnonzero(valid)
        pasted = paste_masks_np(np.asarray(dets.masks, np.float32)[keep], scaled[keep], (oh, ow))
        masks = {int(i): bitmask_to_rle(m) for i, m in zip(keep, pasted)}
    for i, (b, s, c, v) in enumerate(zip(boxes, scores, classes, valid)):
        if not v:
            continue
        x0, y0, x1, y1 = b[0] * sx, b[1] * sy, b[2] * sx, b[3] * sy
        cat = int(c) if reverse_id_map is None else int(reverse_id_map[int(c)])
        row = {
            "image_id": int(meta["image_id"]),
            "category_id": cat,
            "bbox": [float(x0), float(y0), float(x1 - x0), float(y1 - y0)],
            "score": float(s),
        }
        if masks is not None:
            row["segmentation"] = masks[i]
        rows.append(row)
    return rows


def _evaluate_predictions_on_coco(
    coco_gt: COCO, coco_results: List[dict], catIds=None, iou_type: str = "bbox"
) -> COCOeval:
    coco_results = copy.deepcopy(coco_results)
    if iou_type == "segm":
        # a segm row's area (its small/medium/large range) comes from its mask, not its box: loadRes
        # takes the segmentation branch without the bbox (detectron2/evaluation/coco_evaluation.py:489-496)
        for c in coco_results:
            c.pop("bbox", None)
    coco_dt = coco_gt.loadRes(coco_results)
    coco_eval = COCOeval_opt(coco_gt, coco_dt, iouType=iou_type)
    if catIds is not None:
        coco_eval.params.catIds = list(catIds)
    coco_eval.evaluate()
    coco_eval.accumulate()
    coco_eval.summarize()
    return coco_eval


class COCOEvaluator:
    def __init__(self, dataset_name: str, cfg=None, output_dir: Optional[str] = None):
        self._dataset_name = dataset_name
        self._output_dir = output_dir
        self._metadata = MetadataCatalog.get(dataset_name)
        json_file = self._metadata.get("json_file")
        self._coco_api = COCO(json_file) if json_file and os.path.isfile(json_file) else COCO()
        self._do_evaluation = "annotations" in self._coco_api.dataset
        self._training_set = "trainval" in dataset_name
        self._is_splits = any(s in dataset_name for s in ("all", "base", "novel"))
        # contiguous -> dataset category ids, applied at process time
        # (the reference maps per row in its process loop,
        # lvc/evaluation/coco_evaluation.py:96-117)
        id_map = self._metadata.get("thing_dataset_id_to_contiguous_id")
        self._reverse_id_map = {v: k for k, v in id_map.items()} if id_map else None
        self._predictions: List[dict] = []

    def reset(self):
        self._predictions = []

    def process_detections(self, dets, metas: List[dict]):
        """dets: batched ``Detections`` (torch, on any device; or the context
        model's dict), metas from ``EvalLoader`` (entries with padding=True
        are skipped). One copy to the host per batch."""
        dets = host_detections(dets)
        for i, meta in enumerate(metas):
            if meta.get("padding"):
                continue
            one = index_detections(dets, i)
            self._predictions.extend(
                detections_to_coco_json(one, meta, self._reverse_id_map)
            )

    def _gather(self) -> bool:
        """In a data-parallel run, every rank's rows to the main rank; False
        on the others."""
        if comm.get_world_size() > 1:
            shards = comm.gather_objects(self._predictions)
            if not comm.is_main_process():
                return False
            self._predictions = [r for shard in shards for r in shard]
        return True

    def evaluate(self) -> "OrderedDict":
        if not self._gather():
            return OrderedDict()
        # predictions already carry dataset category ids (mapped at
        # process time, matching the reference)
        coco_results = copy.deepcopy(self._predictions)

        if self._output_dir:
            os.makedirs(self._output_dir, exist_ok=True)
            tag = (
                "trainval"
                if "trainval" in self._dataset_name
                else "unlabeled"
                if "unlabeled" in self._dataset_name
                else "test"
            )
            path = os.path.join(self._output_dir, f"coco_instances_{tag}_results.json")
            with open(path, "w") as f:
                json.dump(coco_results, f)
            logger.info("Saved results to %s", path)

        results = OrderedDict()
        if not self._do_evaluation:
            logger.info("Annotations not available; skipping metrics")
            return results
        if self._training_set:
            logger.info("Not running coco eval on a training set")
            return results

        if self._is_splits:
            results["bbox"] = {}
            for split, classes, names in [
                ("all", None, self._metadata.get("thing_classes")),
                ("base", BASE_CLASS_IDS, self._metadata.get("base_classes")),
                ("novel", NOVEL_CLASS_IDS, self._metadata.get("novel_classes")),
            ]:
                if "all" not in self._dataset_name and split not in self._dataset_name:
                    continue
                coco_eval = (
                    _evaluate_predictions_on_coco(self._coco_api, coco_results, classes)
                    if coco_results
                    else None
                )
                res_ = self._derive_coco_results(coco_eval, class_names=names)
                prefix = {"all": "", "base": "b", "novel": "n"}[split]
                for metric, val in res_.items():
                    if len(metric) <= 4:
                        results["bbox"][prefix + metric] = val
            if "AP" not in results["bbox"]:
                results["bbox"]["AP"] = results["bbox"].get(
                    "nAP", results["bbox"].get("bAP")
                )
        else:
            # every task the rows carry, as the detectron2 evaluator does (the reference's lvc evaluator
            # evaluates bbox alone even with MASK_ON)
            tasks = ["bbox"]
            if any("segmentation" in r for r in coco_results):
                tasks.append("segm")
            for task in tasks:
                coco_eval = (
                    _evaluate_predictions_on_coco(self._coco_api, coco_results, iou_type=task)
                    if coco_results
                    else None
                )
                results[task] = self._derive_coco_results(
                    coco_eval, class_names=self._metadata.get("thing_classes")
                )
        return results

    def _derive_coco_results(self, coco_eval: Optional[COCOeval], class_names=None) -> Dict[str, float]:
        metrics = ["AP", "AP50", "AP75", "APs", "APm", "APl"]
        if coco_eval is None:
            return {m: -1.0 for m in metrics}
        results = {m: float(coco_eval.stats[i] * 100) for i, m in enumerate(metrics)}
        logger.info("Evaluation results: %s", results)
        if class_names:
            # per-category AP at the summary settings
            precisions = coco_eval.eval["precision"]
            for idx, name in enumerate(class_names):
                p = precisions[:, :, idx, 0, -1]
                p = p[p > -1]
                results[f"AP-{name}"] = float(np.mean(p) * 100) if p.size else float("nan")
        return results
