"""RPN proposal extraction and recall (the port's copy of
``lvc_tpu/evaluation/rpn_evaluation.py``; lvc/evaluation/rpn_evaluation.py
RPNEvaluator:27).

``RPNEvaluator`` takes ``ProposalNetwork``'s output dict and writes the
pipeline's pickle ``{ids, boxes (XYXY, score-sorted), objectness_logits}``
as ``coco_proposals_{trainval|test}_results.pkl``; on a test split with
annotations it reports class-agnostic average recall (AR@100, AR@1000 over
IoU 0.5:0.95) for the all, base and novel gts.
"""
from __future__ import annotations

import logging
import os
import pickle
from collections import OrderedDict, defaultdict
from typing import Dict, List, Optional

import numpy as np

from lvc_tpu_torch.data.catalog import MetadataCatalog
from lvc_tpu_torch.data.coco_api import COCO
from lvc_tpu_torch.evaluation.coco_evaluation import BASE_CLASS_IDS, NOVEL_CLASS_IDS
from lvc_tpu_torch.utils import comm

logger = logging.getLogger(__name__)


def _iou_xyxy(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)))
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    union = area_a[:, None] + area_b[None, :] - inter
    return np.where(inter > 0, inter / np.maximum(union, 1e-12), 0.0)


def average_recall(gt_by_image: Dict[int, np.ndarray], props_by_image: Dict[int, np.ndarray],
                   max_dets: int = 1000) -> float:
    """Mean over IoU thresholds 0.5:0.05:0.95 of the gt recall of the top
    ``max_dets`` proposals, each proposal greedily claiming its best
    unmatched gt."""
    thrs = np.linspace(0.5, 0.95, 10)
    total_gt = 0
    matched = np.zeros(len(thrs))
    for iid, gts in gt_by_image.items():
        if len(gts) == 0:
            continue
        props = props_by_image.get(iid, np.zeros((0, 4)))[:max_dets]
        total_gt += len(gts)
        if len(props) == 0:
            continue
        ious = _iou_xyxy(props, gts)
        for ti, t in enumerate(thrs):
            gt_taken = np.zeros(len(gts), bool)
            for d in range(len(props)):
                j = int(np.argmax(np.where(gt_taken, -1.0, ious[d])))
                if ious[d, j] >= t and not gt_taken[j]:
                    gt_taken[j] = True
            matched[ti] += gt_taken.sum()
    if total_gt == 0:
        return 0.0
    return float(np.mean(matched / total_gt))


class RPNEvaluator:
    def __init__(self, dataset_name: str, cfg=None, output_dir: Optional[str] = None):
        self._dataset_name = dataset_name
        self._output_dir = output_dir
        json_file = MetadataCatalog.get(dataset_name).get("json_file")
        self._coco_api = COCO(json_file) if json_file and os.path.isfile(json_file) else COCO()
        self._do_evaluation = "annotations" in self._coco_api.dataset
        self._training_set = "trainval" in dataset_name
        self._is_splits = any(s in dataset_name for s in ("all", "base", "novel"))
        self._props: Dict[int, np.ndarray] = {}
        self._logits: Dict[int, np.ndarray] = {}

    def reset(self):
        self._props = {}
        self._logits = {}

    def process_detections(self, outputs, metas: List[dict]):
        """outputs: ``ProposalNetwork``'s dict of ``proposal_boxes`` (B, K, 4),
        ``objectness_logits`` (B, K) and ``proposal_valid`` (B, K), on any
        device; boxes are scaled back to the original image size."""
        boxes = outputs["proposal_boxes"].cpu().double().numpy()
        logits = outputs["objectness_logits"].cpu().double().numpy()
        valid = outputs["proposal_valid"].cpu().numpy()
        for i, meta in enumerate(metas):
            if meta.get("padding"):
                continue
            b = boxes[i][valid[i]]
            s = logits[i][valid[i]]
            rh, rw = [int(x) for x in meta["image_size"]]
            oh, ow = [int(x) for x in meta["orig_size"]]
            b = b * np.array([ow / rw, oh / rh, ow / rw, oh / rh])
            order = np.argsort(-s, kind="stable")
            self._props[int(meta["image_id"])] = b[order]
            self._logits[int(meta["image_id"])] = s[order]

    def evaluate(self) -> OrderedDict:
        """The main rank merges every rank's proposals (in rank order) and
        writes the pickle; the others return an empty dict
        (``lvc_tpu/evaluation/rpn_evaluation.py:107-111``)."""
        if comm.get_world_size() > 1:
            shards = comm.gather_objects((self._props, self._logits))
            if not comm.is_main_process():
                return OrderedDict()
            for props, logits in shards[1:]:
                self._props.update(props)
                self._logits.update(logits)
        save_dict = {
            "ids": list(self._props.keys()),
            "boxes": [self._props[i] for i in self._props],
            "objectness_logits": [self._logits[i] for i in self._props],
        }
        if self._output_dir:
            os.makedirs(self._output_dir, exist_ok=True)
            tag = "trainval" if "trainval" in self._dataset_name else "test"
            path = os.path.join(self._output_dir, f"coco_proposals_{tag}_results.pkl")
            with open(path, "wb") as f:
                pickle.dump(save_dict, f, protocol=pickle.HIGHEST_PROTOCOL)
            logger.info("Saved proposals to %s", path)

        results = OrderedDict()
        if not self._do_evaluation or self._training_set:
            return results

        def gt_split(cat_ids):
            out = defaultdict(list)
            for ann in self._coco_api.dataset.get("annotations", []):
                if ann.get("iscrowd", 0):
                    continue
                if cat_ids is not None and ann["category_id"] not in cat_ids:
                    continue
                x, y, w, h = ann["bbox"]
                out[ann["image_id"]].append([x, y, x + w, y + h])
            return {k: np.asarray(v) for k, v in out.items()}

        results["bbox"] = {}
        splits = [("", None)]
        if self._is_splits:
            splits = [("", None), ("b", set(BASE_CLASS_IDS)), ("n", set(NOVEL_CLASS_IDS))]
        for prefix, cats in splits:
            if prefix and "all" not in self._dataset_name:
                if (prefix == "b" and "base" not in self._dataset_name) or (
                    prefix == "n" and "novel" not in self._dataset_name
                ):
                    continue
            gts = gt_split(cats)
            for k in (100, 1000):
                results["bbox"][f"{prefix}AR@{k}"] = average_recall(gts, self._props, max_dets=k) * 100.0
        return results
