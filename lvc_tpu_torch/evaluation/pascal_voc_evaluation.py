"""PASCAL VOC detection evaluation: a copy of
``lvc_tpu/evaluation/pascal_voc_evaluation.py`` (``voc_ap``:23,
``voc_eval_class``:38, ``PascalVOCDetectionEvaluator``:86).

Per-class AP at IoU 0.50:0.95 in steps of 0.05 with the VOC devkit's
+1-pixel box sizes, the 11-point interpolation when the split's year is 2007
and the area under the curve otherwise; ``AP``, ``AP50`` and ``AP75``, the
``bAP50``/``nAP50`` means over the split's base and novel classes, and
``AP50-<class>``. Ground truth is read from the registered dataset dicts.
A ``difficult`` flag is honoured when a record carries one, but the VOC
loader (``data/meta_pascal_voc.py``) never sets it, as in JAX, so difficult
objects count as positives.

``process_detections`` takes the port's batched ``Detections`` (or a context
model's ``{"detections", "image_scores"}`` dict) on any device, with one copy
to the host per batch; boxes are rescaled from ``image_size`` to
``orig_size``. In a data-parallel run ``evaluate`` gathers every rank's rows
to the main rank (``comm.gather_objects``) and returns an empty dict on the
others.
"""
from __future__ import annotations

import logging
from collections import OrderedDict, defaultdict
from typing import Dict, List, Optional

import numpy as np

from lvc_tpu_torch.data.catalog import DatasetCatalog, MetadataCatalog
from lvc_tpu_torch.evaluation.coco_evaluation import host_detections
from lvc_tpu_torch.structures.boxes import BoxMode
from lvc_tpu_torch.utils import comm

logger = logging.getLogger(__name__)


def voc_ap(rec: np.ndarray, prec: np.ndarray, use_07_metric: bool = False) -> float:
    """AP given precision/recall curves (classic VOC devkit definition)."""
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = np.max(prec[rec >= t]) if np.any(rec >= t) else 0.0
            ap += p / 11.0
        return float(ap)
    mrec = np.concatenate(([0.0], rec, [1.0]))
    mpre = np.concatenate(([0.0], prec, [0.0]))
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = np.maximum(mpre[i - 1], mpre[i])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def voc_eval_class(
    dets: List[dict],  # [{image_id, bbox xyxy, score}]
    gt_by_image: Dict,  # image_id -> {boxes (N,4), difficult (N,)}
    ovthresh: float = 0.5,
    use_07_metric: bool = False,
) -> float:
    npos = sum(int((~g["difficult"]).sum()) for g in gt_by_image.values())
    if npos == 0 or len(dets) == 0:
        return 0.0
    dets = sorted(dets, key=lambda d: -d["score"])
    taken = {iid: np.zeros(len(g["boxes"]), bool) for iid, g in gt_by_image.items()}
    tp = np.zeros(len(dets))
    fp = np.zeros(len(dets))
    for i, det in enumerate(dets):
        g = gt_by_image.get(det["image_id"])
        if g is None or len(g["boxes"]) == 0:
            fp[i] = 1
            continue
        bb = np.asarray(det["bbox"])
        gt = g["boxes"]
        ixmin = np.maximum(gt[:, 0], bb[0])
        iymin = np.maximum(gt[:, 1], bb[1])
        ixmax = np.minimum(gt[:, 2], bb[2])
        iymax = np.minimum(gt[:, 3], bb[3])
        iw = np.maximum(ixmax - ixmin + 1.0, 0.0)
        ih = np.maximum(iymax - iymin + 1.0, 0.0)
        inters = iw * ih
        uni = (
            (bb[2] - bb[0] + 1.0) * (bb[3] - bb[1] + 1.0)
            + (gt[:, 2] - gt[:, 0] + 1.0) * (gt[:, 3] - gt[:, 1] + 1.0)
            - inters
        )
        overlaps = inters / uni
        jmax = int(np.argmax(overlaps))
        if overlaps[jmax] > ovthresh:
            if g["difficult"][jmax]:
                continue  # neither tp nor fp
            if not taken[det["image_id"]][jmax]:
                tp[i] = 1
                taken[det["image_id"]][jmax] = True
            else:
                fp[i] = 1
        else:
            fp[i] = 1
    fp = np.cumsum(fp)
    tp = np.cumsum(tp)
    rec = tp / float(npos)
    prec = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
    return voc_ap(rec, prec, use_07_metric)


class PascalVOCDetectionEvaluator:
    def __init__(self, dataset_name: str):
        self._dataset_name = dataset_name
        meta = MetadataCatalog.get(dataset_name)
        self._class_names = meta.thing_classes
        self._is_2007 = meta.get("year", 2007) == 2007
        self._base_classes = meta.get("base_classes")
        self._novel_classes = meta.get("novel_classes")
        self._gt_by_class: Optional[Dict] = None
        self._dets = defaultdict(list)

    def reset(self):
        self._dets = defaultdict(list)

    def _load_gt(self):
        if self._gt_by_class is not None:
            return
        self._gt_by_class = defaultdict(dict)
        for d in DatasetCatalog.get(self._dataset_name):
            per_cls = defaultdict(lambda: {"boxes": [], "difficult": []})
            for a in d["annotations"]:
                b = a["bbox"]
                if a.get("bbox_mode", BoxMode.XYXY_ABS) == BoxMode.XYWH_ABS:
                    b = [b[0], b[1], b[0] + b[2], b[1] + b[3]]
                per_cls[a["category_id"]]["boxes"].append(b)
                per_cls[a["category_id"]]["difficult"].append(bool(a.get("difficult", False)))
            for cid, v in per_cls.items():
                self._gt_by_class[cid][d["image_id"]] = {
                    "boxes": np.asarray(v["boxes"], np.float64),
                    "difficult": np.asarray(v["difficult"], bool),
                }

    def process_detections(self, dets, metas: List[dict]):
        dets = host_detections(dets)
        for i, meta in enumerate(metas):
            if meta.get("padding"):
                continue
            rh, rw = [int(x) for x in meta["image_size"]]
            oh, ow = [int(x) for x in meta["orig_size"]]
            sx, sy = ow / rw, oh / rh
            for b, s, c, v in zip(
                dets.boxes[i], dets.scores[i], dets.classes[i], dets.valid[i]
            ):
                if not v:
                    continue
                self._dets[int(c)].append(
                    {
                        "image_id": meta["image_id"],
                        "bbox": [b[0] * sx, b[1] * sy, b[2] * sx, b[3] * sy],
                        "score": float(s),
                    }
                )

    def evaluate(self) -> OrderedDict:
        if comm.get_world_size() > 1:
            shards = comm.gather_objects(dict(self._dets))
            if not comm.is_main_process():
                return OrderedDict()
            for shard in shards[1:]:
                for cid, rows in shard.items():
                    self._dets[cid].extend(rows)
        self._load_gt()
        aps: Dict[float, List[float]] = defaultdict(list)
        per_class_ap50 = {}
        for cid, name in enumerate(self._class_names):
            gt = self._gt_by_class.get(cid, {})
            for thresh in np.arange(0.5, 1.0, 0.05):
                ap = voc_eval_class(
                    self._dets.get(cid, []), gt, ovthresh=thresh, use_07_metric=self._is_2007
                )
                aps[round(float(thresh), 2)].append(ap * 100)
            per_class_ap50[name] = aps[0.5][-1]
        mAP = {t: float(np.mean(v)) for t, v in aps.items()}
        results = OrderedDict(
            {
                "bbox": {
                    "AP": float(np.mean(list(mAP.values()))),
                    "AP50": mAP[0.5],
                    "AP75": mAP[0.75],
                }
            }
        )
        # base/novel split means at AP50
        if self._base_classes:
            base_idx = [self._class_names.index(c) for c in self._base_classes if c in self._class_names]
            novel_idx = [self._class_names.index(c) for c in self._novel_classes if c in self._class_names]
            ap50 = aps[0.5]
            if base_idx:
                results["bbox"]["bAP50"] = float(np.mean([ap50[i] for i in base_idx]))
            if novel_idx:
                results["bbox"]["nAP50"] = float(np.mean([ap50[i] for i in novel_idx]))
        for name, v in per_class_ap50.items():
            results["bbox"][f"AP50-{name}"] = v
        logger.info("VOC eval: %s", {k: v for k, v in results["bbox"].items() if "-" not in k})
        return results
