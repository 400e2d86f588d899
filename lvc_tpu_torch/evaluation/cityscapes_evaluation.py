"""Cityscapes evaluation: a copy of ``lvc_tpu/evaluation/cityscapes_evaluation.py``
(the port keeps its own; it reads the port's ``coco_api`` and ``coco_eval``).

Counterpart of the vendored ``detectron2/evaluation/cityscapes_evaluation.py``
(CityscapesInstanceEvaluator:47, CityscapesSemSegEvaluator:122). The
reference shells out to ``cityscapesscripts`` (not in this image); here the
instance metric is computed with our COCO-protocol evaluator over the
cityscapes thing classes (AP/AP50 on boxes), and the semantic metric with
:class:`~lvc_tpu_torch.evaluation.sem_seg_evaluation.SemSegEvaluator` — the same
quantities cityscapesscripts reports, at box/pixel granularity.
"""
from __future__ import annotations

import logging
from collections import OrderedDict

import numpy as np

from lvc_tpu_torch.data.cityscapes import CITYSCAPES_THING_CLASSES
from lvc_tpu_torch.data.coco_api import COCO
from lvc_tpu_torch.evaluation.coco_eval import COCOeval
from lvc_tpu_torch.evaluation.sem_seg_evaluation import SemSegEvaluator

logger = logging.getLogger(__name__)


class CityscapesInstanceEvaluator:
    """AP over the 8 thing classes via the COCO matching protocol."""

    def __init__(self, dataset_name: str = ""):
        self._dataset_name = dataset_name
        self.reset()

    def reset(self):
        self._images = {}
        self._gt = []
        self._dt = []

    def process_image(self, image_id: int, hw, gt_boxes, gt_classes, dets):
        """gt_boxes: (G, 4) XYXY; dets: one image's padded Detections."""
        h, w = hw
        self._images[image_id] = (h, w)
        for b, c in zip(np.asarray(gt_boxes), np.asarray(gt_classes)):
            self._gt.append(
                {
                    "image_id": int(image_id),
                    "category_id": int(c) + 1,
                    "bbox": [
                        float(b[0]), float(b[1]),
                        float(b[2] - b[0]), float(b[3] - b[1]),
                    ],
                    "iscrowd": 0,
                }
            )
        boxes = np.asarray(dets.boxes)
        scores = np.asarray(dets.scores)
        classes = np.asarray(dets.classes)
        valid = np.asarray(dets.valid)
        for b, s, c, v in zip(boxes, scores, classes, valid):
            if not v:
                continue
            self._dt.append(
                {
                    "image_id": int(image_id),
                    "category_id": int(c) + 1,
                    "bbox": [
                        float(b[0]), float(b[1]),
                        float(b[2] - b[0]), float(b[3] - b[1]),
                    ],
                    "score": float(s),
                }
            )

    def evaluate(self) -> "OrderedDict":
        gt = COCO(
            {
                "images": [
                    {"id": i, "height": h, "width": w}
                    for i, (h, w) in self._images.items()
                ],
                "categories": [
                    {"id": i + 1, "name": n}
                    for i, n in enumerate(CITYSCAPES_THING_CLASSES)
                ],
                "annotations": [
                    dict(a, id=j + 1, area=a["bbox"][2] * a["bbox"][3])
                    for j, a in enumerate(self._gt)
                ],
            }
        )
        if not self._dt:
            return OrderedDict({"bbox": {"AP": 0.0, "AP50": 0.0, "protocol": "coco-box"}})
        dt = gt.loadRes(self._dt)
        E = COCOeval(gt, dt)
        E.evaluate()
        E.accumulate()
        stats = E.summarize()
        # reported under "bbox": the reference's cityscapesscripts metric
        # is mask AP ("segm"); ours is box AP via the COCO protocol, and the
        # key + protocol tag make that substitution visible downstream
        return OrderedDict(
            {"bbox": {"AP": 100 * stats[0], "AP50": 100 * stats[1], "protocol": "coco-box"}}
        )


class CityscapesSemSegEvaluator(SemSegEvaluator):
    """Pixel IoU over the cityscapes label space (reference :122-170);
    defaults to the 19 train classes + 255 ignore."""

    def __init__(self, dataset_name: str = "", num_classes: int = 19, ignore_label: int = 255):
        super().__init__(dataset_name, num_classes=num_classes, ignore_label=ignore_label)
