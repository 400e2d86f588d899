"""Semantic segmentation evaluation (mIoU family): a copy of
``lvc_tpu/evaluation/sem_seg_evaluation.py`` (the port keeps its own).

Counterpart of the vendored ``detectron2/evaluation/sem_seg_evaluation.py``:
accumulates an (N+1)x(N+1) confusion matrix over predicted/ground-truth
label maps (ignore label excluded) and reports mIoU, fwIoU, mACC, pACC and
per-class IoU/ACC with the reference's formulas.
"""
from __future__ import annotations

import logging
from collections import OrderedDict
from typing import List, Optional

import numpy as np

logger = logging.getLogger(__name__)


class SemSegEvaluator:
    """Evaluate per-pixel class predictions against int label maps."""

    def __init__(
        self,
        dataset_name: str = "",
        num_classes: int = 54,
        ignore_label: int = 255,
        class_names: Optional[List[str]] = None,
    ):
        self._dataset_name = dataset_name
        self._num_classes = num_classes
        self._ignore_label = ignore_label
        self._class_names = class_names
        self.reset()

    def reset(self):
        self._conf_matrix = np.zeros(
            (self._num_classes + 1, self._num_classes + 1), dtype=np.int64
        )

    def process(self, pred: np.ndarray, gt: np.ndarray):
        """pred/gt: (H, W) int label maps (pred may also be (H, W, C) logits)."""
        pred = np.asarray(pred)
        if pred.ndim == 3:  # NHWC logits: the port's NCHW head output is moved to (H, W, C) first
            pred = pred.argmax(axis=-1)
        pred = pred.astype(np.int64)
        gt = np.asarray(gt, np.int64)
        # ignore pixels fold into the extra row/col of the confusion matrix;
        # out-of-range predictions fold the same way (defensive)
        gt = np.where(gt == self._ignore_label, self._num_classes, gt)
        pred = np.clip(pred, 0, self._num_classes)
        self._conf_matrix += np.bincount(
            (self._num_classes + 1) * pred.reshape(-1) + gt.reshape(-1),
            minlength=self._conf_matrix.size,
        ).reshape(self._conf_matrix.shape)

    def evaluate(self) -> "OrderedDict":
        """Reference metric formulas (sem_seg_evaluation.py:105-140); under
        data parallelism the ranks' confusion matrices are summed on the
        main rank, the others get an empty dict."""
        from lvc_tpu_torch.utils import comm

        if comm.get_world_size() > 1:
            shards = comm.all_gather_objects(self._conf_matrix)
            if not comm.is_main_process():
                return OrderedDict()
            self._conf_matrix = np.sum(shards, axis=0)
        acc = np.full(self._num_classes, np.nan, dtype=np.float64)
        iou = np.full(self._num_classes, np.nan, dtype=np.float64)
        tp = self._conf_matrix.diagonal()[:-1].astype(np.float64)
        pos_gt = np.sum(self._conf_matrix[:-1, :-1], axis=0).astype(np.float64)
        class_weights = pos_gt / np.maximum(np.sum(pos_gt), 1)
        pos_pred = np.sum(self._conf_matrix[:-1, :-1], axis=1).astype(np.float64)
        acc_valid = pos_gt > 0
        acc[acc_valid] = tp[acc_valid] / pos_gt[acc_valid]
        iou_valid = (pos_gt + pos_pred) > 0
        union = pos_gt + pos_pred - tp
        iou[iou_valid] = tp[iou_valid] / union[iou_valid]
        macc = np.sum(acc[acc_valid]) / max(np.sum(acc_valid), 1)
        miou = np.sum(iou[iou_valid]) / max(np.sum(iou_valid), 1)
        fiou = np.sum(iou[iou_valid] * class_weights[iou_valid])
        pacc = np.sum(tp) / max(np.sum(pos_gt), 1)

        res = OrderedDict()
        res["mIoU"] = 100 * miou
        res["fwIoU"] = 100 * fiou
        res["mACC"] = 100 * macc
        res["pACC"] = 100 * pacc
        names = self._class_names or [str(i) for i in range(self._num_classes)]
        for i, name in enumerate(names[: self._num_classes]):
            res[f"IoU-{name}"] = 100 * (iou[i] if np.isfinite(iou[i]) else 0.0)
            res[f"ACC-{name}"] = 100 * (acc[i] if np.isfinite(acc[i]) else 0.0)
        return OrderedDict({"sem_seg": res})
