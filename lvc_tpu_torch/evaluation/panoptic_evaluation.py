"""Panoptic quality (PQ) evaluation: a copy of
``lvc_tpu/evaluation/panoptic_evaluation.py`` (the port keeps its own).

Counterpart of the vendored ``detectron2/evaluation/panoptic_evaluation.py``
(which defers to the COCO ``panopticapi``; not in this image). The PQ
metric itself is computed directly from segment-id maps + segment-info
lists, with the standard definition (Kirillov et al., Panoptic
Segmentation, CVPR 2019):

    PQ = sum_{TP} IoU / (|TP| + 0.5 |FP| + 0.5 |FN|)
    SQ = sum_{TP} IoU / |TP|,  RQ = |TP| / (|TP| + 0.5 |FP| + 0.5 |FN|)

Matching: predicted and gt segments of the same category match iff IoU of
their pixel sets (computed over non-void pixels) is strictly > 0.5 — the
threshold makes matches unique. Unmatched gt segments count FN; unmatched
predicted segments whose overlap with void is <= 0.5 of their area count FP.
"""
from __future__ import annotations

from collections import OrderedDict, defaultdict
from typing import Dict, List, Tuple

import numpy as np

VOID = 0  # segment id 0 = unlabeled in both maps


def pq_single_image(
    pan_gt: np.ndarray,
    segments_gt: List[dict],
    pan_pred: np.ndarray,
    segments_pred: List[dict],
) -> Dict[int, Dict[str, float]]:
    """Per-category {iou_sum, tp, fp, fn} contributions for one image.

    Crowd handling follows panopticapi (pq_compute_single_core): gt
    segments with ``iscrowd`` participate neither in matching nor in FN
    counting, and an unmatched prediction is excused (not FP) when its
    overlap with void plus the same-category crowd segment exceeds half
    its area.
    """
    gt_cat = {s["id"]: s["category_id"] for s in segments_gt}
    pred_cat = {s["id"]: s["category_id"] for s in segments_pred}
    crowd_ids = {s["id"] for s in segments_gt if s.get("iscrowd")}
    # per-category crowd segment id (panopticapi keeps one per category)
    crowd_by_cat = {s["category_id"]: s["id"] for s in segments_gt if s.get("iscrowd")}

    # joint histogram of (gt_id, pred_id) pixel pairs
    combined = pan_gt.astype(np.int64) * (2 ** 32) + pan_pred.astype(np.int64)
    ids, counts = np.unique(combined, return_counts=True)
    inter: Dict[Tuple[int, int], int] = {}
    for v, c in zip(ids, counts):
        inter[(int(v // 2 ** 32), int(v % 2 ** 32))] = int(c)

    gt_area = defaultdict(int)
    pred_area = defaultdict(int)
    for (g, p), c in inter.items():
        gt_area[g] += c
        pred_area[p] += c

    stats: Dict[int, Dict[str, float]] = defaultdict(
        lambda: {"iou_sum": 0.0, "tp": 0, "fp": 0, "fn": 0}
    )
    matched_gt, matched_pred = set(), set()
    for (g, p), c in inter.items():
        if g == VOID or p == VOID or g in crowd_ids:
            continue
        if gt_cat.get(g) != pred_cat.get(p):
            continue
        # panopticapi union rule: gt-void pixels inside the pred segment
        # don't count against it
        union = gt_area[g] + pred_area[p] - c - inter.get((VOID, p), 0)
        iou = c / union if union > 0 else 0.0
        if iou > 0.5:
            cat = gt_cat[g]
            stats[cat]["tp"] += 1
            stats[cat]["iou_sum"] += iou
            matched_gt.add(g)
            matched_pred.add(p)

    for g, cat in gt_cat.items():
        if g == VOID or g in matched_gt or g in crowd_ids:
            continue
        stats[cat]["fn"] += 1
    for p, cat in pred_cat.items():
        if p == VOID or p in matched_pred or pred_area.get(p, 0) == 0:
            continue
        # segments mostly covering void (plus the same-category crowd
        # region) don't count as FP (panopticapi rule)
        excused = inter.get((VOID, p), 0)
        if cat in crowd_by_cat:
            excused += inter.get((crowd_by_cat[cat], p), 0)
        if excused / pred_area[p] > 0.5:
            continue
        stats[cat]["fp"] += 1
    return stats


class COCOPanopticEvaluator:
    """Accumulate PQ over images; reports PQ/SQ/RQ overall and per
    things/stuff split (reference panoptic_evaluation.py surface)."""

    def __init__(self, thing_category_ids=(), stuff_category_ids=()):
        self._things = set(thing_category_ids)
        self._stuff = set(stuff_category_ids)
        self.reset()

    def reset(self):
        self._stats: Dict[int, Dict[str, float]] = defaultdict(
            lambda: {"iou_sum": 0.0, "tp": 0, "fp": 0, "fn": 0}
        )

    def process(self, pan_gt, segments_gt, pan_pred, segments_pred):
        per_cat = pq_single_image(pan_gt, segments_gt, pan_pred, segments_pred)
        for cat, s in per_cat.items():
            acc = self._stats[cat]
            for k in ("iou_sum", "tp", "fp", "fn"):
                acc[k] += s[k]

    @staticmethod
    def _pq_sq_rq(stats_list):
        tp = sum(s["tp"] for s in stats_list)
        fp = sum(s["fp"] for s in stats_list)
        fn = sum(s["fn"] for s in stats_list)
        iou = sum(s["iou_sum"] for s in stats_list)
        denom = tp + 0.5 * fp + 0.5 * fn
        if denom == 0:
            return 0.0, 0.0, 0.0
        sq = iou / tp if tp else 0.0
        rq = tp / denom
        return 100 * iou / denom, 100 * sq, 100 * rq

    def evaluate(self) -> "OrderedDict":
        from lvc_tpu_torch.utils import comm

        if comm.get_world_size() > 1:
            shards = comm.all_gather_objects(dict(self._stats))
            if not comm.is_main_process():
                return OrderedDict()
            for shard in shards[1:]:
                for cat, st in shard.items():
                    acc = self._stats[cat]
                    for k in ("iou_sum", "tp", "fp", "fn"):
                        acc[k] += st[k]
        # per-category PQ averaged (the panopticapi convention), plus splits
        per_cat = {
            cat: self._pq_sq_rq([s]) for cat, s in self._stats.items()
        }
        def avg(cats):
            vals = [per_cat[c] for c in cats if c in per_cat]
            if not vals:
                return 0.0, 0.0, 0.0
            return tuple(float(np.mean([v[i] for v in vals])) for i in range(3))

        all_cats = list(per_cat)
        pq, sq, rq = avg(all_cats)
        res = OrderedDict()
        res["PQ"] = pq
        res["SQ"] = sq
        res["RQ"] = rq
        if self._things:
            res["PQ_th"], res["SQ_th"], res["RQ_th"] = avg(
                [c for c in all_cats if c in self._things]
            )
        if self._stuff:
            res["PQ_st"], res["SQ_st"], res["RQ_st"] = avg(
                [c for c in all_cats if c in self._stuff]
            )
        return OrderedDict({"panoptic_seg": res})
