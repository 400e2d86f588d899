"""LVIS detection evaluation: a copy of
``lvc_tpu/evaluation/lvis_evaluation.py`` (``LVISEval``:28,
``LVISEvaluator``:77) on the port's ``COCOeval``.

``LVISEval`` sets ``maxDets=[300]`` and overrides ``evaluateImg`` with the
LVIS ignore rule: on an image where a category has no ground truth and is
not in ``neg_category_ids``, or is in ``not_exhaustive_category_ids``, its
unmatched detections are ignored rather than false positives. The port's
``COCOeval.evaluate`` calls ``self.evaluateImg`` in Python, so the override
takes effect. ``LVISEvaluator`` maps contiguous ids to the json's sorted
category ids, writes ``lvis_instances_results.json`` and reports
``AP``..``APl`` and APr/APc/APf from the categories' ``frequency`` (or their
``image_count``). It is a ``COCOEvaluator``: it takes the port's
``Detections`` (or the context model's dict) on any device, one copy to the
host per batch; in a data-parallel run ``evaluate`` gathers the rows to the
main rank and returns an empty dict on the others.
"""
from __future__ import annotations

import copy
import json
import logging
import os
from collections import OrderedDict
from typing import Dict, Optional

import numpy as np

from lvc_tpu_torch.evaluation.coco_eval import COCOeval
from lvc_tpu_torch.evaluation.coco_evaluation import COCOEvaluator

logger = logging.getLogger(__name__)


class LVISEval(COCOeval):
    """COCOeval with LVIS params and neg/not-exhaustive ignore handling."""

    def __init__(self, cocoGt=None, cocoDt=None, iouType="bbox"):
        super().__init__(cocoGt, cocoDt, iouType)
        self.params.maxDets = [300]
        # per-image category knowledge
        self._img_neg: Dict[int, set] = {}
        self._img_nex: Dict[int, set] = {}
        if cocoGt is not None:
            for img_id, img in cocoGt.imgs.items():
                self._img_neg[img_id] = set(img.get("neg_category_ids", []))
                self._img_nex[img_id] = set(img.get("not_exhaustive_category_ids", []))

    def evaluateImg(self, imgId, catId, aRng, maxDet):
        out = super().evaluateImg(imgId, catId, aRng, maxDet)
        if out is None:
            return None
        # LVIS: on images where the category is neither positively nor
        # negatively annotated, unmatched detections are ignored
        has_gt = len(out["gtIds"]) > 0
        neg = catId in self._img_neg.get(imgId, set())
        nex = catId in self._img_nex.get(imgId, set())
        if (not has_gt and not neg) or nex:
            dtIg = np.asarray(out["dtIgnore"])
            dtm = np.asarray(out["dtMatches"])
            out["dtIgnore"] = np.logical_or(dtIg, dtm == 0)
        return out

    def summarize(self):
        md = self.params.maxDets[-1]
        self.stats = np.array(
            [
                self._summarize(1, maxDets=md),
                self._summarize(1, iouThr=0.5, maxDets=md),
                self._summarize(1, iouThr=0.75, maxDets=md),
                self._summarize(1, areaRng="small", maxDets=md),
                self._summarize(1, areaRng="medium", maxDets=md),
                self._summarize(1, areaRng="large", maxDets=md),
                self._summarize(0, maxDets=md),
                self._summarize(0, maxDets=md),
                self._summarize(0, maxDets=md),
                self._summarize(0, areaRng="small", maxDets=md),
                self._summarize(0, areaRng="medium", maxDets=md),
                self._summarize(0, areaRng="large", maxDets=md),
            ]
        )
        return self.stats


class LVISEvaluator(COCOEvaluator):
    """``COCOEvaluator``'s rows and shard merge, with the contiguous ids
    left as they are until ``evaluate`` maps them to the json's sorted
    category ids."""

    def __init__(self, dataset_name: str, cfg=None, output_dir: Optional[str] = None):
        super().__init__(dataset_name, cfg, output_dir)
        self._reverse_id_map = None

    def evaluate(self) -> OrderedDict:
        if not self._gather():
            return OrderedDict()
        results = copy.deepcopy(self._predictions)
        # contiguous -> LVIS category ids (sorted order at registration)
        cat_ids = sorted(self._coco_api.cats.keys()) if self._coco_api.cats else []
        for r in results:
            if cat_ids:
                r["category_id"] = cat_ids[r["category_id"]]
        if self._output_dir:
            os.makedirs(self._output_dir, exist_ok=True)
            with open(os.path.join(self._output_dir, "lvis_instances_results.json"), "w") as f:
                json.dump(results, f)
        out = OrderedDict()
        if not self._do_evaluation or not results:
            return out
        lvis_dt = self._coco_api.loadRes(results)
        ev = LVISEval(self._coco_api, lvis_dt)
        ev.evaluate()
        ev.accumulate()
        ev.summarize()
        metrics = ["AP", "AP50", "AP75", "APs", "APm", "APl"]
        out["bbox"] = {m: float(ev.stats[i] * 100) for i, m in enumerate(metrics)}
        out["bbox"].update(self._frequency_splits(ev, cat_ids))
        logger.info("LVIS eval: %s", out["bbox"])
        return out

    def _frequency_splits(self, ev, cat_ids) -> Dict[str, float]:
        """APr/APc/APf: AP averaged over rare/common/frequent categories
        (reference lvc/evaluation/lvis_evaluation.py:150 via the lvis API).
        Frequency comes from the category's ``frequency`` field (LVIS v1)
        or is derived from ``image_count`` (rare 1-10, common 11-100,
        frequent >100 — the LVIS paper's definition)."""
        # precision: (T, R, K, A, M); area "all" = 0, last maxDets
        prec = ev.eval["precision"][:, :, :, 0, -1]  # (T, R, K)
        per_cat = np.full(prec.shape[2], np.nan)
        for k in range(prec.shape[2]):
            p = prec[:, :, k]
            p = p[p > -1]
            if p.size:
                per_cat[k] = p.mean()

        def freq_of(cat):
            f = cat.get("frequency")
            if f:
                return f
            n = cat.get("image_count", 0)
            return "r" if n <= 10 else ("c" if n <= 100 else "f")

        groups = {"r": [], "c": [], "f": []}
        for k, cid in enumerate(cat_ids):
            groups[freq_of(self._coco_api.cats[cid])].append(per_cat[k])
        out = {}
        for key, name in (("r", "APr"), ("c", "APc"), ("f", "APf")):
            vals = [v for v in groups[key] if not np.isnan(v)]
            out[name] = float(np.mean(vals) * 100) if vals else float("nan")
        return out
