"""COCO detection evaluation, self-contained: a copy of
``lvc_tpu/evaluation/coco_eval.py`` (the port keeps its own).

Faithful re-implementation of the COCOeval protocol (the reference
accelerates the same algorithm in C++: detectron2/layers/csrc/cocoeval/
cocoeval.cpp driven by evaluation/fast_eval_api.py). pycocotools is not a
dependency, so this is the port's canonical evaluator; ``fast_eval_api``'s
native matching slots in behind the same interface. The ``segm`` IoU type
decodes each annotation's polygons or RLE to packed bits (the port's
``structures/masks.py``) and counts their overlaps; against a crowd gt it
divides by the detection's area (pycocotools ``maskUtils.iou``).

Matching semantics (per image, category, IoU threshold): detections in
descending score order greedily claim the highest-IoU ground truth above
threshold; crowd ground truths may be matched repeatedly and score as
ignores; area-range filtering marks ignores, not removals.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np

from lvc_tpu_torch.structures.masks import polygons_to_bitmask, rle_to_bitmask


def bbox_iou_xywh(dets: np.ndarray, gts: np.ndarray, iscrowd: np.ndarray) -> np.ndarray:
    """IoU between dets (D, 4) and gts (G, 4) in XYWH; crowd gt uses
    intersection / det area."""
    if len(dets) == 0 or len(gts) == 0:
        return np.zeros((len(dets), len(gts)))
    dx0, dy0 = dets[:, 0], dets[:, 1]
    dx1, dy1 = dets[:, 0] + dets[:, 2], dets[:, 1] + dets[:, 3]
    gx0, gy0 = gts[:, 0], gts[:, 1]
    gx1, gy1 = gts[:, 0] + gts[:, 2], gts[:, 1] + gts[:, 3]
    iw = np.minimum(dx1[:, None], gx1[None, :]) - np.maximum(dx0[:, None], gx0[None, :])
    ih = np.minimum(dy1[:, None], gy1[None, :]) - np.maximum(dy0[:, None], gy0[None, :])
    inter = np.clip(iw, 0, None) * np.clip(ih, 0, None)
    darea = (dets[:, 2] * dets[:, 3])[:, None]
    garea = (gts[:, 2] * gts[:, 3])[None, :]
    union = np.where(iscrowd[None, :], darea, darea + garea - inter)
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


_POPCOUNT = np.array([bin(i).count("1") for i in range(256)], dtype=np.int64)


def _ann_mask_bits(ann: dict, h: int, w: int, cache: Optional[dict] = None):
    """Decode an annotation's segmentation to packed bits (np.packbits of
    the row-major flattened bool mask) + pixel area. ``cache`` (keyed by
    the ann dict's identity) lives on the COCOeval instance so the packed
    masks are freed with the evaluation instead of accumulating on the
    shared gt object (~H*W/8 bytes per ann — over a GB on COCO val)."""
    key = id(ann)
    if cache is not None:
        cached = cache.get(key)
        if cached is not None:
            return cached
    seg = ann["segmentation"]
    if isinstance(seg, dict):
        m = rle_to_bitmask(seg)
    else:
        m = polygons_to_bitmask(seg, h, w)
    out = (np.packbits(m.reshape(-1)), int(m.sum()))
    if cache is not None:
        cache[key] = out
    return out


def segm_iou(dt_bits, gt_bits, iscrowd) -> np.ndarray:
    """Mask IoU from packed-bit masks [(bits, area), ...]; crowd gt uses
    intersection / det area (pycocotools maskUtils.iou semantics)."""
    out = np.zeros((len(dt_bits), len(gt_bits)))
    for j, (gb, ga) in enumerate(gt_bits):
        for i, (db, da) in enumerate(dt_bits):
            inter = int(_POPCOUNT[np.bitwise_and(db, gb)].sum())
            union = da if iscrowd[j] else da + ga - inter
            out[i, j] = inter / union if union > 0 else 0.0
    return out


class Params:
    def __init__(self, iouType="bbox"):
        assert iouType in ("bbox", "segm"), iouType
        self.iouType = iouType
        self.imgIds: List[int] = []
        self.catIds: List[int] = []
        self.iouThrs = np.linspace(0.5, 0.95, 10)
        self.recThrs = np.linspace(0.0, 1.00, 101)
        self.maxDets = [1, 10, 100]
        self.areaRng = [
            [0**2, 1e5**2],
            [0**2, 32**2],
            [32**2, 96**2],
            [96**2, 1e5**2],
        ]
        self.areaRngLbl = ["all", "small", "medium", "large"]
        self.useCats = 1


class COCOeval:
    def __init__(self, cocoGt=None, cocoDt=None, iouType="bbox"):
        self.cocoGt = cocoGt
        self.cocoDt = cocoDt
        self.params = Params(iouType)
        self.evalImgs: Dict = {}
        self.eval: Dict = {}
        self.stats: np.ndarray = np.array([])
        self.ious: Dict = {}
        if cocoGt is not None:
            self.params.imgIds = sorted(cocoGt.getImgIds())
            self.params.catIds = sorted(cocoGt.getCatIds())

    # ---------------------------------------------------------------- prep
    def _prepare(self):
        p = self.params
        gts = self.cocoGt.loadAnns(self.cocoGt.getAnnIds(imgIds=p.imgIds, catIds=p.catIds))
        dts = self.cocoDt.loadAnns(self.cocoDt.getAnnIds(imgIds=p.imgIds, catIds=p.catIds))
        self._gts = defaultdict(list)
        self._dts = defaultdict(list)
        for gt in gts:
            gt["ignore"] = gt.get("ignore", 0) or gt.get("iscrowd", 0)
            self._gts[gt["image_id"], gt["category_id"]].append(gt)
        for dt in dts:
            self._dts[dt["image_id"], dt["category_id"]].append(dt)

    # ------------------------------------------------------------- evaluate
    def evaluate(self):
        p = self.params
        p.imgIds = list(np.unique(p.imgIds))
        p.catIds = list(np.unique(p.catIds)) if p.useCats else [-1]
        self._prepare()
        self.ious = {
            (imgId, catId): self.computeIoU(imgId, catId)
            for imgId in p.imgIds
            for catId in p.catIds
        }
        maxDet = p.maxDets[-1]
        self.evalImgs = {
            (imgId, catId, tuple(aRng)): self.evaluateImg(imgId, catId, aRng, maxDet)
            for catId in p.catIds
            for aRng in p.areaRng
            for imgId in p.imgIds
        }

    def computeIoU(self, imgId, catId):
        p = self.params
        gt = self._gts[imgId, catId]
        dt = self._dts[imgId, catId]
        if len(gt) == 0 or len(dt) == 0:
            return np.zeros((len(dt), len(gt)))
        inds = np.argsort([-d["score"] for d in dt], kind="mergesort")
        dt = [dt[i] for i in inds]
        if len(dt) > p.maxDets[-1]:
            dt = dt[: p.maxDets[-1]]
        iscrowd = np.array([x.get("iscrowd", 0) for x in gt], dtype=bool)
        if p.iouType == "segm":
            img = self.cocoGt.imgs[imgId]
            h, w = img["height"], img["width"]
            cache = getattr(self, "_mask_bits_cache", None)
            if cache is None:
                cache = self._mask_bits_cache = {}
            return segm_iou(
                [_ann_mask_bits(x, h, w, cache) for x in dt],
                [_ann_mask_bits(x, h, w, cache) for x in gt],
                iscrowd,
            )
        d = np.array([x["bbox"] for x in dt], dtype=np.float64)
        g = np.array([x["bbox"] for x in gt], dtype=np.float64)
        return bbox_iou_xywh(d, g, iscrowd)

    def evaluateImg(self, imgId, catId, aRng, maxDet):
        gt = self._gts[imgId, catId]
        dt = self._dts[imgId, catId]
        if len(gt) == 0 and len(dt) == 0:
            return None
        p = self.params

        for g in gt:
            g["_ignore"] = 1 if (g["ignore"] or g["area"] < aRng[0] or g["area"] > aRng[1]) else 0
        gtind = np.argsort([g["_ignore"] for g in gt], kind="mergesort")
        gt = [gt[i] for i in gtind]
        dtind = np.argsort([-d["score"] for d in dt], kind="mergesort")
        dt = [dt[i] for i in dtind[:maxDet]]
        iscrowd = np.array([g.get("iscrowd", 0) for g in gt], dtype=bool)
        ious = (
            self.ious[imgId, catId][:, gtind]
            if len(self.ious[imgId, catId]) > 0
            else self.ious[imgId, catId]
        )

        T = len(p.iouThrs)
        G = len(gt)
        D = len(dt)
        gtm = np.zeros((T, G))
        dtm = np.zeros((T, D))
        gtIg = np.array([g["_ignore"] for g in gt])
        dtIg = np.zeros((T, D))
        if len(ious) > 0:
            for tind, t in enumerate(p.iouThrs):
                for dind, d in enumerate(dt):
                    iou = min(t, 1 - 1e-10)
                    m = -1
                    for gind in range(G):
                        # gt already matched, and not a crowd -> unavailable
                        if gtm[tind, gind] > 0 and not iscrowd[gind]:
                            continue
                        # best non-ignored match found and remaining gts are
                        # ignored (they're sorted last) -> stop
                        if m > -1 and gtIg[m] == 0 and gtIg[gind] == 1:
                            break
                        if ious[dind, gind] < iou:
                            continue
                        iou = ious[dind, gind]
                        m = gind
                    if m == -1:
                        continue
                    dtIg[tind, dind] = gtIg[m]
                    dtm[tind, dind] = gt[m]["id"]
                    gtm[tind, m] = d["id"]
        # unmatched dets outside the area range are ignored
        a = np.array(
            [d["area"] < aRng[0] or d["area"] > aRng[1] for d in dt]
        ).reshape(1, D)
        dtIg = np.logical_or(dtIg, np.logical_and(dtm == 0, np.repeat(a, T, 0)))
        return {
            "image_id": imgId,
            "category_id": catId,
            "aRng": aRng,
            "maxDet": maxDet,
            "dtIds": [d["id"] for d in dt],
            "gtIds": [g["id"] for g in gt],
            "dtMatches": dtm,
            "gtMatches": gtm,
            "dtScores": [d["score"] for d in dt],
            "gtIgnore": gtIg,
            "dtIgnore": dtIg,
        }

    # ----------------------------------------------------------- accumulate
    def accumulate(self, p=None):
        if p is None:
            p = self.params
        T = len(p.iouThrs)
        R = len(p.recThrs)
        K = len(p.catIds)
        A = len(p.areaRng)
        M = len(p.maxDets)
        precision = -np.ones((T, R, K, A, M))
        recall = -np.ones((T, K, A, M))
        scores = -np.ones((T, R, K, A, M))

        # one pass over evalImgs instead of len(imgIds) dict probes per
        # (category, area) pair; insertion order preserves imgId order.
        # p.imgIds still restricts (re-accumulating on an image subset is
        # part of the COCOeval protocol).
        from collections import defaultdict

        img_ok = set(p.imgIds)
        grouped = defaultdict(list)
        for (imgId, catId, aRng), e in self.evalImgs.items():
            if e is not None and imgId in img_ok:
                grouped[(catId, aRng)].append(e)

        for k, catId in enumerate(p.catIds):
            for a, aRng in enumerate(p.areaRng):
                E = grouped.get((catId, tuple(aRng)), [])
                if len(E) == 0:
                    continue
                for m, maxDet in enumerate(p.maxDets):
                    dtScores = np.concatenate([e["dtScores"][:maxDet] for e in E])
                    inds = np.argsort(-dtScores, kind="mergesort")
                    dtScoresSorted = dtScores[inds]
                    dtm = np.concatenate(
                        [e["dtMatches"][:, :maxDet] for e in E], axis=1
                    )[:, inds]
                    dtIg = np.concatenate(
                        [e["dtIgnore"][:, :maxDet] for e in E], axis=1
                    )[:, inds]
                    gtIg = np.concatenate([e["gtIgnore"] for e in E])
                    npig = np.count_nonzero(gtIg == 0)
                    if npig == 0:
                        continue
                    tps = np.logical_and(dtm, np.logical_not(dtIg))
                    fps = np.logical_and(np.logical_not(dtm), np.logical_not(dtIg))
                    tp_sum = np.cumsum(tps, axis=1).astype(np.float64)
                    fp_sum = np.cumsum(fps, axis=1).astype(np.float64)
                    for t in range(T):
                        tp = tp_sum[t]
                        fp = fp_sum[t]
                        nd = len(tp)
                        rc = tp / npig
                        pr = tp / (fp + tp + np.spacing(1))
                        q = np.zeros(R)
                        ss = np.zeros(R)
                        recall[t, k, a, m] = rc[-1] if nd else 0
                        # monotone precision envelope (running max from the
                        # right) — the reference's backward python loop,
                        # vectorized; identical values
                        pr = np.maximum.accumulate(pr[::-1])[::-1]
                        inds_r = np.searchsorted(rc, p.recThrs, side="left")
                        ok = inds_r < nd
                        sel = inds_r[ok]
                        q[ok] = pr[sel]
                        ss[ok] = dtScoresSorted[sel]
                        precision[t, :, k, a, m] = q
                        scores[t, :, k, a, m] = ss
        self.eval = {
            "params": p,
            "counts": [T, R, K, A, M],
            "precision": precision,
            "recall": recall,
            "scores": scores,
        }

    # ------------------------------------------------------------ summarize
    def _summarize(self, ap=1, iouThr=None, areaRng="all", maxDets=100):
        p = self.params
        aind = [i for i, l in enumerate(p.areaRngLbl) if l == areaRng]
        mind = [i for i, m in enumerate(p.maxDets) if m == maxDets]
        if ap == 1:
            s = self.eval["precision"]
            if iouThr is not None:
                t = np.where(np.isclose(p.iouThrs, iouThr))[0]
                s = s[t]
            s = s[:, :, :, aind, mind]
        else:
            s = self.eval["recall"]
            if iouThr is not None:
                t = np.where(np.isclose(p.iouThrs, iouThr))[0]
                s = s[t]
            s = s[:, :, aind, mind]
        if len(s[s > -1]) == 0:
            return -1.0
        return float(np.mean(s[s > -1]))

    def summarize(self):
        self.stats = np.array(
            [
                self._summarize(1),
                self._summarize(1, iouThr=0.5, maxDets=self.params.maxDets[2]),
                self._summarize(1, iouThr=0.75, maxDets=self.params.maxDets[2]),
                self._summarize(1, areaRng="small", maxDets=self.params.maxDets[2]),
                self._summarize(1, areaRng="medium", maxDets=self.params.maxDets[2]),
                self._summarize(1, areaRng="large", maxDets=self.params.maxDets[2]),
                self._summarize(0, maxDets=self.params.maxDets[0]),
                self._summarize(0, maxDets=self.params.maxDets[1]),
                self._summarize(0, maxDets=self.params.maxDets[2]),
                self._summarize(0, areaRng="small", maxDets=self.params.maxDets[2]),
                self._summarize(0, areaRng="medium", maxDets=self.params.maxDets[2]),
                self._summarize(0, areaRng="large", maxDets=self.params.maxDets[2]),
            ]
        )
        return self.stats
