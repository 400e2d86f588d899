"""C++-accelerated COCOeval, a copy of ``lvc_tpu/evaluation/fast_eval_api.py``
(the port keeps its own; counterpart of the reference's
detectron2/evaluation/fast_eval_api.py + csrc/cocoeval/cocoeval.cpp).

``COCOeval_opt`` keeps IoU computation vectorized in numpy and moves the
greedy per-(image, category) matching across all thresholds AND area
ranges into one native call. Falls back to the pure-python COCOeval when
the shared library can't be built (logged). It is built lazily with g++
into ``build/native/`` (``utils/native_build.py``).
"""
from __future__ import annotations

import ctypes
import logging
import os
from typing import Optional

import numpy as np

from lvc_tpu_torch.evaluation.coco_eval import COCOeval
from lvc_tpu_torch.utils.native_build import build_shared_lib

logger = logging.getLogger(__name__)

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _load_lib() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    src = os.path.join(_CSRC, "cocoeval.cpp")
    try:
        lib_path = build_shared_lib("cocoeval", src)
        if lib_path is None:
            raise RuntimeError("compilation failed")
        lib = ctypes.CDLL(lib_path)
        lib.cocoeval_evaluate_img.restype = None
        lib.cocoeval_evaluate_img.argtypes = [
            ctypes.c_int64,
            np.ctypeslib.ndpointer(np.float64, flags="C"),
            ctypes.c_int64,
            ctypes.c_int64,
            np.ctypeslib.ndpointer(np.float64, flags="C"),
            np.ctypeslib.ndpointer(np.float64, flags="C"),
            np.ctypeslib.ndpointer(np.uint8, flags="C"),
            np.ctypeslib.ndpointer(np.uint8, flags="C"),
            np.ctypeslib.ndpointer(np.float64, flags="C"),
            ctypes.c_int64,
            np.ctypeslib.ndpointer(np.float64, flags="C"),
            np.ctypeslib.ndpointer(np.int64, flags="C"),
            np.ctypeslib.ndpointer(np.int64, flags="C"),
            np.ctypeslib.ndpointer(np.uint8, flags="C"),
            np.ctypeslib.ndpointer(np.uint8, flags="C"),
        ]
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C")
        f64p = np.ctypeslib.ndpointer(np.float64, flags="C")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C")
        lib.cocoeval_evaluate_batch.restype = None
        lib.cocoeval_evaluate_batch.argtypes = [
            ctypes.c_int64, f64p,                # T, thrs
            ctypes.c_int64, f64p,                # A, area_rng
            ctypes.c_int64,                      # N cells
            i64p, i64p, i64p, i64p, i64p,        # dcounts, gcounts, offsets
            f64p,                                # ious
            f64p, u8p, u8p, f64p,                # gt_area, gt_ign, gt_crowd, dt_area
            i64p, i64p, u8p, u8p,                # dtm, gtm, dt_ig, gt_ig
        ]
        _LIB = lib
        logger.info("Loaded native COCOeval kernel from %s", lib_path)
    except Exception as e:  # no g++ or no write access: the python path
        logger.warning("Native COCOeval unavailable (%s); using python path", e)
        _LIB = None
    return _LIB


class COCOeval_opt(COCOeval):
    """Same interface/results as COCOeval; native matching when available."""

    def evaluate(self):
        lib = _load_lib()
        if lib is None:
            return super().evaluate()
        p = self.params
        p.imgIds = list(np.unique(p.imgIds))
        p.catIds = list(np.unique(p.catIds)) if p.useCats else [-1]
        self._prepare()

        T = len(p.iouThrs)
        A = len(p.areaRng)
        maxDet = p.maxDets[-1]
        thrs = np.ascontiguousarray(p.iouThrs, np.float64)
        area_rng = np.ascontiguousarray(np.asarray(p.areaRng, np.float64))
        self.evalImgs = {}
        self.ious = {}

        # gather every non-empty (image, category) cell, then run the
        # native greedy matcher over ALL of them in one call: the per-cell
        # ctypes argument conversion (11 arrays x ~60k calls on a
        # COCO-sized eval) dominated the Python side before batching
        cells = []  # (imgId, catId, gt, dt_sorted)
        for catId in p.catIds:
            for imgId in p.imgIds:
                gt = self._gts[imgId, catId]
                dt = self._dts[imgId, catId]
                if len(gt) == 0 and len(dt) == 0:
                    self.ious[imgId, catId] = []
                    for aRng in p.areaRng:
                        self.evalImgs[(imgId, catId, tuple(aRng))] = None
                    continue
                dtind = np.argsort([-d["score"] for d in dt], kind="mergesort")
                dt_sorted = [dt[i] for i in dtind[:maxDet]]
                cells.append((imgId, catId, gt, dt_sorted))

        N = len(cells)
        dcounts = np.asarray([len(c[3]) for c in cells], np.int64)
        gcounts = np.asarray([len(c[2]) for c in cells], np.int64)
        d_off = np.zeros(N, np.int64)
        g_off = np.zeros(N, np.int64)
        iou_off = np.zeros(N, np.int64)
        if N:
            np.cumsum(dcounts[:-1], out=d_off[1:])
            np.cumsum(gcounts[:-1], out=g_off[1:])
            np.cumsum((dcounts * gcounts)[:-1], out=iou_off[1:])
        Dtot = int(dcounts.sum())
        Gtot = int(gcounts.sum())

        ious_flat = np.zeros(int((dcounts * gcounts).sum()), np.float64)
        gt_area = np.zeros(Gtot, np.float64)
        gt_ign = np.zeros(Gtot, np.uint8)
        gt_crowd = np.zeros(Gtot, np.uint8)
        dt_area = np.zeros(Dtot, np.float64)
        for k, (imgId, catId, gt, dt_sorted) in enumerate(cells):
            D, G = int(dcounts[k]), int(gcounts[k])
            if D and G:
                iou = np.asarray(
                    self.computeIoU(imgId, catId), np.float64
                ).reshape(D, G)
                self.ious[imgId, catId] = iou
                ious_flat[iou_off[k] : iou_off[k] + D * G] = iou.ravel()
            else:
                self.ious[imgId, catId] = self.computeIoU(imgId, catId)
            go, do = g_off[k], d_off[k]
            gt_area[go : go + G] = [g["area"] for g in gt]
            gt_ign[go : go + G] = [g["ignore"] for g in gt]
            gt_crowd[go : go + G] = [g.get("iscrowd", 0) for g in gt]
            dt_area[do : do + D] = [d["area"] for d in dt_sorted]

        dtm_all = np.zeros(A * T * Dtot, np.int64)
        gtm_all = np.zeros(A * T * Gtot, np.int64)
        dt_ig_all = np.zeros(A * T * Dtot, np.uint8)
        gt_ig_all = np.zeros(A * Gtot, np.uint8)
        if N:
            lib.cocoeval_evaluate_batch(
                T, thrs, A, area_rng, N,
                dcounts, gcounts, iou_off, d_off, g_off,
                ious_flat, gt_area, gt_ign, gt_crowd, dt_area,
                dtm_all, gtm_all, dt_ig_all, gt_ig_all,
            )

        for k, (imgId, catId, gt, dt_sorted) in enumerate(cells):
            D, G = int(dcounts[k]), int(gcounts[k])
            dtm = dtm_all[A * T * d_off[k] : A * T * (d_off[k] + D)].reshape(A, T, D)
            gtm = gtm_all[A * T * g_off[k] : A * T * (g_off[k] + G)].reshape(A, T, G)
            dt_ig = dt_ig_all[A * T * d_off[k] : A * T * (d_off[k] + D)].reshape(A, T, D)
            gt_ig = gt_ig_all[A * g_off[k] : A * (g_off[k] + G)].reshape(A, G)

            gt_ids = np.array([g["id"] for g in gt], np.int64)
            dt_ids = [d["id"] for d in dt_sorted]
            gt_ids_list = [g["id"] for g in gt]
            dt_scores = [d["score"] for d in dt_sorted]
            for a, aRng in enumerate(p.areaRng):
                # map matched original gt index -> gt id (0 stays 0)
                dtm_ids = np.where(
                    dtm[a] > 0, gt_ids[np.clip(dtm[a] - 1, 0, max(G - 1, 0))], 0
                ).astype(np.float64) if G else np.zeros((T, D))
                self.evalImgs[(imgId, catId, tuple(aRng))] = {
                    "image_id": imgId,
                    "category_id": catId,
                    "aRng": aRng,
                    "maxDet": maxDet,
                    "dtIds": dt_ids,
                    "gtIds": gt_ids_list,
                    "dtMatches": dtm_ids,
                    "gtMatches": gtm[a].astype(np.float64),
                    "dtScores": dt_scores,
                    "gtIgnore": gt_ig[a].astype(np.float64),
                    "dtIgnore": dt_ig[a].astype(bool),
                }
