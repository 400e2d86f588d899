"""Minimal COCO dataset API (pycocotools.coco.COCO-compatible subset).

A copy of ``lvc_tpu/data/coco_api.py`` (the port keeps its own; pycocotools
is not a dependency): ann/img/cat indices, ranged ``getAnnIds`` and
``loadRes`` for bbox and segmentation result lists (a segmentation row's
area and bbox come from its mask), and ``COCO_PK``, the mining tool's
area-ratio index.
"""
from __future__ import annotations

import copy
import json
from collections import defaultdict
from typing import Dict, List, Optional, Union

import numpy as np

from lvc_tpu_torch.structures.masks import polygons_to_bitmask, rle_to_bitmask


class COCO:
    def __init__(self, annotation_file: Optional[Union[str, dict]] = None):
        self.dataset: dict = {}
        self.anns: Dict[int, dict] = {}
        self.imgs: Dict[int, dict] = {}
        self.cats: Dict[int, dict] = {}
        self.imgToAnns: Dict[int, List[dict]] = defaultdict(list)
        self.catToImgs: Dict[int, List[int]] = defaultdict(list)
        if annotation_file is not None:
            if isinstance(annotation_file, dict):
                self.dataset = annotation_file
            else:
                with open(annotation_file, "r") as f:
                    self.dataset = json.load(f)
            assert isinstance(self.dataset, dict)
            self.createIndex()

    def createIndex(self):
        anns, cats, imgs = {}, {}, {}
        imgToAnns, catToImgs = defaultdict(list), defaultdict(list)
        for ann in self.dataset.get("annotations", []):
            imgToAnns[ann["image_id"]].append(ann)
            anns[ann["id"]] = ann
        for img in self.dataset.get("images", []):
            imgs[img["id"]] = img
        for cat in self.dataset.get("categories", []):
            cats[cat["id"]] = cat
        for ann in self.dataset.get("annotations", []):
            catToImgs[ann["category_id"]].append(ann["image_id"])
        self.anns, self.imgs, self.cats = anns, imgs, cats
        self.imgToAnns, self.catToImgs = imgToAnns, catToImgs

    # ------------------------------------------------------------------ get
    def getAnnIds(self, imgIds=[], catIds=[], areaRng=[], iscrowd=None) -> List[int]:
        imgIds = _as_list(imgIds)
        catIds = _as_list(catIds)
        if len(imgIds) == len(catIds) == len(areaRng) == 0:
            anns = self.dataset.get("annotations", [])
        else:
            if len(imgIds) > 0:
                lists = [self.imgToAnns[i] for i in imgIds if i in self.imgToAnns]
                anns = [a for sub in lists for a in sub]
            else:
                anns = self.dataset.get("annotations", [])
            if len(catIds) > 0:
                cat_set = set(catIds)
                anns = [a for a in anns if a["category_id"] in cat_set]
            if len(areaRng) > 0:
                anns = [a for a in anns if areaRng[0] < a["area"] < areaRng[1]]
        if iscrowd is not None:
            return [a["id"] for a in anns if a.get("iscrowd", 0) == iscrowd]
        return [a["id"] for a in anns]

    def getCatIds(self, catNms=[], supNms=[], catIds=[]) -> List[int]:
        catNms, supNms, catIds = map(_as_list, (catNms, supNms, catIds))
        cats = self.dataset.get("categories", [])
        if catNms:
            cats = [c for c in cats if c["name"] in catNms]
        if supNms:
            cats = [c for c in cats if c.get("supercategory") in supNms]
        if catIds:
            cats = [c for c in cats if c["id"] in catIds]
        return [c["id"] for c in cats]

    def getImgIds(self, imgIds=[], catIds=[]) -> List[int]:
        imgIds = _as_list(imgIds)
        catIds = _as_list(catIds)
        if len(imgIds) == len(catIds) == 0:
            return list(self.imgs.keys())
        ids = set(imgIds) if imgIds else set(self.imgs.keys())
        if catIds:
            for i, cat in enumerate(catIds):
                imgs_c = set(self.catToImgs[cat])
                ids = imgs_c if (i == 0 and not imgIds) else ids & imgs_c
        return list(ids)

    def loadAnns(self, ids=[]) -> List[dict]:
        return [self.anns[i] for i in _as_list(ids)]

    def loadCats(self, ids=[]) -> List[dict]:
        return [self.cats[i] for i in _as_list(ids)]

    def loadImgs(self, ids=[]) -> List[dict]:
        return [self.imgs[i] for i in _as_list(ids)]

    # ------------------------------------------------------------- loadRes
    def loadRes(self, resFile: Union[str, list]) -> "COCO":
        """Create a result COCO from a detection list/file
        (pycocotools semantics for bbox results)."""
        res = COCO()
        res.dataset["images"] = [img for img in self.dataset["images"]]
        if isinstance(resFile, str):
            with open(resFile) as f:
                anns = json.load(f)
        else:
            anns = resFile
        assert isinstance(anns, list), "results must be a list"
        if len(anns) == 0:
            res.dataset["annotations"] = []
            res.dataset["categories"] = copy.deepcopy(self.dataset["categories"])
            res.createIndex()
            return res
        anns_img_ids = set(a["image_id"] for a in anns)
        assert anns_img_ids <= set(self.getImgIds()), "results contain unknown images"
        anns = copy.deepcopy(anns)
        if "bbox" in anns[0] and anns[0]["bbox"] != []:
            res.dataset["categories"] = copy.deepcopy(self.dataset["categories"])
            for i, ann in enumerate(anns):
                bb = ann["bbox"]
                if "area" not in ann:
                    ann["area"] = bb[2] * bb[3]
                ann["id"] = i + 1
                ann.setdefault("iscrowd", 0)
        elif "segmentation" in anns[0]:
            # segm results (bbox popped by the caller): area and bbox come
            # from the mask (pycocotools loadRes maskUtils.area/toBbox
            # semantics), so S/M/L area ranges follow the mask for segm eval
            res.dataset["categories"] = copy.deepcopy(self.dataset["categories"])
            for i, ann in enumerate(anns):
                seg = ann["segmentation"]
                if isinstance(seg, dict):
                    m = rle_to_bitmask(seg)
                else:
                    img = self.imgs[ann["image_id"]]
                    m = polygons_to_bitmask(seg, img["height"], img["width"])
                ann["area"] = float(m.sum())
                if "bbox" not in ann:
                    ys, xs = np.nonzero(m)
                    if len(xs):
                        x0, y0 = float(xs.min()), float(ys.min())
                        ann["bbox"] = [x0, y0, float(xs.max()) + 1 - x0, float(ys.max()) + 1 - y0]
                    else:
                        ann["bbox"] = [0.0, 0.0, 0.0, 0.0]
                ann["id"] = i + 1
                ann.setdefault("iscrowd", 0)
        res.dataset["annotations"] = anns
        res.createIndex()
        return res


def _as_list(x):
    return x if isinstance(x, (list, tuple)) else [x]


class COCO_PK(COCO):
    """COCO with an area-ratio index and getAnnIds ranged by it, mirroring the
    candidate-filter tool's extension
    (tools/create_coco_dataset_from_dets_all.py:14-53); JAX's copy also takes
    a score range, which no tool passes."""

    def createIndex(self):
        super().createIndex()
        for ann in self.dataset.get("annotations", []):
            img = self.imgs[ann["image_id"]]
            img_area = img["height"] * img["width"]
            ann["area_ratio"] = ann["area"] / img_area

    def getAnnIds(self, imgIds=[], catIds=[], areaRng=[], iscrowd=None, areaRatioRng=[]) -> List[int]:
        ids = super().getAnnIds(imgIds, catIds, areaRng, iscrowd)
        anns = [self.anns[i] for i in ids]
        if areaRatioRng:
            anns = [
                a for a in anns if areaRatioRng[0] <= a.get("area_ratio", 0.0) < areaRatioRng[1]
            ]
        return [a["id"] for a in anns]
