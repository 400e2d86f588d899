"""Minimal COCO dataset API (a pycocotools.coco.COCO-compatible subset).

A copy of the index, ``getAnnIds`` and ``loadAnns`` of
``lvc_tpu/data/coco_api.py::COCO``, the part the verification path uses
(the other getters, ``loadRes`` and ``COCO_PK`` are not ported yet), kept so
that the port never imports the JAX package.
"""
from __future__ import annotations

import json
from collections import defaultdict
from typing import Dict, List, Optional, Union


class COCO:
    def __init__(self, annotation_file: Optional[Union[str, dict]] = None):
        self.dataset: dict = {}
        self.anns: Dict[int, dict] = {}
        self.imgs: Dict[int, dict] = {}
        self.cats: Dict[int, dict] = {}
        self.imgToAnns: Dict[int, List[dict]] = defaultdict(list)
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
        imgToAnns = defaultdict(list)
        for ann in self.dataset.get("annotations", []):
            imgToAnns[ann["image_id"]].append(ann)
            anns[ann["id"]] = ann
        for img in self.dataset.get("images", []):
            imgs[img["id"]] = img
        for cat in self.dataset.get("categories", []):
            cats[cat["id"]] = cat
        self.anns, self.imgs, self.cats = anns, imgs, cats
        self.imgToAnns = imgToAnns

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

    def loadAnns(self, ids=[]) -> List[dict]:
        return [self.anns[i] for i in _as_list(ids)]


def _as_list(x):
    return x if isinstance(x, (list, tuple)) else [x]
