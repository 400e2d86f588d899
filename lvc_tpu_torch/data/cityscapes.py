"""Cityscapes dataset loading: a copy of ``lvc_tpu/data/cityscapes.py`` (the
port keeps its own).

Counterpart of the vendored ``detectron2/data/datasets/cityscapes.py``
(get_cityscapes_files:27, load_cityscapes_instances:53,
load_cityscapes_semantic:95): walks the ``leftImg8bit`` / ``gtFine``
directory layout, pairs each city image with its ``instanceIds``/
``labelIds``/``polygons`` annotation files, and emits standard dataset
dicts. Instances come from the polygon json (no cityscapesscripts
dependency): objects whose label ends in "group" or is not a thing class
are skipped, boxes derive from the polygon extent.
"""
from __future__ import annotations

import json
import logging
import os
from typing import List, Tuple

logger = logging.getLogger(__name__)

# the 8 cityscapes "thing" classes, in the canonical contiguous order
CITYSCAPES_THING_CLASSES = [
    "person", "rider", "car", "truck", "bus", "train", "motorcycle", "bicycle",
]
_THING_TO_CONTIGUOUS = {n: i for i, n in enumerate(CITYSCAPES_THING_CLASSES)}


def get_cityscapes_files(image_dir: str, gt_dir: str) -> List[Tuple[str, str, str, str]]:
    """(image, instanceIds, labelIds, polygons-json) file tuples per frame."""
    files = []
    for city in sorted(os.listdir(image_dir)):
        city_img_dir = os.path.join(image_dir, city)
        city_gt_dir = os.path.join(gt_dir, city)
        if not os.path.isdir(city_img_dir):
            continue
        for basename in sorted(os.listdir(city_img_dir)):
            if not basename.endswith("leftImg8bit.png"):
                continue
            prefix = basename[: -len("leftImg8bit.png")]
            files.append(
                (
                    os.path.join(city_img_dir, basename),
                    os.path.join(city_gt_dir, prefix + "gtFine_instanceIds.png"),
                    os.path.join(city_gt_dir, prefix + "gtFine_labelIds.png"),
                    os.path.join(city_gt_dir, prefix + "gtFine_polygons.json"),
                )
            )
    assert files, f"No cityscapes images found in {image_dir}"
    return files


def load_cityscapes_instances(image_dir: str, gt_dir: str) -> List[dict]:
    """Dataset dicts with instance annotations from the polygon jsons."""
    out = []
    for idx, (img_file, _, _, poly_file) in enumerate(
        get_cityscapes_files(image_dir, gt_dir)
    ):
        with open(poly_file) as f:
            poly = json.load(f)
        annos = []
        for obj in poly.get("objects", []):
            label = obj["label"]
            if label.endswith("group"):
                label = label[: -len("group")]
            if label not in _THING_TO_CONTIGUOUS:
                continue
            xs = [p[0] for p in obj["polygon"]]
            ys = [p[1] for p in obj["polygon"]]
            x0, y0, x1, y1 = min(xs), min(ys), max(xs), max(ys)
            if x1 <= x0 or y1 <= y0:
                continue
            annos.append(
                {
                    "category_id": _THING_TO_CONTIGUOUS[label],
                    "bbox": [x0, y0, x1 - x0, y1 - y0],
                    "bbox_mode": 1,  # XYWH_ABS
                    "iscrowd": 1 if obj["label"].endswith("group") else 0,
                    "segmentation": [
                        [c for p in obj["polygon"] for c in p]
                    ],
                }
            )
        out.append(
            {
                "file_name": img_file,
                "image_id": idx,
                "height": poly["imgHeight"],
                "width": poly["imgWidth"],
                "annotations": annos,
            }
        )
    return out


def load_cityscapes_semantic(image_dir: str, gt_dir: str) -> List[dict]:
    """Dataset dicts with ``sem_seg_file_name`` pointing at labelIds maps."""
    out = []
    for idx, (img_file, _, label_file, poly_file) in enumerate(
        get_cityscapes_files(image_dir, gt_dir)
    ):
        with open(poly_file) as f:
            poly = json.load(f)
        out.append(
            {
                "file_name": img_file,
                "image_id": idx,
                "height": poly["imgHeight"],
                "width": poly["imgWidth"],
                "sem_seg_file_name": label_file,
            }
        )
    return out


def register_cityscapes(root: str, split: str = "val"):
    """Register instance + semantic variants in the catalogs
    (reference data/datasets/builtin.py cityscapes block)."""
    from lvc_tpu_torch.data.catalog import DatasetCatalog, MetadataCatalog

    image_dir = os.path.join(root, "leftImg8bit", split)
    gt_dir = os.path.join(root, "gtFine", split)
    inst = f"cityscapes_fine_instance_seg_{split}"
    sem = f"cityscapes_fine_sem_seg_{split}"
    DatasetCatalog.register(
        inst, lambda: load_cityscapes_instances(image_dir, gt_dir)
    )
    MetadataCatalog.get(inst).set(
        thing_classes=list(CITYSCAPES_THING_CLASSES),
        evaluator_type="cityscapes_instance",
        image_dir=image_dir,
        gt_dir=gt_dir,
    )
    DatasetCatalog.register(
        sem, lambda: load_cityscapes_semantic(image_dir, gt_dir)
    )
    MetadataCatalog.get(sem).set(
        evaluator_type="cityscapes_sem_seg", image_dir=image_dir, gt_dir=gt_dir
    )
    return inst, sem
