"""COCO-format dataset loading with few-shot split support.

A copy of ``lvc_tpu/data/meta_coco.py``, kept so that the port never imports
the JAX package. Counterpart of lvc/data/meta_coco.py:215-352 (load_coco_json knowing the
``cocosplit/.../full_box_{shot}shot_{cls}_trainval.json`` layout and K-shot
subsampling; register_meta_coco with base/novel class filtering).
Produces detectron2-standard dataset dicts (file_name, height, width,
image_id, annotations[{bbox, bbox_mode, category_id, iscrowd, ...}]).
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from lvc_tpu_torch.data.catalog import DatasetCatalog, MetadataCatalog
from lvc_tpu_torch.data.coco_api import COCO
from lvc_tpu_torch.structures.boxes import BoxMode


def datasets_root() -> str:
    return os.getenv("DETECTRON2_DATASETS", "datasets")


def load_coco_json(
    json_file: str,
    image_root: str,
    metadata: dict,
    dataset_name: str,
    extra_annotation_keys: Optional[List[str]] = None,
) -> List[dict]:
    is_shots = "shot" in dataset_name
    ann_keys = ["iscrowd", "bbox", "category_id"] + (extra_annotation_keys or [])
    id_map = metadata.get("thing_dataset_id_to_contiguous_id")
    if id_map is None:
        id_map = {i: i for i in range(len(metadata.get("thing_classes")))}

    dataset_dicts: List[dict] = []
    if is_shots:
        # per-class K-shot files under cocosplit/[seedN/]
        split_dir = os.path.join(datasets_root(), "cocosplit")
        if "seed" in dataset_name:
            shot = dataset_name.split("_")[-2].split("shot")[0]
            seed = int(dataset_name.split("_seed")[-1])
            split_dir = os.path.join(split_dir, f"seed{seed}")
        else:
            shot = dataset_name.split("_")[-1].split("shot")[0]
        for idx, cls in enumerate(metadata["thing_classes"]):
            cls_json = os.path.join(split_dir, f"full_box_{shot}shot_{cls}_trainval.json")
            coco_api = COCO(cls_json)
            img_ids = sorted(coco_api.imgs.keys())
            dicts = []
            for img_id in img_ids:
                img_dict = coco_api.imgs[img_id]
                for anno in coco_api.imgToAnns[img_id]:
                    assert anno["image_id"] == img_id
                    obj = {k: anno[k] for k in ann_keys if k in anno}
                    obj["area"] = float(obj["bbox"][-2]) * float(obj["bbox"][-1])
                    obj["bbox_mode"] = BoxMode.XYWH_ABS
                    obj["category_id"] = id_map[obj["category_id"]]
                    dicts.append(
                        {
                            "file_name": os.path.join(image_root, img_dict["file_name"]),
                            "height": img_dict["height"],
                            "width": img_dict["width"],
                            "image_id": img_id,
                            "annotations": [obj],
                        }
                    )
            if len(dicts) > int(shot):
                dicts = list(np.random.choice(dicts, int(shot), replace=False))
            dataset_dicts.extend(dicts)
    else:
        coco_api = COCO(json_file)
        for img_id in sorted(coco_api.imgs.keys()):
            img_dict = coco_api.imgs[img_id]
            objs = []
            for anno in coco_api.imgToAnns[img_id]:
                assert anno["image_id"] == img_id
                obj = {k: anno[k] for k in ann_keys if k in anno}
                obj["area"] = float(obj["bbox"][-2]) * float(obj["bbox"][-1])
                obj["bbox_mode"] = BoxMode.XYWH_ABS
                if obj["category_id"] in id_map:
                    obj["category_id"] = id_map[obj["category_id"]]
                    objs.append(obj)
            dataset_dicts.append(
                {
                    "file_name": os.path.join(image_root, img_dict["file_name"]),
                    "height": img_dict["height"],
                    "width": img_dict["width"],
                    "image_id": img_id,
                    "annotations": objs,
                }
            )
    return dataset_dicts


def register_meta_coco(name: str, metadata: dict, imgdir: str, annofile: str):
    """Register a (possibly base/novel-filtered, possibly K-shot) COCO split
    (lvc meta_coco.py:332-352 semantics)."""
    metadata = dict(metadata)
    split = "all"
    if "_base" in name or "_novel" in name:
        split = "base" if "_base" in name else "novel"
        metadata["thing_dataset_id_to_contiguous_id"] = metadata[
            f"{split}_dataset_id_to_contiguous_id"
        ]
        metadata["thing_classes"] = metadata[f"{split}_classes"]

    DatasetCatalog.register(
        name,
        lambda: load_coco_json(annofile, imgdir, metadata, name),
    )
    MetadataCatalog.get(name).set(
        json_file=annofile,
        image_root=imgdir,
        evaluator_type="coco",
        dirname=datasets_root(),
        **metadata,
    )
