"""LVIS few-shot dataset registration: a copy of ``lvc_tpu/data/meta_lvis.py``
(``load_lvis_json``:17, ``register_meta_lvis``:50, ``register_all_lvis``:75).

LVIS jsons are COCO-like and read through the port's ``coco_api.COCO``;
categories map to contiguous ids in sorted-id order, and ``thing_classes``
is read lazily from the json's categories (their first synonym, else the
name). Each record keeps the image's ``not_exhaustive_category_ids`` and
``neg_category_ids``. ``register_all_lvis`` is not called at import, as in
JAX.
"""
from __future__ import annotations

import os
from typing import List

from lvc_tpu_torch.data.catalog import DatasetCatalog, MetadataCatalog
from lvc_tpu_torch.data.coco_api import COCO
from lvc_tpu_torch.structures.boxes import BoxMode


def load_lvis_json(json_file: str, image_root: str, dataset_name: str) -> List[dict]:
    api = COCO(json_file)
    cat_ids = sorted(api.cats.keys())
    id_map = {cid: i for i, cid in enumerate(cat_ids)}

    dataset_dicts = []
    for img_id in sorted(api.imgs.keys()):
        img = api.imgs[img_id]
        # LVIS file_name may carry the split prefix ("train2017/xxx.jpg")
        file_name = img.get("file_name") or img["coco_url"].split("/")[-1]
        record = {
            "file_name": os.path.join(image_root, file_name),
            "height": img["height"],
            "width": img["width"],
            "image_id": img_id,
            "not_exhaustive_category_ids": img.get("not_exhaustive_category_ids", []),
            "neg_category_ids": img.get("neg_category_ids", []),
            "annotations": [],
        }
        for anno in api.imgToAnns[img_id]:
            record["annotations"].append(
                {
                    "bbox": anno["bbox"],
                    "bbox_mode": BoxMode.XYWH_ABS,
                    "category_id": id_map[anno["category_id"]],
                    "area": anno.get("area", anno["bbox"][2] * anno["bbox"][3]),
                    "iscrowd": anno.get("iscrowd", 0),
                }
            )
        dataset_dicts.append(record)
    return dataset_dicts


def register_meta_lvis(name: str, metadata: dict, json_file: str, image_root: str):
    DatasetCatalog.register(name, lambda: load_lvis_json(json_file, image_root, name))

    def lazy_classes():
        if os.path.isfile(json_file):
            api = COCO(json_file)
            return [
                api.cats[c].get("synonyms", [api.cats[c].get("name", str(c))])[0]
                if isinstance(api.cats[c].get("synonyms"), list)
                else api.cats[c].get("name", str(c))
                for c in sorted(api.cats.keys())
            ]
        return []

    MetadataCatalog.get(name).set(
        json_file=json_file,
        image_root=image_root,
        evaluator_type="lvis",
        **metadata,
    )
    md = MetadataCatalog.get(name)
    if not md.get("thing_classes"):
        md.set(thing_classes=lazy_classes())


def register_all_lvis(root: str = "datasets"):
    metasplits = [
        ("lvis_v0.5_train_shots", "coco/train2017", "lvissplit/lvis_shots.json"),
        ("lvis_v0.5_train_rare_novel", "coco/train2017", "lvis/lvis_v0.5_train_rare.json"),
        ("lvis_v0.5_val_novel", "coco/val2017", "lvis/lvis_v0.5_val.json"),
    ]
    for name, image_root, json_file in metasplits:
        if name in DatasetCatalog:
            continue
        register_meta_lvis(
            name, {}, os.path.join(root, json_file), os.path.join(root, image_root)
        )
