"""PASCAL VOC few-shot dataset loading: a copy of
``lvc_tpu/data/meta_pascal_voc.py`` (``_load_one_voc_xml``:20,
``load_filtered_voc_instances``:45, ``register_meta_pascal_voc``:98), kept so
that the port never imports the JAX package.

VOC XML annotations filtered to the split's base/novel/base+novel class
subset, with JAX's semantics held exactly:

- boxes shift from VOC's 1-indexed pixels (``xmin``/``ymin`` minus 1);
- ``image_id`` is the file id string;
- ``<difficult>`` is never read, so difficult objects are ordinary boxes;
- the few-shot names read ``datasets/vocsplit[/seedN]/box_{K}shot_{cls}_train.txt``
  and ``datasets/VOC{year}/...`` relative to the working directory (not
  ``$DETECTRON2_DATASETS``); the year is 2012 when the file id has an
  underscore; each record carries one instance, and a class with more
  records than shots is subsampled by ``np.random.choice`` from numpy's
  global state.
"""
from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import List

import numpy as np

from lvc_tpu_torch.data.catalog import DatasetCatalog, MetadataCatalog
from lvc_tpu_torch.structures.boxes import BoxMode


def _load_one_voc_xml(anno_file: str, jpeg_file: str, image_id: str, classnames: List[str]):
    tree = ET.parse(anno_file)
    r = {
        "file_name": jpeg_file,
        "image_id": image_id,
        "height": int(tree.findall("./size/height")[0].text),
        "width": int(tree.findall("./size/width")[0].text),
    }
    instances = []
    for obj in tree.findall("object"):
        cls = obj.find("name").text
        if cls not in classnames:
            continue
        bbox = obj.find("bndbox")
        bbox = [float(bbox.find(x).text) for x in ["xmin", "ymin", "xmax", "ymax"]]
        # VOC's 1-indexed pixel convention (d2 pascal_voc.py)
        bbox[0] -= 1.0
        bbox[1] -= 1.0
        instances.append(
            {"category_id": classnames.index(cls), "bbox": bbox, "bbox_mode": BoxMode.XYXY_ABS}
        )
    r["annotations"] = instances
    return r


def load_filtered_voc_instances(
    name: str, dirname: str, split: str, classnames: List[str]
) -> List[dict]:
    is_shots = "shot" in name
    dicts = []
    if is_shots:
        fileids = {}
        split_dir = os.path.join("datasets", "vocsplit")
        if "seed" in name:
            shot = name.split("_")[-2].split("shot")[0]
            seed = int(name.split("_seed")[-1])
            split_dir = os.path.join(split_dir, f"seed{seed}")
        else:
            shot = name.split("_")[-1].split("shot")[0]
        for cls in classnames:
            with open(os.path.join(split_dir, f"box_{shot}shot_{cls}_train.txt")) as f:
                fileids_ = np.loadtxt(f, dtype=str).tolist()
                if isinstance(fileids_, str):
                    fileids_ = [fileids_]
            fileids_ = [
                fid.split("/")[-1].split(".jpg")[0] for fid in fileids_
            ]
            fileids[cls] = fileids_

        for cls, cls_fileids in fileids.items():
            dicts_ = []
            for fileid in cls_fileids:
                year = "2012" if "_" in fileid else "2007"
                dirname_y = os.path.join("datasets", f"VOC{year}")
                anno_file = os.path.join(dirname_y, "Annotations", fileid + ".xml")
                jpeg_file = os.path.join(dirname_y, "JPEGImages", fileid + ".jpg")
                r = _load_one_voc_xml(anno_file, jpeg_file, fileid, classnames)
                # keep only this class's boxes, one instance per record
                for inst in r["annotations"]:
                    if classnames[inst["category_id"]] == cls:
                        rec = dict(r)
                        rec["annotations"] = [inst]
                        dicts_.append(rec)
            if len(dicts_) > int(shot):
                dicts_ = np.random.choice(dicts_, int(shot), replace=False)
            dicts.extend(dicts_)
    else:
        with open(os.path.join(dirname, "ImageSets", "Main", split + ".txt")) as f:
            fileids = np.loadtxt(f, dtype=str)
        for fileid in fileids:
            anno_file = os.path.join(dirname, "Annotations", fileid + ".xml")
            jpeg_file = os.path.join(dirname, "JPEGImages", fileid + ".jpg")
            dicts.append(_load_one_voc_xml(anno_file, jpeg_file, fileid, classnames))
    return dicts


def register_meta_pascal_voc(
    name: str, metadata: dict, dirname: str, split: str, year: int, keepclasses: str, sid: int
):
    if keepclasses.startswith("base_novel"):
        thing_classes = metadata["thing_classes"][sid]
    elif keepclasses.startswith("base"):
        thing_classes = metadata["base_classes"][sid]
    elif keepclasses.startswith("novel"):
        thing_classes = metadata["novel_classes"][sid]
    else:
        raise ValueError(keepclasses)

    DatasetCatalog.register(
        name,
        lambda: load_filtered_voc_instances(name, dirname, split, thing_classes),
    )
    MetadataCatalog.get(name).set(
        thing_classes=thing_classes,
        dirname=dirname,
        year=year,
        split=split,
        base_classes=metadata["base_classes"][sid],
        novel_classes=metadata["novel_classes"][sid],
    )
