"""Built-in dataset registration: a copy of ``lvc_tpu/data/builtin.py``.

``register_all_coco`` registers every COCO few-shot split (all/base/novel x
{1,2,3,5,10,30}-shot x seeds 0-9), ``register_all_pascal_voc`` the 21 fixed
VOC splits and the few-shot ones ({all,novel} x splits 1-3 x
{1,2,3,5,10}-shot x {2007,2012} x seeds 0-99), each with
``evaluator_type="pascal_voc"``: 6,149 names in all, registered at import
time under ``$DETECTRON2_DATASETS``, as in the reference
(builtin.py:281-285). The VOC few-shot lists themselves are read relative
to the working directory (``meta_pascal_voc.py``).
"""
from __future__ import annotations

import os

from lvc_tpu_torch.data.builtin_meta import _get_builtin_metadata
from lvc_tpu_torch.data.catalog import DatasetCatalog, MetadataCatalog
from lvc_tpu_torch.data.meta_coco import register_meta_coco
from lvc_tpu_torch.data.meta_pascal_voc import register_meta_pascal_voc


def register_all_coco(root="datasets"):
    metasplits = [
        ("coco_trainval_all", "coco/trainval2014", "cocosplit/datasplit/trainvalno5k.json"),
        ("coco_trainval_base", "coco/trainval2014", "cocosplit/datasplit/trainvalno5k.json"),
        ("coco_trainval_novel", "coco/trainval2014", "cocosplit/datasplit/trainvalno5k.json"),
        ("coco_test_all", "coco/val2014", "cocosplit/datasplit/5k.json"),
        ("coco_test_base", "coco/val2014", "cocosplit/datasplit/5k.json"),
        ("coco_test_novel", "coco/val2014", "cocosplit/datasplit/5k.json"),
        ("coco_2017_val_all", "coco/val2017", "coco/annotations/instances_val2017.json"),
        (
            "coco_unlabeled_all",
            "coco/unlabeled2017",
            "coco/annotations/image_info_unlabeled2017.json",
        ),
    ]
    for prefix in ["all", "novel"]:
        for shot in [1, 2, 3, 5, 10, 30]:
            for seed in range(10):
                suffix = "" if seed == 0 else f"_seed{seed}"
                metasplits.append(
                    (f"coco_trainval_{prefix}_{shot}shot{suffix}", "coco/trainval2014", "")
                )

    meta = _get_builtin_metadata("coco_fewshot")
    for name, imgdir, annofile in metasplits:
        register_meta_coco(name, meta, os.path.join(root, imgdir), os.path.join(root, annofile))


def register_all_pascal_voc(root="datasets"):
    metasplits = [
        ("voc_2007_trainval_base1", "VOC2007", "trainval", "base1", 1),
        ("voc_2007_trainval_base2", "VOC2007", "trainval", "base2", 2),
        ("voc_2007_trainval_base3", "VOC2007", "trainval", "base3", 3),
        ("voc_2012_trainval_base1", "VOC2012", "trainval", "base1", 1),
        ("voc_2012_trainval_base2", "VOC2012", "trainval", "base2", 2),
        ("voc_2012_trainval_base3", "VOC2012", "trainval", "base3", 3),
        ("voc_2007_trainval_all1", "VOC2007", "trainval", "base_novel_1", 1),
        ("voc_2007_trainval_all2", "VOC2007", "trainval", "base_novel_2", 2),
        ("voc_2007_trainval_all3", "VOC2007", "trainval", "base_novel_3", 3),
        ("voc_2012_trainval_all1", "VOC2012", "trainval", "base_novel_1", 1),
        ("voc_2012_trainval_all2", "VOC2012", "trainval", "base_novel_2", 2),
        ("voc_2012_trainval_all3", "VOC2012", "trainval", "base_novel_3", 3),
        ("voc_2007_test_base1", "VOC2007", "test", "base1", 1),
        ("voc_2007_test_base2", "VOC2007", "test", "base2", 2),
        ("voc_2007_test_base3", "VOC2007", "test", "base3", 3),
        ("voc_2007_test_novel1", "VOC2007", "test", "novel1", 1),
        ("voc_2007_test_novel2", "VOC2007", "test", "novel2", 2),
        ("voc_2007_test_novel3", "VOC2007", "test", "novel3", 3),
        ("voc_2007_test_all1", "VOC2007", "test", "base_novel_1", 1),
        ("voc_2007_test_all2", "VOC2007", "test", "base_novel_2", 2),
        ("voc_2007_test_all3", "VOC2007", "test", "base_novel_3", 3),
    ]
    for prefix in ["all", "novel"]:
        for sid in range(1, 4):
            for shot in [1, 2, 3, 5, 10]:
                for year in [2007, 2012]:
                    for seed in range(100):
                        suffix = "" if seed == 0 else f"_seed{seed}"
                        name = f"voc_{year}_trainval_{prefix}{sid}_{shot}shot{suffix}"
                        keep = f"base_novel_{sid}" if prefix == "all" else f"novel{sid}"
                        metasplits.append((name, f"VOC{year}", name, keep, sid))

    meta = _get_builtin_metadata("pascal_voc_fewshot")
    for name, dirname, split, keepclasses, sid in metasplits:
        year = 2007 if "2007" in name else 2012
        register_meta_pascal_voc(
            name, meta, os.path.join(root, dirname), split, year, keepclasses, sid
        )
        MetadataCatalog.get(name).evaluator_type = "pascal_voc"
        MetadataCatalog.get(name).image_root = os.path.join(root, dirname)
        MetadataCatalog.get(name).json_file = os.path.join(root, "voc", f"{name}.json")


_root = os.getenv("DETECTRON2_DATASETS", "datasets")
if "coco_test_all" not in DatasetCatalog:
    register_all_coco(root=_root)
    register_all_pascal_voc(root=_root)
