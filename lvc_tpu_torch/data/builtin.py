"""Built-in COCO dataset registration.

A copy of ``register_all_coco`` of ``lvc_tpu/data/builtin.py``: every COCO
few-shot split (all/base/novel x {1,2,3,5,10,30}-shot x seeds 0-9), registered
at import time under ``$DETECTRON2_DATASETS``, as in the reference
(builtin.py:281-285). The PASCAL VOC splits are not ported yet (ROADMAP.md).
"""
from __future__ import annotations

import os

from lvc_tpu_torch.data.builtin_meta import _get_builtin_metadata
from lvc_tpu_torch.data.catalog import DatasetCatalog
from lvc_tpu_torch.data.meta_coco import register_meta_coco


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


_root = os.getenv("DETECTRON2_DATASETS", "datasets")
if "coco_test_all" not in DatasetCatalog:
    register_all_coco(root=_root)
