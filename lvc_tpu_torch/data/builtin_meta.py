"""COCO category table and few-shot split metadata.

A copy of the COCO part of ``lvc_tpu/data/builtin_meta.py`` (the PASCAL VOC
and LVIS tables are not ported yet), kept so that the port never imports the
JAX package. The novel (unseen) classes are the 20 PASCAL-VOC categories;
base (seen) are the other 60, the standard FSOD split.
"""
from __future__ import annotations

# The 80 COCO "thing" categories with their original (non-contiguous) ids.
COCO_CATEGORIES = [
    {"id": 1, "name": "person"},
    {"id": 2, "name": "bicycle"},
    {"id": 3, "name": "car"},
    {"id": 4, "name": "motorcycle"},
    {"id": 5, "name": "airplane"},
    {"id": 6, "name": "bus"},
    {"id": 7, "name": "train"},
    {"id": 8, "name": "truck"},
    {"id": 9, "name": "boat"},
    {"id": 10, "name": "traffic light"},
    {"id": 11, "name": "fire hydrant"},
    {"id": 13, "name": "stop sign"},
    {"id": 14, "name": "parking meter"},
    {"id": 15, "name": "bench"},
    {"id": 16, "name": "bird"},
    {"id": 17, "name": "cat"},
    {"id": 18, "name": "dog"},
    {"id": 19, "name": "horse"},
    {"id": 20, "name": "sheep"},
    {"id": 21, "name": "cow"},
    {"id": 22, "name": "elephant"},
    {"id": 23, "name": "bear"},
    {"id": 24, "name": "zebra"},
    {"id": 25, "name": "giraffe"},
    {"id": 27, "name": "backpack"},
    {"id": 28, "name": "umbrella"},
    {"id": 31, "name": "handbag"},
    {"id": 32, "name": "tie"},
    {"id": 33, "name": "suitcase"},
    {"id": 34, "name": "frisbee"},
    {"id": 35, "name": "skis"},
    {"id": 36, "name": "snowboard"},
    {"id": 37, "name": "sports ball"},
    {"id": 38, "name": "kite"},
    {"id": 39, "name": "baseball bat"},
    {"id": 40, "name": "baseball glove"},
    {"id": 41, "name": "skateboard"},
    {"id": 42, "name": "surfboard"},
    {"id": 43, "name": "tennis racket"},
    {"id": 44, "name": "bottle"},
    {"id": 46, "name": "wine glass"},
    {"id": 47, "name": "cup"},
    {"id": 48, "name": "fork"},
    {"id": 49, "name": "knife"},
    {"id": 50, "name": "spoon"},
    {"id": 51, "name": "bowl"},
    {"id": 52, "name": "banana"},
    {"id": 53, "name": "apple"},
    {"id": 54, "name": "sandwich"},
    {"id": 55, "name": "orange"},
    {"id": 56, "name": "broccoli"},
    {"id": 57, "name": "carrot"},
    {"id": 58, "name": "hot dog"},
    {"id": 59, "name": "pizza"},
    {"id": 60, "name": "donut"},
    {"id": 61, "name": "cake"},
    {"id": 62, "name": "chair"},
    {"id": 63, "name": "couch"},
    {"id": 64, "name": "potted plant"},
    {"id": 65, "name": "bed"},
    {"id": 67, "name": "dining table"},
    {"id": 70, "name": "toilet"},
    {"id": 72, "name": "tv"},
    {"id": 73, "name": "laptop"},
    {"id": 74, "name": "mouse"},
    {"id": 75, "name": "remote"},
    {"id": 76, "name": "keyboard"},
    {"id": 77, "name": "cell phone"},
    {"id": 78, "name": "microwave"},
    {"id": 79, "name": "oven"},
    {"id": 80, "name": "toaster"},
    {"id": 81, "name": "sink"},
    {"id": 82, "name": "refrigerator"},
    {"id": 84, "name": "book"},
    {"id": 85, "name": "clock"},
    {"id": 86, "name": "vase"},
    {"id": 87, "name": "scissors"},
    {"id": 88, "name": "teddy bear"},
    {"id": 89, "name": "hair drier"},
    {"id": 90, "name": "toothbrush"},
]

# Novel (unseen) classes = the 20 PASCAL-VOC categories (COCO ids).
COCO_NOVEL_IDS = [1, 2, 3, 4, 5, 6, 7, 9, 16, 17, 18, 19, 20, 21, 44, 62, 63, 64, 67, 72]

# contiguous-index unseen table (match lvc defaults.py:181-189)
COCO_UNSEEN_IDS = [0, 1, 2, 3, 4, 5, 6, 8, 14, 15, 16, 17, 18, 19, 39, 56, 57, 58, 60, 62]


def _get_coco_instances_meta():
    thing_ids = [k["id"] for k in COCO_CATEGORIES]
    assert len(thing_ids) == 80
    return {
        "thing_dataset_id_to_contiguous_id": {k: i for i, k in enumerate(thing_ids)},
        "thing_classes": [k["name"] for k in COCO_CATEGORIES],
    }


def _get_coco_fewshot_instances_meta():
    ret = _get_coco_instances_meta()
    id_to_name = {k["id"]: k["name"] for k in COCO_CATEGORIES}
    novel_ids = list(COCO_NOVEL_IDS)
    novel_classes = [id_to_name[i] for i in novel_ids]
    base = [k for k in COCO_CATEGORIES if k["id"] not in set(novel_ids)]
    ret.update(
        novel_dataset_id_to_contiguous_id={k: i for i, k in enumerate(novel_ids)},
        novel_classes=novel_classes,
        base_dataset_id_to_contiguous_id={k["id"]: i for i, k in enumerate(base)},
        base_classes=[k["name"] for k in base],
    )
    return ret


def _get_builtin_metadata(dataset_name: str):
    if dataset_name == "coco":
        return _get_coco_instances_meta()
    if dataset_name == "coco_fewshot":
        return _get_coco_fewshot_instances_meta()
    raise KeyError(f"No built-in metadata for dataset {dataset_name}")
