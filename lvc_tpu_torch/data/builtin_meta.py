"""COCO category table and few-shot split metadata.

A copy of the COCO and PASCAL VOC parts of ``lvc_tpu/data/builtin_meta.py``
and of its ``LVIS_NOVEL_IDS`` (:133; the LVIS categories are read from the
json itself, as in JAX), kept so that the port never imports the JAX
package. The VOC tables keep the per-split order: base classes first, then
novel. The novel (unseen) classes are the 20 PASCAL-VOC categories;
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

# LVIS v0.5 few-shot split: 454 novel (rare) contiguous category indices out
# of 1230, the table of the checkpoint-surgery tool's --lvis mode.
LVIS_NOVEL_IDS = [
    0, 6, 9, 13, 14, 15, 20, 21, 30, 37, 38, 39, 41, 45, 48, 50, 51, 63, 64,
    69, 71, 73, 82, 85, 93, 99, 100, 104, 105, 106, 112, 115, 116, 119, 121,
    124, 126, 129, 130, 135, 139, 141, 142, 143, 146, 149, 154, 158, 160,
    162, 163, 166, 168, 172, 180, 181, 183, 195, 198, 202, 204, 205, 208,
    212, 213, 216, 217, 218, 225, 226, 230, 235, 237, 238, 240, 241, 242,
    244, 245, 248, 249, 250, 251, 252, 254, 257, 258, 264, 265, 269, 270,
    272, 279, 283, 286, 290, 292, 294, 295, 297, 299, 302, 303, 305, 306,
    309, 310, 312, 315, 316, 317, 319, 320, 321, 323, 325, 327, 328, 329,
    334, 335, 341, 343, 349, 350, 353, 355, 356, 357, 358, 359, 360, 365,
    367, 368, 369, 371, 377, 378, 384, 385, 387, 388, 392, 393, 401, 402,
    403, 405, 407, 410, 412, 413, 416, 419, 420, 422, 426, 429, 432, 433,
    434, 437, 438, 440, 441, 445, 453, 454, 455, 461, 463, 468, 472, 475,
    476, 477, 482, 484, 485, 487, 488, 492, 494, 495, 497, 508, 509, 511,
    513, 514, 515, 517, 520, 523, 524, 525, 526, 529, 533, 540, 541, 542,
    544, 547, 550, 551, 552, 554, 555, 561, 563, 568, 571, 572, 580, 581,
    583, 584, 585, 586, 589, 591, 592, 593, 595, 596, 599, 601, 604, 608,
    609, 611, 612, 615, 616, 625, 626, 628, 629, 630, 633, 635, 642, 644,
    645, 649, 655, 657, 658, 662, 663, 664, 670, 673, 675, 676, 682, 683,
    685, 689, 695, 697, 699, 702, 711, 712, 715, 721, 722, 723, 724, 726,
    729, 731, 733, 734, 738, 740, 741, 744, 748, 754, 758, 764, 766, 767,
    768, 771, 772, 774, 776, 777, 781, 782, 784, 789, 790, 794, 795, 796,
    798, 799, 803, 805, 806, 807, 808, 815, 817, 820, 821, 822, 824, 825,
    827, 832, 833, 835, 836, 840, 842, 844, 846, 856, 862, 863, 864, 865,
    866, 868, 869, 870, 871, 872, 875, 877, 882, 886, 892, 893, 897, 898,
    900, 901, 904, 905, 907, 915, 918, 919, 920, 921, 922, 926, 927, 930,
    931, 933, 939, 940, 944, 945, 946, 948, 950, 951, 953, 954, 955, 956,
    958, 959, 961, 962, 963, 969, 974, 975, 988, 990, 991, 998, 999, 1001,
    1003, 1005, 1008, 1009, 1010, 1012, 1015, 1020, 1022, 1025, 1026, 1028,
    1029, 1032, 1033, 1046, 1047, 1048, 1049, 1050, 1055, 1066, 1067, 1068,
    1072, 1073, 1076, 1077, 1086, 1094, 1099, 1103, 1111, 1132, 1135, 1137,
    1138, 1139, 1140, 1144, 1146, 1148, 1150, 1152, 1153, 1156, 1158, 1165,
    1166, 1167, 1168, 1169, 1171, 1178, 1179, 1180, 1186, 1187, 1188, 1189,
    1203, 1204, 1205, 1213, 1215, 1218, 1224, 1225, 1227,
]


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


# PASCAL VOC few-shot splits (3 canonical splits; lvc builtin_meta.py:254-383)
PASCAL_VOC_NOVEL_CATEGORIES = {
    1: ["bird", "bus", "cow", "motorbike", "sofa"],
    2: ["aeroplane", "bottle", "cow", "horse", "sofa"],
    3: ["boat", "cat", "motorbike", "sheep", "sofa"],
}
_VOC20 = [
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
]
PASCAL_VOC_BASE_CATEGORIES = {
    sid: [c for c in _VOC20 if c not in set(novel)]
    for sid, novel in PASCAL_VOC_NOVEL_CATEGORIES.items()
}
# per-split ordering: base classes first, then novel (reference convention)
PASCAL_VOC_ALL_CATEGORIES = {
    sid: PASCAL_VOC_BASE_CATEGORIES[sid] + PASCAL_VOC_NOVEL_CATEGORIES[sid]
    for sid in PASCAL_VOC_NOVEL_CATEGORIES
}


def _get_pascal_voc_fewshot_instances_meta():
    return {
        "thing_classes": PASCAL_VOC_ALL_CATEGORIES,
        "novel_classes": PASCAL_VOC_NOVEL_CATEGORIES,
        "base_classes": PASCAL_VOC_BASE_CATEGORIES,
    }


def _get_builtin_metadata(dataset_name: str):
    if dataset_name == "coco":
        return _get_coco_instances_meta()
    if dataset_name == "coco_fewshot":
        return _get_coco_fewshot_instances_meta()
    if dataset_name == "pascal_voc_fewshot":
        return _get_pascal_voc_fewshot_instances_meta()
    raise KeyError(f"No built-in metadata for dataset {dataset_name}")
