"""Add known base-class gt annotations for the pseudo-labelled images
(optionally as ignores) -> ``*_wbase[_base_ig].json`` (twin of
``tools/combine_qe_with_base.py``, the same flags; reference
tools/combine_qe_with_base.py:41-59):

    python -m lvc_tpu_torch.tools.combine_qe_with_base --ps-data <..._ignore.json> --bs-data <base.json> [--base-ignore]
"""
from __future__ import annotations

import argparse
import json

from lvc_tpu_torch.data.coco_api import COCO

SEEN_CLASSES = [
    "truck", "traffic light", "fire hydrant", "stop sign", "parking meter",
    "bench", "elephant", "bear", "zebra", "giraffe", "backpack", "umbrella",
    "handbag", "tie", "suitcase", "frisbee", "skis", "snowboard",
    "sports ball", "kite", "baseball bat", "baseball glove", "skateboard",
    "surfboard", "tennis racket", "wine glass", "cup", "fork", "knife",
    "spoon", "bowl", "banana", "apple", "sandwich", "orange", "broccoli",
    "carrot", "hot dog", "pizza", "donut", "cake", "bed", "toilet", "laptop",
    "mouse", "remote", "keyboard", "cell phone", "microwave", "oven",
    "toaster", "sink", "refrigerator", "book", "clock", "vase", "scissors",
    "teddy bear", "hair drier", "toothbrush"]

parser = argparse.ArgumentParser(description="Combine pseudo-annotations with a base dataset")
parser.add_argument("--ps-data", required=True, help="path to the pseudo annotation data")
parser.add_argument("--bs-data", required=True, help="path to the base data")
parser.add_argument("--base-ignore", action="store_true")


def main(args):
    coco_qe = COCO(args.ps_data)
    coco_bs = COCO(args.bs_data)
    base_classes = {k for k, v in coco_bs.cats.items() if v["name"] in SEEN_CLASSES}
    qe_ids = coco_qe.getAnnIds()
    qe_imgs = coco_qe.getImgIds()
    anns_bs = coco_bs.loadAnns(coco_bs.getAnnIds(imgIds=qe_imgs))
    anns_bs = [a for a in anns_bs if a["category_id"] in base_classes]
    for ann in anns_bs:
        ann["iscrowd"] = 0
        ann["ignore_qe"] = float(args.base_ignore)
        ann["ignore_reg"] = float(args.base_ignore)

    anns_all = anns_bs + coco_qe.loadAnns(qe_ids)
    save_dict = {k: v for k, v in coco_qe.dataset.items() if k != "annotations"}
    save_dict["annotations"] = anns_all
    save_name = args.ps_data.replace(".json", "_wbase.json")
    if args.base_ignore:
        save_name = save_name.replace(".json", "_base_ig.json")
    print(save_name)
    with open(save_name, "w") as fp:
        json.dump(save_dict, fp, indent=4, sort_keys=True)
    return save_name


if __name__ == "__main__":
    main(parser.parse_args())
