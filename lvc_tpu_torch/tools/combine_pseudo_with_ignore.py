"""Merge kept pseudo-annotations with rejected ones as ignore regions
-> ``*_ignore.json`` (twin of ``tools/combine_pseudo_with_ignore.py``, the
same flags; reference tools/combine_pseudo_with_ignore.py:38-76):

    python -m lvc_tpu_torch.tools.combine_pseudo_with_ignore --ps-data <..._id.json> --ig-data <mined.json>
"""
from __future__ import annotations

import argparse
import json

from lvc_tpu_torch.data.coco_api import COCO

parser = argparse.ArgumentParser(description="Combine pseudo-annotations with an ignore dataset")
parser.add_argument("--ps-data", required=True, help="path to the pseudo annotation data")
parser.add_argument("--ig-data", required=True, help="path to the ignore data")


def main(args):
    coco_ig = COCO(args.ig_data)
    try:
        coco_qe = COCO(args.ps_data)
        filt = True
    except AssertionError:
        coco_qe = coco_ig.loadRes(args.ps_data)
        filt = False

    qe_anns = coco_qe.loadAnns(coco_qe.getAnnIds())
    if filt:
        qe_anns = [a for a in qe_anns if not a.get("ignore_qe")]
    qe_ids = [a["id"] for a in qe_anns]
    qe_imgs = list({a["image_id"] for a in qe_anns})

    ig_ids = coco_ig.getAnnIds(imgIds=qe_imgs)
    if filt:
        ig_ids = sorted(set(ig_ids) - set(qe_ids))
    anns_ig = coco_ig.loadAnns(ig_ids)
    max_id = max(a["id"] for a in anns_ig) if anns_ig else 0
    for ann in anns_ig:
        ann["iscrowd"] = 0
        ann["ignore_qe"] = 1
    anns_qe = coco_qe.loadAnns(qe_ids)
    if not filt:
        for ann in anns_qe:
            ann["id"] += max_id
    anns_all = anns_ig + anns_qe
    assert len({a["id"] for a in anns_all}) == len(anns_all), "duplicate ann ids"

    save_dict = {k: v for k, v in coco_qe.dataset.items() if k != "annotations"}
    save_dict["annotations"] = anns_all
    save_name = args.ps_data.replace(".json", "_ignore.json")
    print(save_name)
    with open(save_name, "w") as fp:
        fp.write(json.dumps(save_dict, indent=4, sort_keys=True))
    return save_name


if __name__ == "__main__":
    main(parser.parse_args())
