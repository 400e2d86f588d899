"""Replace verified candidates' boxes with UBBR-corrected ones by
annotation id -> ``*_id.json`` (twin of ``tools/combine_ubbr_with_qe.py``,
the same flags; reference tools/combine_ubbr_with_qe.py:36-48):

    python -m lvc_tpu_torch.tools.combine_ubbr_with_qe --ubbr-data <..._ubbr.json> --qe-data <verified.json>
"""
from __future__ import annotations

import argparse
import copy
import json

from lvc_tpu_torch.data.coco_api import COCO

parser = argparse.ArgumentParser(description="Combine ubbr with pseudo-annotations")
parser.add_argument("--ubbr-data", required=True, help="path to the corrected-box json")
parser.add_argument("--qe-data", required=True, help="path to the verified candidate json")


def main(args):
    coco_qe = COCO(args.qe_data)
    with open(args.ubbr_data) as f:
        json_ubbr = json.load(f)
    uaid2anns = {a["id"]: a for a in json_ubbr}
    anns_new = []
    for a in copy.deepcopy(coco_qe.loadAnns(list(uaid2anns.keys()))):
        assert a["id"] in uaid2anns
        a["bbox"] = uaid2anns[a["id"]]["bbox"]
        anns_new.append(a)

    save_dict = {k: v for k, v in coco_qe.dataset.items() if k != "annotations"}
    save_dict["annotations"] = anns_new
    save_name = args.ubbr_data.replace(".json", "_id.json")
    print(save_name)
    with open(save_name, "w") as fp:
        json.dump(save_dict, fp, indent=4, sort_keys=True)
    return save_name


if __name__ == "__main__":
    main(parser.parse_args())
