"""Candidate mining: filter detections into a pseudo-annotation dataset
(twin of ``tools/create_coco_dataset_from_dets_all.py``, the same flags):

    python -m lvc_tpu_torch.tools.create_coco_dataset_from_dets_all \\
        --json-data coco_trainval_all --gt-data coco_trainval_all_30shot \\
        --full --K-min 0.8 --K-max 1.0 --dt-path out/inference/coco_instances_trainval_results.json

Counterpart of reference tools/create_coco_dataset_from_dets_all.py
(get_ret_anns:129-193, save_coco:196-238): per unseen class, keep
detections with score in [K_min, K_max) (or rank in [K_max, K_min) with
--top) on images NOT in the few-shot train set; with --full, mark remaining
same-image detections of that class as ignore (ignore_qe=1, iscrowd=1).
Writes ``<dt_path>_score_maxA_minB[_full]_all[_allcats].json`` and prints
per-class precision against gt. A host tool: it runs no model.
"""
from __future__ import annotations

import argparse
import json
from collections import defaultdict

import numpy as np

from lvc_tpu_torch.data import builtin  # noqa: F401  (registers the COCO splits)
from lvc_tpu_torch.data.build import get_detection_dataset_dicts
from lvc_tpu_torch.data.catalog import MetadataCatalog
from lvc_tpu_torch.data.coco_api import COCO_PK
from lvc_tpu_torch.data.utils import combine_datasets, print_precision_per_class

AREA_RNG = [0**2, 1e5**2]

parser = argparse.ArgumentParser(description="Create coco dataset file from detections")
parser.add_argument("--json-data", default="coco_trainval_all")
parser.add_argument("--gt-data", required=True, help="the few-shot train dataset name")
parser.add_argument("--top", action="store_true", help="rank-based selection")
parser.add_argument("--full", action="store_true", help="retain all dets in a selected image as ignores")
parser.add_argument("--full-dataset", action="store_true", help="dt-path is a full COCO json")
parser.add_argument("--K-min", type=float, required=True)
parser.add_argument("--K-max", type=float, required=True)
parser.add_argument("--ar", type=float, default=0.0, help="area-ratio lower bound")
parser.add_argument("--dt-path", type=str, required=True)
parser.add_argument("--all-cats", action="store_true")

UNSEEN_CLASSES = [
    "airplane", "bicycle", "bird", "boat", "bottle", "bus", "car",
    "cat", "chair", "cow", "dining table", "dog", "horse", "motorcycle",
    "person", "potted plant", "sheep", "couch", "train", "tv"]


def get_ret_anns(coco_dt: COCO_PK, train_imgs, args, target_coco_ids):
    all_anns = []
    for cid in target_coco_ids:
        valid_imgs = [i for i in coco_dt.getImgIds() if i not in train_imgs[cid]]
        ann_ids = coco_dt.getAnnIds(
            catIds=cid, imgIds=valid_imgs, areaRng=AREA_RNG,
            areaRatioRng=[args.ar, 1.0], iscrowd=False,
        )
        anns = sorted(coco_dt.loadAnns(ann_ids), key=lambda x: x["score"], reverse=True)
        if args.top:
            k_min, k_max = int(args.K_min), int(args.K_max)
            keep_anns = anns[k_max:k_min]
        else:
            scores = np.array([a["score"] for a in anns])
            ind_min = np.searchsorted(-scores, -float(args.K_min))
            ind_max = np.searchsorted(-scores, -float(args.K_max))
            keep_anns = anns[ind_max:ind_min]
        for ann in keep_anns:
            ann["ignore_qe"] = 0
            ann["iscrowd"] = 0
        if args.full:
            pres_img_ids = list({a["image_id"] for a in keep_anns})
            keep_ids = {a["id"] for a in keep_anns}
            new_ann_ids = coco_dt.getAnnIds(
                catIds=cid, imgIds=pres_img_ids, areaRng=AREA_RNG,
                areaRatioRng=[args.ar, 1.0], iscrowd=False,
            )
            new_anns = coco_dt.loadAnns(sorted(set(new_ann_ids) - keep_ids))
            for ann in new_anns:
                ann["ignore_qe"] = 1
                ann["iscrowd"] = 1
            all_anns.extend(new_anns)
        all_anns.extend(keep_anns)
    return all_anns


def save_coco(args, coco_cats, coco_dt, return_anns, return_imgs) -> str:
    src = coco_dt if args.full_dataset else coco_cats
    save_dict = {k: v for k, v in src.dataset.items() if k not in ("annotations", "images")}
    print(f"Saving {len(return_anns)} new annotations across {len(return_imgs)} images")
    for ann in return_anns:
        for k in ("segmentation", "top2_scores", "top2_inds"):
            ann.pop(k, None)
    save_dict["annotations"] = return_anns
    save_dict["images"] = return_imgs
    s = f"_ar{str(args.ar).replace('.', '')}" if args.ar else ""
    if args.top:
        s += "_top_max{}_min{}{}_all.json".format(
            str(int(args.K_max)).zfill(4), str(int(args.K_min)).zfill(4),
            "_full" if args.full else "",
        )
    else:
        s += "_score_max{}_min{}{}_all.json".format(
            str(args.K_max).replace(".", ""), str(args.K_min).replace(".", ""),
            "_full" if args.full else "",
        )
    save_name = args.dt_path.replace(".json", s)
    if args.all_cats:
        save_name = save_name.replace(".json", "_allcats.json")
    print(save_name)
    with open(save_name, "w") as fp:
        fp.write(json.dumps(save_dict, indent=4, sort_keys=True))
    return save_name


def main(args):
    gt_path = MetadataCatalog.get(args.json_data).json_file
    coco_gt = COCO_PK(gt_path)
    coco_cats = COCO_PK(MetadataCatalog.get("coco_test_all").json_file)
    coco_gt.dataset["categories"] = coco_cats.dataset["categories"]

    all_coco_ids = sorted(coco_cats.cats.keys())
    unseen_coco_ids = [
        cid for cid in all_coco_ids if coco_cats.cats[cid]["name"] in UNSEEN_CLASSES
    ]

    # images already holding few-shot annotations per class (excluded)
    train_imgs = defaultdict(list)
    if args.gt_data:
        unseen_data = combine_datasets([get_detection_dataset_dicts((args.gt_data,))])
        for d in unseen_data:
            for c in {a["category_id"] for a in d["annotations"]}:
                train_imgs[all_coco_ids[c]].append(d["image_id"])

    if args.full_dataset:
        coco_dt = COCO_PK(args.dt_path)
    else:
        coco_dt = coco_gt.loadRes(args.dt_path)
        coco_dt.__class__ = COCO_PK
        coco_dt.createIndex()

    targets = unseen_coco_ids if not args.all_cats else all_coco_ids
    return_anns = get_ret_anns(coco_dt, train_imgs, args, targets)
    return_img_ids = list({a["image_id"] for a in return_anns})
    return_imgs = coco_gt.loadImgs([i for i in return_img_ids if i in coco_gt.imgs])
    save_name = save_coco(args, coco_cats, coco_dt, return_anns, return_imgs)
    if "unlabeled" not in args.json_data:
        print_precision_per_class(save_name, gt_path)
    return save_name


if __name__ == "__main__":
    main(parser.parse_args())
