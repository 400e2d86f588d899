"""Label verification CLI of the port (twin of tools/run_nearest_neighbours.py):
embed shot and candidate crops with DINO, confirm candidate labels by kNN
vote over the shots, drop candidates overlapping seen-class gt, and write
``<qe_dset>_{nn_model}_{k:02d}_{cosine|euclid}.json``.

    python -m lvc_tpu_torch.tools.run_nearest_neighbours --eval-only \\
        QUERY_EXPAND.NN_MODEL dino_vits8 QUERY_EXPAND.NN_DSET "('coco_trainval_all_30shot',)" \\
        DATASETS.DT_PATH "('candidates.json',)" DATASETS.TRAIN "('coco_trainval_all',)"

It runs on the card; ``MODEL.DEVICE cpu`` asks for the CPU. The ViT runs in
float32, as the JAX CLI's does (it never sets a compute dtype): ``setup``
turns TF32 off for the process, so the card's convolutions and matmuls are
float32 too (cuDNN allows TF32 by default). With ``--num-gpus N`` every rank
embeds the crops (as JAX's one process does), the kNN vote is split over the
ranks (``sharded_knn_vote``), and the main rank filters and writes the files.
"""
from __future__ import annotations

import json
import os

import torch
import torch.distributed as dist

from lvc_tpu_torch.config import get_cfg, set_global_cfg
from lvc_tpu_torch.data import builtin  # noqa: F401  (registers the COCO splits)
from lvc_tpu_torch.data.catalog import MetadataCatalog
from lvc_tpu_torch.data.coco_api import COCO
from lvc_tpu_torch.data.utils import iou_check_gt, print_precision_per_class, register_results
from lvc_tpu_torch.engine.defaults import default_argument_parser, default_setup
from lvc_tpu_torch.engine.launch import launch
from lvc_tpu_torch.pipeline.verification import DescriptorExtractor, build_dino, verify_candidates
from lvc_tpu_torch.utils import comm

SEEN_NAMES = [
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


def save_coco(cfg, keep_ids, qe_dset: str) -> str:
    with open(qe_dset) as f:
        coco_json = json.load(f)
    aid2ann = {x["id"]: x for x in coco_json["annotations"]}
    iid2img = {x["id"]: x for x in coco_json["images"]}
    new_anns = [aid2ann[v] for v in keep_ids]
    new_iids = list({x["image_id"] for x in new_anns})
    coco_json["annotations"] = new_anns
    coco_json["images"] = [iid2img[v] for v in new_iids]
    filename = qe_dset.replace(
        ".json",
        "_{}_{}_{}.json".format(
            cfg.QUERY_EXPAND.NN_MODEL.replace("/", ""),
            str(cfg.QUERY_EXPAND.KNN).zfill(2),
            "cosine" if cfg.QUERY_EXPAND.COSINE_SIM else "euclid",
        ),
    )
    print(filename)
    with open(filename, "w") as f:
        json.dump(coco_json, f)
    return filename


def setup(args):
    """The config, ``default_setup``, and float32 without TF32 (the ViT's
    convolution and matmuls; the training CLIs keep PyTorch's default)."""
    cfg = get_cfg()
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    cfg.merge_from_list(args.opts)
    cfg.freeze()
    set_global_cfg(cfg)
    default_setup(cfg, args)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return cfg


def main(args):
    cfg = setup(args)
    register_results(cfg)
    device = cfg.MODEL.DEVICE
    gt_path = MetadataCatalog.get("coco_trainval_all").json_file
    model = build_dino(cfg.QUERY_EXPAND.NN_MODEL or "dino_vits8", device=device)
    extractor = DescriptorExtractor(model, cfg.MODEL.PIXEL_MEAN, cfg.MODEL.PIXEL_STD)

    for nn_dset, qe_dset, train_dset in zip(
        cfg.QUERY_EXPAND.NN_DSET, cfg.DATASETS.DT_PATH, cfg.DATASETS.TRAIN
    ):
        shots = extractor.extract_dataset(nn_dset)
        print(f"{len(shots['classes'])} shot descriptors")
        queries = extractor.extract_dataset(qe_dset)
        print(f"{len(queries['classes'])} candidate descriptors")

        keep = verify_candidates(
            shots, queries, k=cfg.QUERY_EXPAND.KNN, cosine=cfg.QUERY_EXPAND.COSINE_SIM,
            device=device, group=dist.group.WORLD if comm.get_world_size() > 1 else None,
        )
        if not comm.is_main_process():
            continue
        keep_ids = queries["ids"][keep].tolist()
        print(f"kNN-confirmed: {len(keep_ids)} / {len(keep)}")

        # drop candidates overlapping (known) seen-class gt
        coco_dt = COCO(qe_dset)
        coco_gt = COCO(MetadataCatalog.get(train_dset).json_file)
        seen_coco_ids = [k for k, v in coco_gt.cats.items() if v["name"] in SEEN_NAMES]
        keep_ids = [
            aid
            for aid in keep_ids
            if not iou_check_gt(aid, coco_dt, coco_gt, gt_cids=seen_coco_ids)
        ]
        print(f"after seen-gt overlap filter: {len(keep_ids)}")

        filename = save_coco(cfg, keep_ids, qe_dset)
        if "unlabeled" not in os.path.basename(qe_dset):
            print_precision_per_class(filename, gt_path)


if __name__ == "__main__":
    args = default_argument_parser().parse_args()
    launch(main, args.num_gpus, args.num_machines, args.machine_rank, args.dist_url, args=(args,))
