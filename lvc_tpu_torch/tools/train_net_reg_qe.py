"""Box correction of candidate files (twin of ``tools/train_net_reg_qe.py``;
the same flags as ``train_net``):

    python -m lvc_tpu_torch.tools.train_net_reg_qe --resume --eval-only \\
        --config-file configs/COCO-detection/cascade_ubbr_R_50_FPN_base.yaml \\
        OUTPUT_DIR <the corrector's training dir> DATASETS.DT_PATH "('cands.json',)" \\
        MODEL.LOAD_PROPOSALS False QUERY_EXPAND.ENABLED True

Each ``DATASETS.DT_PATH`` file (detectron2 result rows or a COCO dict, as
``register_results`` reads them) is registered as a dataset; its candidate
boxes go through the reg-only meta-architecture in the gt slots, with
``PAD.MAX_GT_PER_IMAGE`` widened to the file's densest image (rounded up to
16) so that no candidate is dropped, and ``UBBRSaver`` writes
``<file>_ubbr.json``. It runs on the card; ``MODEL.DEVICE cpu`` asks for the
CPU. With ``--num-gpus N`` each rank corrects its shard of every file and
the main rank writes the merged rows.
"""
from __future__ import annotations

import json
import os
from collections import Counter

from lvc_tpu_torch.data import builtin  # noqa: F401  (registers the COCO splits)
from lvc_tpu_torch.data.build import build_detection_test_loader
from lvc_tpu_torch.data.utils import register_results
from lvc_tpu_torch.engine.defaults import DefaultTrainer, default_argument_parser
from lvc_tpu_torch.engine.launch import launch
from lvc_tpu_torch.evaluation.evaluator import inference_on_dataset
from lvc_tpu_torch.evaluation.ubbr_saver import UBBRSaver
from lvc_tpu_torch.tools.train_net import setup
from lvc_tpu_torch.utils import comm


def main(args):
    cfg = setup(args)
    register_results(cfg)

    # correction runs the reg-only meta-architecture whatever the config trains
    reg_cfg = cfg.clone().defrost()
    reg_cfg.MODEL.META_ARCHITECTURE = "GeneralizedRCNNRegOnly"
    reg_cfg.freeze()
    trainer = DefaultTrainer(reg_cfg, eval_only=True)
    trainer.resume_or_load(resume=args.resume)
    trainer.model.eval()

    for results_file in cfg.DATASETS.DT_PATH:
        if not os.path.isfile(results_file):
            print(f"skipping missing {results_file}")
            continue
        with open(results_file) as f:
            data = json.load(f)
        anns = data["annotations"] if isinstance(data, dict) else data
        # every annotation is a gt slot (ignore regions too), so the densest
        # image sets the pad
        need = max(Counter(a["image_id"] for a in anns).values(), default=1)
        file_cfg = reg_cfg.clone().defrost()
        file_cfg.PAD.MAX_GT_PER_IMAGE = max(reg_cfg.PAD.MAX_GT_PER_IMAGE, -(-need // 16) * 16)
        loader = build_detection_test_loader(
            file_cfg.freeze(), results_file, batch_size=1, rank=comm.get_rank(),
            world_size=comm.get_world_size(), with_gt=True,
        )
        inference_on_dataset(trainer.model, loader, UBBRSaver(results_file, reg_cfg))
        comm.synchronize()


if __name__ == "__main__":
    args = default_argument_parser().parse_args()
    launch(main, args.num_gpus, args.num_machines, args.machine_rank, args.dist_url, args=(args,))
