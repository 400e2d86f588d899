"""Training and evaluation CLI of the port (twin of ``tools/train_net.py``):
base training, fine-tuning stages and eval-only runs, with the same flags.

    python -m lvc_tpu_torch.tools.train_net \\
        --config-file configs/COCO-detection/faster_rcnn_R_50_FPN_base.yaml \\
        MODEL.WEIGHTS model.pth OUTPUT_DIR out
    python -m lvc_tpu_torch.tools.train_net --eval-only --config-file ... MODEL.WEIGHTS out/model_final.pth

It runs on the card; ``MODEL.DEVICE cpu`` asks for the CPU. ``--num-gpus N``
runs N processes, one a card (``engine/launch.py``; with ``MODEL.DEVICE cpu``,
N gloo ranks on the CPU), over which ``SOLVER.IMS_PER_BATCH`` and every test
set are split; only the main rank writes files. Datasets are the
COCO and PASCAL VOC splits registered under ``$DETECTRON2_DATASETS`` (the VOC
few-shot lists are read from ``datasets/vocsplit`` under the working
directory, as in JAX), and any LVIS split registered with
``data/meta_lvis.register_meta_lvis``. With
``MODEL.META_ARCHITECTURE ProposalNetwork`` an ``--eval-only`` run extracts
proposals (the ``RPNEvaluator`` writes ``coco_proposals_*_results.pkl`` into
``OUTPUT_DIR``); otherwise the split's ``evaluator_type`` picks the
evaluator: ``coco`` (``COCOEvaluator``), ``pascal_voc``
(``PascalVOCDetectionEvaluator``) or ``lvis`` (``LVISEvaluator``).
"""
from __future__ import annotations

import os

from lvc_tpu_torch.config import get_cfg, set_global_cfg
from lvc_tpu_torch.data import builtin  # noqa: F401  (registers the COCO and VOC splits)
from lvc_tpu_torch.data.catalog import MetadataCatalog
from lvc_tpu_torch.engine.defaults import DefaultTrainer, default_argument_parser, default_setup
from lvc_tpu_torch.engine.launch import launch
from lvc_tpu_torch.evaluation.coco_evaluation import COCOEvaluator
from lvc_tpu_torch.evaluation.lvis_evaluation import LVISEvaluator
from lvc_tpu_torch.evaluation.pascal_voc_evaluation import PascalVOCDetectionEvaluator
from lvc_tpu_torch.evaluation.rpn_evaluation import RPNEvaluator
from lvc_tpu_torch.evaluation.testing import verify_results
from lvc_tpu_torch.utils import comm


class Trainer(DefaultTrainer):
    @classmethod
    def build_evaluator(cls, cfg, dataset_name):
        if cfg.MODEL.META_ARCHITECTURE == "ProposalNetwork":
            return RPNEvaluator(dataset_name, cfg, output_dir=cfg.OUTPUT_DIR)
        ev_type = MetadataCatalog.get(dataset_name).get("evaluator_type", "coco")
        if ev_type == "coco":
            return COCOEvaluator(
                dataset_name, cfg, output_dir=os.path.join(cfg.OUTPUT_DIR, "inference")
            )
        if ev_type == "pascal_voc":
            return PascalVOCDetectionEvaluator(dataset_name)
        if ev_type == "lvis":
            return LVISEvaluator(
                dataset_name, cfg, output_dir=os.path.join(cfg.OUTPUT_DIR, "inference")
            )
        raise NotImplementedError(f"no evaluator for type {ev_type}")


def setup(args):
    cfg = get_cfg()
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    cfg.merge_from_list(args.opts)
    cfg.freeze()
    set_global_cfg(cfg)
    default_setup(cfg, args)
    return cfg


def main(args):
    cfg = setup(args)

    if args.eval_only:
        trainer = Trainer(cfg, eval_only=True)
        trainer.resume_or_load(resume=args.resume)
        res = Trainer.test(cfg, trainer.model)
        if cfg.TEST.EXPECTED_RESULTS and comm.is_main_process():
            verify_results(cfg, res)
        return res

    trainer = Trainer(cfg)
    trainer.resume_or_load(resume=args.resume)
    return trainer.train()


if __name__ == "__main__":
    args = default_argument_parser().parse_args()
    launch(main, args.num_gpus, args.num_machines, args.machine_rank, args.dist_url, args=(args,))
