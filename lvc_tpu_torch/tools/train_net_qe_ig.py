"""End-to-end retraining on pseudo-annotations with ignore regions (twin of
``tools/train_net_qe_ig.py``; the same flags as ``train_net``):

    python -m lvc_tpu_torch.tools.train_net_qe_ig \\
        --config-file configs/COCO-detection/faster_rcnn_R_50_FPN_ft_all_30shot_aug_ftmore_dropout.yaml \\
        MODEL.WEIGHTS out/model_final.pth DATASETS.DT_PATH "('pseudo_wbase.json',)" \\
        QUERY_EXPAND.ENABLED True MODEL.BACKBONE.FREEZE False OUTPUT_DIR out/retrain

``TrainerQEIgnore`` trains with a mapper that keeps ignore regions
(``keep_ignore=True``: crowd and ``ignore_qe`` boxes become ``gt_ignores``),
over the training sets merged with the ``QUERY_EXPAND`` pseudo-annotation
files that ``register_results`` registers. Since the loader is given that
mapper, ``INPUT.MOSAIC`` does not apply here, as in JAX. With a ResNet-D
backbone (``MODEL.RESNETS.D True``) the trainer builds the CLIP optimizer
(``solver.build.build_clip_optimizer``: ``backbone.bottom_up`` steps at
``SOLVER.CLIP_LR``), as JAX's does (``tools/train_net_qe_ig.py:31-39``). It
runs on the card; ``MODEL.DEVICE cpu`` asks for the CPU.
"""
from __future__ import annotations

from lvc_tpu_torch.data import builtin  # noqa: F401  (registers the COCO splits)
from lvc_tpu_torch.data.build import build_detection_train_loader
from lvc_tpu_torch.data.dataset_mapper import DatasetMapper
from lvc_tpu_torch.data.utils import register_results
from lvc_tpu_torch.engine.defaults import DefaultTrainer, default_argument_parser
from lvc_tpu_torch.engine.launch import launch
from lvc_tpu_torch.evaluation.testing import verify_results
from lvc_tpu_torch.solver.build import build_clip_optimizer
from lvc_tpu_torch.tools.train_net import setup
from lvc_tpu_torch.utils import comm


class TrainerQEIgnore(DefaultTrainer):
    @classmethod
    def build_train_loader(cls, cfg):
        rank, world_size = comm.get_rank(), comm.get_world_size()
        mapper = DatasetMapper(cfg, is_train=True, keep_ignore=True, seed=max(cfg.SEED, 0) + rank)
        return build_detection_train_loader(cfg, mapper=mapper, rank=rank, world_size=world_size)

    @classmethod
    def build_optimizer(cls, cfg, model):
        if cfg.MODEL.RESNETS.D:
            return build_clip_optimizer(cfg, model)
        return super().build_optimizer(cfg, model)


def main(args):
    cfg = setup(args)
    if cfg.QUERY_EXPAND.ENABLED:
        register_results(cfg)

    if args.eval_only:
        trainer = TrainerQEIgnore(cfg, eval_only=True)
        trainer.resume_or_load(resume=args.resume)
        res = TrainerQEIgnore.test(cfg, trainer.model)
        if cfg.TEST.EXPECTED_RESULTS and comm.is_main_process():
            verify_results(cfg, res)
        return res

    trainer = TrainerQEIgnore(cfg)
    trainer.resume_or_load(resume=args.resume)
    return trainer.train()


if __name__ == "__main__":
    args = default_argument_parser().parse_args()
    launch(main, args.num_gpus, args.num_machines, args.machine_rank, args.dist_url, args=(args,))
