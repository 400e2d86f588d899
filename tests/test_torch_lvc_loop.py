"""The twin of ``scripts/coco_full_run.sh`` end to end on the CPU
(``lvc_tpu_torch.tools.coco_full_run``; the JAX package's counterpart is
``tests/test_lvc_loop_e2e.py``, marked slow there).

All 18 steps run in order through ``chip_smoke.drive_chain`` on
``chip_smoke.write_chain_tree``'s tree (5 training, 2 test and 2 unlabeled
images of 64x80, 80 classes, 30-shot files) with the configs as they
stand, narrowed by trailing overrides (16-wide stem, 32-wide res2 and FPN,
FC 64, one iteration per training step, 96-pixel canvases, score threshold
0, gradient clipping at norm 1) and the verifier cut to one ViT-S/16 block
on 32-pixel crops in batches of 8. Each step reads only the files the steps
before it wrote: the checkpoints (``model_final.pth`` linked to each
training run's last checkpoint), the surgery outputs, the proposal pickles,
the detection, mined, verified, corrected and combined JSONs. Between steps
``drive_chain`` does what tests/test_lvc_loop_e2e.py does: it respreads the
random detector's rows over four unseen classes with scores in the mining
band, and points every shot at the class mining kept most of, so that the
vote confirms exactly that class. The checks are on the files, through
``chip_smoke.check_chain_files`` (as phase 22 of chip_smoke.py checks them on
the card): their presence and the relations between them (ids kept, boxes
replaced, ignores added, base classes merged, the retrain's finite losses).
"""
import functools
import os

import chip_smoke
from lvc_tpu_torch.checkpoint.checkpointer import DetectionCheckpointer
from lvc_tpu_torch.config import get_cfg
from lvc_tpu_torch.modeling.meta_arch.build import build_model
from lvc_tpu_torch.pipeline.verification import DescriptorExtractor
from lvc_tpu_torch.tools import coco_full_run as chain
from lvc_tpu_torch.tools import run_nearest_neighbours
from lvc_tpu_torch.utils.init import damped_init

NARROW = [
    "MODEL.DEVICE", "cpu",
    "MODEL.RESNETS.STEM_OUT_CHANNELS", "16", "MODEL.RESNETS.RES2_OUT_CHANNELS", "32",
    "MODEL.RESNETS.WIDTH_PER_GROUP", "8", "MODEL.FPN.OUT_CHANNELS", "32", "MODEL.ROI_BOX_HEAD.FC_DIM", "64",
    "MODEL.RPN.PRE_NMS_TOPK_TRAIN", "48", "MODEL.RPN.POST_NMS_TOPK_TRAIN", "24",
    "MODEL.RPN.PRE_NMS_TOPK_TEST", "48", "MODEL.RPN.POST_NMS_TOPK_TEST", "16",
    "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", "16", "MODEL.ROI_HEADS.SCORE_THRESH_TEST", "0.0",
    "TEST.DETECTIONS_PER_IMAGE", "60",
    "INPUT.MIN_SIZE_TRAIN", "(64,)", "INPUT.MAX_SIZE_TRAIN", "96", "INPUT.MIN_SIZE_TEST", "64",
    "INPUT.MAX_SIZE_TEST", "96", "PAD.CANVAS_BUCKETS", "[[96, 96]]", "PAD.MAX_GT_PER_IMAGE", "16",
    "DATALOADER.NUM_WORKERS", "1", "SOLVER.IMS_PER_BATCH", "2",
    "SOLVER.CLIP_GRADIENTS.ENABLED", "True", "SOLVER.CLIP_GRADIENTS.CLIP_TYPE", "norm",
    "SOLVER.CLIP_GRADIENTS.CLIP_VALUE", "1.0", "QUERY_EXPAND.NN_MODEL", "dino_vits16", "SEED", "0",
]


def test_chain_runs_every_step_from_the_files_before_it(tmp_path, monkeypatch):
    root = str(tmp_path / "datasets")
    chip_smoke.write_chain_tree(root, 5, 2, 2, sizes=((64, 80), (80, 64)), seed=2, max_boxes=5)
    saved = os.environ.get("DETECTRON2_DATASETS")
    real_dino = run_nearest_neighbours.build_dino

    def one_block(*args, **kwargs):
        model = real_dino(*args, **kwargs)
        model.blocks = model.blocks[:1]
        return model

    monkeypatch.setattr(run_nearest_neighbours, "build_dino", one_block)
    monkeypatch.setattr(run_nearest_neighbours, "DescriptorExtractor",
                        functools.partial(DescriptorExtractor, batch=8, crop_size=32))
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(chain.CONFIGS, "COCO-detection", "faster_rcnn_R_50_FPN_base.yaml"))
    cfg.merge_from_list(NARROW)
    init = DetectionCheckpointer(damped_init(build_model(cfg, device="cpu")), str(tmp_path / "init")).save("init", 0)
    work = tmp_path / "work"
    work.mkdir()
    ran = []
    try:
        cls = chip_smoke.drive_chain(root, str(work), 1, init, opts=NARROW,
                                     run=lambda step, go: (ran.append(step), go()))
    finally:
        chain.use_datasets(saved or "datasets")
        if saved is None:
            os.environ.pop("DETECTRON2_DATASETS")

    assert [s.number.split()[0] for s in ran] == [str(n) for n in range(1, 14)] + ["14", "15", "16", "16"] + [
        "17"] * 6 + ["18"]
    counts = chip_smoke.check_chain_files(str(work), cls, "dino_vits16")
    assert all(n_mined > n_kept > 0 and n_ignore > 0 for n_mined, n_kept, n_ignore in counts.values())
