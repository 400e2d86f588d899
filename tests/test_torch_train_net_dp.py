"""``python -m lvc_tpu_torch.tools.train_net --num-gpus 2`` on the CPU
(``MODEL.DEVICE cpu``: 2 gloo ranks through ``engine/launch.py``).

A narrow R-50-FPN (faster_rcnn_R_50_FPN_base.yaml at 64-wide res2 and FPN,
FC 128, POOLER_IMPL exact) from ``chip_smoke.calibrated_init`` weights on a
seeded COCO tree of 8 train and 4 test images of 96x128: 4 iterations at
IMS_PER_BATCH 4 (2 a rank) with a checkpoint every 2, then the final
evaluation, each rank on its 2 test images, merged on rank 0. Checks: the
checkpoints, ``last_checkpoint`` and ``metrics.json`` come from rank 0
alone (one writer's two rows), the losses are finite, and the merged result
rows and AP equal those of a 1-process ``--eval-only`` run from the last
checkpoint: the same (image, category) rows in order, boxes within 1e-3 px,
scores within 1e-6 and the AP dict within 1e-9, as ``chip_smoke.py`` phase
17 holds its own ``--eval-only`` run.
"""
import json
import math
import os
import subprocess
import sys

import chip_smoke
from lvc_tpu_torch.checkpoint.checkpointer import DetectionCheckpointer
from lvc_tpu_torch.config import get_cfg
from lvc_tpu_torch.data.builtin_meta import _get_builtin_metadata
from lvc_tpu_torch.data.catalog import DatasetCatalog
from lvc_tpu_torch.data.meta_coco import register_meta_coco
from lvc_tpu_torch.engine.defaults import default_argument_parser
from lvc_tpu_torch.modeling.meta_arch.build import build_model
from lvc_tpu_torch.tools import train_net

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAML = os.path.join(REPO, "configs", "COCO-detection", "faster_rcnn_R_50_FPN_base.yaml")
OPTS = [
    "MODEL.DEVICE", "cpu",
    "MODEL.RESNETS.RES2_OUT_CHANNELS", "64",
    "MODEL.RESNETS.WIDTH_PER_GROUP", "16",
    "MODEL.FPN.OUT_CHANNELS", "64",
    "MODEL.ROI_BOX_HEAD.FC_DIM", "128",
    "MODEL.ROI_HEADS.POOLER_IMPL", "exact",
    "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", "64",
    "MODEL.ROI_HEADS.SCORE_THRESH_TEST", "0.001",
    "MODEL.RPN.PRE_NMS_TOPK_TRAIN", "200",
    "MODEL.RPN.POST_NMS_TOPK_TRAIN", "100",
    "MODEL.RPN.PRE_NMS_TOPK_TEST", "300",
    "MODEL.RPN.POST_NMS_TOPK_TEST", "200",
    "PAD.MAX_GT_PER_IMAGE", "8",
    "PAD.CANVAS_BUCKETS", "[[128, 192]]",
    "INPUT.MIN_SIZE_TRAIN", "(96,)",
    "INPUT.MAX_SIZE_TRAIN", "192",
    "INPUT.MIN_SIZE_TEST", "96",
    "INPUT.MAX_SIZE_TEST", "192",
    "DATALOADER.NUM_WORKERS", "1",
    "SOLVER.IMS_PER_BATCH", "4",
    "SOLVER.BASE_LR", "0.01",
    "SOLVER.WARMUP_ITERS", "2",
    "SOLVER.CLIP_GRADIENTS.ENABLED", "True",
    "SOLVER.CLIP_GRADIENTS.CLIP_TYPE", "norm",
    "SOLVER.CLIP_GRADIENTS.CLIP_VALUE", "1.0",
    "SOLVER.MAX_ITER", "4",
    "SOLVER.CHECKPOINT_PERIOD", "2",
    "SEED", "3",
]


def _cli(argv, root):
    env = dict(os.environ, DETECTRON2_DATASETS=root)
    proc = subprocess.run([sys.executable, "-m", "lvc_tpu_torch.tools.train_net", "--config-file", YAML] + argv,
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-6000:]
    return proc.stdout + proc.stderr


def test_train_net_two_ranks_then_eval_only_matches(tmp_path):
    root = str(tmp_path / "datasets")
    chip_smoke.write_coco_tree(root, 8, 4, sizes=((96, 128),), seed=1, max_boxes=5)
    cfg = get_cfg()
    cfg.merge_from_file(YAML)
    cfg.merge_from_list(OPTS)
    model = build_model(cfg, device="cpu")
    chip_smoke.calibrated_init(model, seed=0)
    weights = DetectionCheckpointer(model, str(tmp_path / "w")).save("init", iteration=0)
    out, eval_out = str(tmp_path / "out"), str(tmp_path / "eval")

    log = _cli(["--num-gpus", "2"] + OPTS + ["MODEL.WEIGHTS", weights, "OUTPUT_DIR", out], root)
    assert "Rank 0 of 2" in log and "Rank 1 of 2" not in log  # rank 1 logs warnings only
    with open(os.path.join(out, "metrics.json")) as f:
        rows = [json.loads(line) for line in f]
    iters = [r["iteration"] for r in rows]
    assert iters == [3, 3]  # one writer: its row after the last step and after training (two writers: four rows)
    assert all(math.isfinite(v) for r in rows for k, v in r.items() if k.startswith(("loss", "total")))
    for name in ("model_0000001.pth", "model_0000003.pth", "last_checkpoint", "config.yaml"):
        assert os.path.exists(os.path.join(out, name)), name
    with open(os.path.join(out, "inference", "res_final.json")) as f:
        final = json.load(f)
    merged = chip_smoke.result_rows(os.path.join(out, "inference", "coco_instances_test_results.json"))

    chip_smoke.register_coco_tree(root, DatasetCatalog, register_meta_coco, _get_builtin_metadata("coco_fewshot"))
    res = train_net.main(default_argument_parser().parse_args(
        ["--eval-only", "--config-file", YAML] + OPTS
        + ["MODEL.WEIGHTS", os.path.join(out, "model_0000003.pth"), "OUTPUT_DIR", eval_out]))
    got = chip_smoke.result_rows(os.path.join(eval_out, "inference", "coco_instances_test_results.json"))
    assert len(merged) >= 50 and len(got) == len(merged)
    assert {r["image_id"] for r in merged} == {100001, 100002, 100003, 100004}
    for w, g in zip(merged, got):
        assert (w["image_id"], w["category_id"]) == (g["image_id"], g["category_id"])
        assert max(abs(a - b) for a, b in zip(w["bbox"], g["bbox"])) <= 1e-3
        assert abs(w["score"] - g["score"]) <= 1e-6
    assert set(res["bbox"]) == set(final["bbox"])
    assert all(abs(res["bbox"][k] - v) <= 1e-9 for k, v in final["bbox"].items() if math.isfinite(v))
