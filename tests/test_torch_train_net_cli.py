"""The port's training CLI against ``tools/train_net.py``, both ``--eval-only``
on the CPU from one ``.pth`` on one seeded COCO tree.

The tree (``chip_smoke.write_coco_tree``): 4 test images of 96x128 with 1-6
boxes over the 60 base classes, evaluated as ``coco_test_base``. The model:
a narrow R-50-FPN (RES2_OUT_CHANNELS 64, WIDTH_PER_GROUP 16, FPN 64 wide,
FC 128, POOLER_IMPL exact) with he-init weights scaled for well-spread
logits (no near-ties in NMS or the top-k), saved once as a detectron2-named
``.pth`` that both CLIs load through ``MODEL.WEIGHTS``. The JAX CLI runs with
``INPUT.LOADER_S2D "off"``, the port's batch contract: JAX's space-to-depth
loader fills the canvas beyond the image with normalized zero pixels, where
the plain canvas (and detectron2) holds zeros after normalizing, so near
the padding its detections differ from its own plain path's. Otherwise it
takes its defaults (batches of 8 over the virtual devices); the port's CLI
takes batches of 1. ``SCORE_THRESH_TEST`` is 0.001 so that the random
detector emits rows at all.

Tolerances: the same result rows, matched in order of (image, category,
score): boxes within 1e-3 px and scores within rel 1e-4 (the two forwards'
float32 sums in other orders); the AP dicts within 1e-6.
"""
import functools
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from lvc_tpu.config import get_cfg as jax_get_cfg
from lvc_tpu.data import builtin as jax_builtin  # noqa: F401
from lvc_tpu.data import catalog as jax_catalog
from lvc_tpu.data.builtin_meta import _get_builtin_metadata as jax_meta
from lvc_tpu.data.meta_coco import register_meta_coco as jax_register
from lvc_tpu.engine.defaults import default_argument_parser as jax_parser
from lvc_tpu.modeling.meta_arch.build import build_model as jax_build_model
from lvc_tpu.utils.init import materialize_variables
from lvc_tpu_torch.checkpoint.convert import from_flax
from lvc_tpu_torch.data import builtin  # noqa: F401
from lvc_tpu_torch.data import catalog as port_catalog
from lvc_tpu_torch.data.builtin_meta import _get_builtin_metadata as port_meta
from lvc_tpu_torch.data.meta_coco import register_meta_coco as port_register
from lvc_tpu_torch.engine.defaults import default_argument_parser
from lvc_tpu_torch.tools import train_net

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NARROW = [
    "MODEL.RESNETS.DEPTH", "50",
    "MODEL.RESNETS.RES2_OUT_CHANNELS", "64",
    "MODEL.RESNETS.WIDTH_PER_GROUP", "16",
    "MODEL.FPN.OUT_CHANNELS", "64",
    "MODEL.ROI_BOX_HEAD.FC_DIM", "128",
    "MODEL.ROI_HEADS.POOLER_IMPL", "exact",
    "MODEL.ROI_HEADS.SCORE_THRESH_TEST", "0.001",
    "MODEL.RPN.PRE_NMS_TOPK_TEST", "300",
    "MODEL.RPN.POST_NMS_TOPK_TEST", "200",
    "INPUT.MIN_SIZE_TEST", "96",
    "INPUT.MAX_SIZE_TEST", "192",
    "PAD.CANVAS_BUCKETS", "[[128, 192]]",
    "DATALOADER.NUM_WORKERS", "1",
    "SEED", "0",
]


def _weights(path):
    """Narrow he-init weights, the backbone damped and the heads scaled so
    that proposals and class scores spread, saved as ``{"model": ...}``."""
    cfg = jax_get_cfg()
    cfg.merge_from_file(os.path.join(REPO, "configs", "COCO-detection", "faster_rcnn_R_50_FPN_base.yaml"))
    cfg.merge_from_list(NARROW)
    model = jax_build_model(cfg)
    batch = {"image": jnp.zeros((1, 128, 192, 3)), "image_size": jnp.asarray([[96, 128]], np.int32)}
    shapes = jax.eval_shape(functools.partial(model.init, train=False), {"params": jax.random.PRNGKey(0)}, batch)
    var = jax.tree_util.tree_map(np.asarray, materialize_variables(shapes, seed=2, conv_init="he"))
    for block in var["params"]["backbone"]["bottom_up"].values():
        for leaf in jax.tree_util.tree_leaves(block):
            if leaf.ndim == 4:
                leaf *= 0.7
    rpn = var["params"]["proposal_generator"]["rpn_head"]
    rpn["conv"]["conv"]["kernel"] *= 0.1
    rpn["objectness_logits"]["conv"]["kernel"] *= 0.1
    rpn["anchor_deltas"]["conv"]["kernel"] *= 0.01
    head = var["params"]["roi_heads"]["box_predictor"]
    head["cls_score"]["kernel"] *= 0.15
    head["bbox_pred"]["kernel"] *= 0.3
    torch.save({"model": from_flax(var)}, path)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("datasets"))
    chip_smoke.write_coco_tree(root, 1, 4, sizes=((96, 128),), seed=4, max_boxes=6)
    chip_smoke.register_coco_tree(root, jax_catalog.DatasetCatalog, jax_register, jax_meta("coco_fewshot"))
    chip_smoke.register_coco_tree(root, port_catalog.DatasetCatalog, port_register, port_meta("coco_fewshot"))
    weights = os.path.join(root, "weights.pth")
    _weights(weights)
    yield root, weights
    original = os.environ.get("DETECTRON2_DATASETS", "datasets")
    chip_smoke.register_coco_tree(original, jax_catalog.DatasetCatalog, jax_register, jax_meta("coco_fewshot"))
    chip_smoke.register_coco_tree(original, port_catalog.DatasetCatalog, port_register, port_meta("coco_fewshot"))


def _args(parser, weights, out_dir, extra=()):
    return parser().parse_args([
        "--eval-only",
        "--config-file", os.path.join(REPO, "configs", "COCO-detection", "faster_rcnn_R_50_FPN_base.yaml"),
        *NARROW, "MODEL.WEIGHTS", weights, "OUTPUT_DIR", out_dir, *extra,
    ])


def _rows(out_dir):
    with open(os.path.join(out_dir, "inference", "coco_instances_test_results.json")) as f:
        rows = json.load(f)
    return sorted(rows, key=lambda r: (r["image_id"], r["category_id"], -r["score"]))


def test_eval_only_cli_matches_jax_cli(tree):
    root, weights = tree
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import train_net as jax_cli
    finally:
        sys.path.pop(0)
    want = jax_cli.main(_args(jax_parser, weights, os.path.join(root, "jax"), ["INPUT.LOADER_S2D", "'off'"]))
    got = train_net.main(_args(default_argument_parser, weights, os.path.join(root, "port"), ["MODEL.DEVICE", "cpu"]))

    got_rows, want_rows = _rows(os.path.join(root, "port")), _rows(os.path.join(root, "jax"))
    assert len(got_rows) == len(want_rows) > 100
    for g, w in zip(got_rows, want_rows):
        assert (g["image_id"], g["category_id"]) == (w["image_id"], w["category_id"])
        np.testing.assert_allclose(g["bbox"], w["bbox"], rtol=0, atol=1e-3)
        assert g["score"] == pytest.approx(w["score"], rel=1e-4)
    assert list(got) == list(want) == ["bbox"]
    assert list(got["bbox"]) == list(want["bbox"])
    for k, v in want["bbox"].items():
        assert got["bbox"][k] == pytest.approx(v, abs=1e-6, nan_ok=True), k
    assert "bAP50" in got["bbox"] and "AP" in got["bbox"]


def test_cli_refuses_unported_evaluators(tree):
    root, weights = tree
    from lvc_tpu_torch.config import get_cfg

    from lvc_tpu_torch.evaluation.rpn_evaluation import RPNEvaluator

    cfg = get_cfg()
    cfg.MODEL.META_ARCHITECTURE = "ProposalNetwork"
    cfg.OUTPUT_DIR = os.path.join(root, "proposals")
    evaluator = train_net.Trainer.build_evaluator(cfg, "coco_test_base")
    assert isinstance(evaluator, RPNEvaluator) and evaluator._output_dir == cfg.OUTPUT_DIR
    # the VOC and LVIS types build JAX's evaluators (tools/train_net.py:34-44); an unknown type raises
    from lvc_tpu_torch.evaluation.lvis_evaluation import LVISEvaluator
    from lvc_tpu_torch.evaluation.pascal_voc_evaluation import PascalVOCDetectionEvaluator

    port_catalog.MetadataCatalog.get("cli_voc_probe").set(evaluator_type="pascal_voc", thing_classes=["a", "b"])
    assert isinstance(train_net.Trainer.build_evaluator(get_cfg(), "cli_voc_probe"), PascalVOCDetectionEvaluator)
    port_catalog.MetadataCatalog.get("cli_lvis_probe").set(evaluator_type="lvis")
    cfg = get_cfg()
    cfg.OUTPUT_DIR = os.path.join(root, "lvis")
    evaluator = train_net.Trainer.build_evaluator(cfg, "cli_lvis_probe")
    assert isinstance(evaluator, LVISEvaluator) and evaluator._output_dir == os.path.join(root, "lvis", "inference")
    port_catalog.MetadataCatalog.get("cli_unknown_probe").set(evaluator_type="cityscapes")
    with pytest.raises(NotImplementedError, match="no evaluator for type cityscapes"):
        train_net.Trainer.build_evaluator(get_cfg(), "cli_unknown_probe")
