"""The port's corrector CLIs against the JAX package's on the CPU, on one
seeded COCO tree (``chip_smoke.write_coco_tree``: 4 train and 3 test images
of 96x128 with 1-5 boxes over the 60 base classes):

- ``train_net --eval-only MODEL.META_ARCHITECTURE ProposalNetwork`` from one
  detector ``.pth`` (narrow R-50-FPN, the RPN's weights scaled for
  well-spread objectness, as tests/test_torch_train_net_cli.py does): both
  proposal pickles, ids equal, boxes abs 1e-3 and logits rel 1e-4 (the two
  frameworks' convs sum in other orders), AR abs 1e-6;
- ``train_net_reg --eval-only MODEL.META_ARCHITECTURE GeneralizedRCNNRegOnly``
  (JAX's eval-only trainer cannot initialise the config's GeneralizedRCNN
  with RBG, which gives no proposals in eval mode) from one converted
  cascade UBBR ``.pth`` (narrow, 3 stages, regressors scaled so that the
  stages move boxes by pixels): the per-class ``iou_in`` equal (the same numpy jitter of the same
  gt) and ``iou_out`` abs 1e-5. ``jitter_candidates`` draws over each padded
  (B, G) batch in turn, so both sides must batch alike: JAX batches over its
  devices (8 virtual CPU devices in these tests), the port takes one image a
  batch, so the JAX tool sees one device here;
- ``train_net_reg_qe --eval-only`` on seeded jittered candidates of the test
  split: ``_ubbr.json`` rows with equal ids and categories, ``bbox`` abs 1e-3;
- the port's ``train_net_reg`` for 2 steps from the proposal file, then
  ``--resume`` to 3: ``last_checkpoint`` is written and the run resumes at
  iteration 2.

The JAX CLIs run with ``INPUT.LOADER_S2D "off"``, the port's batch contract
(tests/test_torch_train_net_cli.py says why). POOLER_IMPL auto runs the exact
pool on the CPU in both packages.
"""
import functools
import json
import os
import pickle
import shutil
import sys
import types

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
from lvc_tpu_torch.tools import train_net, train_net_reg, train_net_reg_qe

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DET_YAML = os.path.join(REPO, "configs", "COCO-detection", "faster_rcnn_R_50_FPN_base.yaml")
UBBR_YAML = os.path.join(REPO, "configs", "COCO-detection", "cascade_ubbr_R_50_FPN_base.yaml")
NARROW = [
    "MODEL.RESNETS.RES2_OUT_CHANNELS", "64",
    "MODEL.RESNETS.WIDTH_PER_GROUP", "16",
    "MODEL.FPN.OUT_CHANNELS", "64",
    "MODEL.ROI_BOX_HEAD.FC_DIM", "128",
    "MODEL.ROI_HEADS.POOLER_IMPL", "auto",
    "MODEL.RPN.PRE_NMS_TOPK_TEST", "300",
    "MODEL.RPN.POST_NMS_TOPK_TEST", "200",
    "INPUT.MIN_SIZE_TRAIN", "(96,)",
    "INPUT.MAX_SIZE_TRAIN", "192",
    "INPUT.MIN_SIZE_TEST", "96",
    "INPUT.MAX_SIZE_TEST", "192",
    "PAD.CANVAS_BUCKETS", "[[128, 192]]",
    "DATALOADER.NUM_WORKERS", "1",
    "SEED", "0",
]
JAX_OPTS = ["INPUT.LOADER_S2D", "'off'"]
PORT_OPTS = ["MODEL.DEVICE", "cpu"]


def _save(var, path):
    torch.save({"model": from_flax(jax.tree_util.tree_map(np.asarray, var))}, path)


def _variables(yaml, arch, scale):
    """He-init JAX variables of the narrow model of ``yaml`` (initialised
    through ``arch``'s eval forward), each kernel whose path holds a key of
    ``scale`` multiplied by its value, the backbone's by 0.7."""
    cfg = jax_get_cfg()
    cfg.merge_from_file(yaml)
    cfg.merge_from_list(NARROW + ["MODEL.META_ARCHITECTURE", arch])
    model = jax_build_model(cfg)
    batch = {"image": jnp.zeros((1, 128, 192, 3)), "image_size": jnp.asarray([[96, 128]], np.int32),
             "gt_boxes": jnp.asarray([[[4.0, 4.0, 40.0, 40.0]]]), "gt_classes": jnp.zeros((1, 1), np.int32),
             "gt_valid": jnp.ones((1, 1), bool)}
    shapes = jax.eval_shape(functools.partial(model.init, train=False), {"params": jax.random.PRNGKey(0)}, batch)
    var = jax.tree_util.tree_map(np.array, materialize_variables(shapes, seed=2, conv_init="he"))

    def walk(tree, path):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            elif k == "kernel":
                p = "/".join(path)
                v *= 0.7 if p.startswith("backbone/bottom_up") else next(
                    (f for key, f in scale.items() if key in p), 1.0)

    walk(var["params"], ())
    return var


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("datasets"))
    chip_smoke.write_coco_tree(root, 4, 3, sizes=((96, 128),), seed=4, max_boxes=5)
    chip_smoke.register_coco_tree(root, jax_catalog.DatasetCatalog, jax_register, jax_meta("coco_fewshot"))
    chip_smoke.register_coco_tree(root, port_catalog.DatasetCatalog, port_register, port_meta("coco_fewshot"))
    det = os.path.join(root, "detector.pth")
    _save(_variables(DET_YAML, "GeneralizedRCNN", {
        "rpn_head/conv": 0.1, "objectness_logits": 0.1, "anchor_deltas": 0.01,
        "cls_score": 0.15, "bbox_pred": 0.3}), det)
    ubbr = os.path.join(root, "ubbr.pth")
    _save(_variables(UBBR_YAML, "GeneralizedRCNNRegOnly", {"bbox_pred": 0.05}), ubbr)
    yield root, det, ubbr
    original = os.environ.get("DETECTRON2_DATASETS", "datasets")
    chip_smoke.register_coco_tree(original, jax_catalog.DatasetCatalog, jax_register, jax_meta("coco_fewshot"))
    chip_smoke.register_coco_tree(original, port_catalog.DatasetCatalog, port_register, port_meta("coco_fewshot"))


def _jax_tool(name):
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        return __import__(name)
    finally:
        sys.path.pop(0)


@pytest.fixture(scope="module")
def proposals(tree):
    """Both CLIs' ProposalNetwork runs over the test and trainval splits."""
    root, det, _ = tree
    out = {}
    for side, module, parser, extra in (("jax", _jax_tool("train_net"), jax_parser, JAX_OPTS),
                                        ("port", train_net, default_argument_parser, PORT_OPTS)):
        out_dir = os.path.join(root, f"proposals_{side}")
        res = module.main(parser().parse_args([
            "--eval-only", "--config-file", DET_YAML, *NARROW, "MODEL.WEIGHTS", det,
            "MODEL.META_ARCHITECTURE", "ProposalNetwork",
            "DATASETS.TEST", "('coco_test_base', 'coco_trainval_base')", "OUTPUT_DIR", out_dir, *extra,
        ]))
        out[side] = res, out_dir
    return out


def test_proposal_network_cli_matches_jax(proposals):
    (want_res, want_dir), (got_res, got_dir) = proposals["jax"], proposals["port"]
    for split in ("test", "trainval"):
        name = f"coco_proposals_{split}_results.pkl"
        with open(os.path.join(want_dir, name), "rb") as f:
            want = pickle.load(f)
        with open(os.path.join(got_dir, name), "rb") as f:
            got = pickle.load(f)
        assert sorted(got["ids"]) == sorted(want["ids"]) and len(got["ids"]) == (3 if split == "test" else 4)
        w = dict(zip(want["ids"], zip(want["boxes"], want["objectness_logits"])))
        for i, boxes, logits in zip(got["ids"], got["boxes"], got["objectness_logits"]):
            assert boxes.shape == w[i][0].shape and len(boxes) > 50
            np.testing.assert_allclose(boxes, w[i][0], rtol=0, atol=1e-3)
            np.testing.assert_allclose(logits, w[i][1], rtol=1e-4, atol=1e-6)
    want, got = want_res["coco_test_base"]["bbox"], got_res["coco_test_base"]["bbox"]
    assert list(got) == list(want) == ["AR@100", "AR@1000", "bAR@100", "bAR@1000"]
    for k, v in want.items():
        assert got[k] == pytest.approx(v, abs=1e-6), k
    assert want_res["coco_trainval_base"] == got_res["coco_trainval_base"] == {}


def test_train_net_reg_eval_only_matches_jax(tree, monkeypatch):
    root, _, ubbr = tree
    jax_reg = _jax_tool("train_net_reg")
    # the JAX test batches over its devices: one, as the port's batch of one image
    monkeypatch.setattr(jax_reg, "jax", types.SimpleNamespace(devices=lambda: jax.devices()[:1],
                                                              tree_util=jax.tree_util))
    # JAX's eval-only trainer initialises the config's meta-architecture in
    # eval mode, where RBG gives no proposals: it needs the reg-only one
    args = ["--eval-only", "--config-file", UBBR_YAML, *NARROW, "MODEL.WEIGHTS", ubbr,
            "MODEL.META_ARCHITECTURE", "GeneralizedRCNNRegOnly"]
    want = jax_reg.main(jax_parser().parse_args(args + ["OUTPUT_DIR", os.path.join(root, "reg_jax"), *JAX_OPTS]))
    got = train_net_reg.main(default_argument_parser().parse_args(
        args + ["OUTPUT_DIR", os.path.join(root, "reg_port"), *PORT_OPTS]))
    with open(os.path.join(root, "reg_port", "inference", "results_coco_test_base.json")) as f:
        assert json.load(f) == got["ubbr"]
    want, got = want["ubbr"]["per_class"], got["ubbr"]["per_class"]
    assert list(got) == list(want) and len(got) >= 5
    moved = 0.0
    for c, w in want.items():
        assert got[c]["n"] == w["n"] and got[c]["iou_in"] == w["iou_in"], c
        assert got[c]["iou_out"] == pytest.approx(w["iou_out"], abs=1e-5), c
        moved = max(moved, abs(w["iou_out"] - w["iou_in"]))
    assert moved > 1e-3  # the corrector moves the boxes


def test_train_net_reg_qe_matches_jax(tree):
    root, _, ubbr = tree
    covered = {k for k, v in port_meta("coco_fewshot")["thing_dataset_id_to_contiguous_id"].items() if v < 60}
    rows = {}
    for side, module, parser, extra in (("jax", _jax_tool("train_net_reg_qe"), jax_parser, JAX_OPTS),
                                        ("port", train_net_reg_qe, default_argument_parser, PORT_OPTS)):
        cands = os.path.join(root, f"candidates_{side}.json")
        n = chip_smoke.write_candidates(os.path.join(root, "cocosplit", "datasplit", "5k.json"), cands, covered)
        module.main(parser().parse_args([
            "--eval-only", "--config-file", UBBR_YAML, *NARROW, "MODEL.WEIGHTS", ubbr,
            "DATASETS.TRAIN", "('coco_test_base',)", "DATASETS.DT_PATH", f"('{cands}',)",
            "MODEL.LOAD_PROPOSALS", "False", "QUERY_EXPAND.ENABLED", "True",
            "OUTPUT_DIR", os.path.join(root, f"qe_{side}"), *extra,
        ]))
        with open(cands.replace(".json", "_ubbr.json")) as f:
            rows[side] = sorted(json.load(f), key=lambda r: r["id"])
    assert len(rows["port"]) == len(rows["jax"]) == n >= 5
    for g, w in zip(rows["port"], rows["jax"]):
        assert (g["id"], g["image_id"], g["category_id"]) == (w["id"], w["image_id"], w["category_id"])
        np.testing.assert_allclose(g["bbox"], w["bbox"], rtol=0, atol=1e-3)
        np.testing.assert_allclose(g["bbox_orig"], w["bbox_orig"], rtol=0, atol=1e-4)


def test_train_net_reg_trains_and_resumes(tree, proposals):
    root, _, ubbr = tree
    out = os.path.join(root, "reg_train")
    shutil.rmtree(out, ignore_errors=True)
    prop = os.path.join(proposals["port"][1], "coco_proposals_trainval_results.pkl")
    args = ["--config-file", UBBR_YAML, *NARROW, *PORT_OPTS, "MODEL.WEIGHTS", ubbr,
            "DATASETS.PROPOSAL_FILES_TRAIN", f"('{prop}',)", "SOLVER.IMS_PER_BATCH", "2",
            "SOLVER.CHECKPOINT_PERIOD", "1", "OUTPUT_DIR", out]
    res = train_net_reg.main(default_argument_parser().parse_args(args + ["SOLVER.MAX_ITER", "2"]))
    assert res["ubbr"]["per_class"]
    with open(os.path.join(out, "last_checkpoint")) as f:
        assert f.read().strip() == "model_0000001.pth"
    with open(os.path.join(out, "metrics.json")) as f:
        last = [json.loads(line) for line in f][-1]
    assert last["iteration"] == 1 and all(np.isfinite(last[f"loss_box_reg_stage{k}"]) for k in range(3))

    starts = []
    saved = train_net_reg.RegTrainer

    class Probe(saved):
        def resume_or_load(self, resume=True):
            out = super().resume_or_load(resume)
            starts.append(self.start_iter)
            return out

    train_net_reg.RegTrainer = Probe
    try:
        train_net_reg.main(default_argument_parser().parse_args(["--resume"] + args + ["SOLVER.MAX_ITER", "3"]))
    finally:
        train_net_reg.RegTrainer = saved
    assert starts == [2]
    with open(os.path.join(out, "last_checkpoint")) as f:
        assert f.read().strip() == "model_0000002.pth"
