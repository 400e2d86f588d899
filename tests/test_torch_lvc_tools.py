"""The LVC loop's host tools and ``train_net_qe_ig`` against the JAX package's
tools on the CPU.

The tree is ``chip_smoke.write_chain_tree``'s (80 classes, 30-shot files,
an unlabeled split), registered as every COCO split in both catalogs.

- Mining (``create_coco_dataset_from_dets_all``) on seeded detection files
  of the training and unlabeled splits: the score band with ``--full``, the
  rank band (``--top``), ``--all-cats`` and an area-ratio bound (``--ar``).
- ``combine_ubbr_with_qe``, ``combine_pseudo_with_ignore`` (a COCO
  dataset, and a result list that goes through ``loadRes``) and
  ``combine_qe_with_base`` (with and without ``--base-ignore``) on the
  mined files and seeded corrected boxes.
  Each tool writes next to its input, so each package works on its own copy;
  the written JSONs must be equal (no tolerance).
- ``train_net_qe_ig`` on ``faster_rcnn_R_50_FPN_ft_all_30shot_aug_ftmore_dropout.yaml``
  as coco_full_run step 18 calls it (``BACKBONE.FREEZE False``,
  ``QUERY_EXPAND.ENABLED``), narrowed (64-wide res2 and FPN, FC 64,
  exhaustive sampling, ``DROPOUT`` 0, one loader worker) on a pseudo-label
  file with ignore boxes, from the same weights (JAX's he-init, scaled as in
  tests/test_torch_trainer.py) in both trainers: each iteration's losses
  within rel 1e-4, the tolerance of tests/test_torch_trainer.py.
"""
import functools
import json
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke
from lvc_tpu.config import get_cfg as jax_get_cfg
from lvc_tpu.data import builtin as jax_builtin
from lvc_tpu.data import catalog as jax_catalog
from lvc_tpu.engine.defaults import default_argument_parser as jax_parser
from lvc_tpu.modeling.meta_arch.build import build_model as jax_build_model
from lvc_tpu.utils.init import materialize_variables
from lvc_tpu_torch.checkpoint.convert import from_flax
from lvc_tpu_torch.engine.defaults import default_argument_parser
from lvc_tpu_torch.tools import (
    combine_pseudo_with_ignore,
    combine_qe_with_base,
    combine_ubbr_with_qe,
    coco_full_run,
    create_coco_dataset_from_dets_all,
    train_net_qe_ig,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FT_YAML = os.path.join(REPO, "configs", "COCO-detection", "faster_rcnn_R_50_FPN_ft_all_30shot_aug_ftmore_dropout.yaml")
NARROW = [
    "MODEL.RESNETS.RES2_OUT_CHANNELS", "64", "MODEL.RESNETS.WIDTH_PER_GROUP", "16",
    "MODEL.FPN.OUT_CHANNELS", "64", "MODEL.ROI_BOX_HEAD.FC_DIM", "64", "MODEL.ROI_BOX_HEAD.DROPOUT", "0.0",
    "MODEL.ROI_HEADS.POOLER_IMPL", "exact",
    "MODEL.RPN.PRE_NMS_TOPK_TRAIN", "200", "MODEL.RPN.POST_NMS_TOPK_TRAIN", "100",
    "MODEL.RPN.BATCH_SIZE_PER_IMAGE", "8192", "MODEL.RPN.POSITIVE_FRACTION", "0.999",
    "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", "128", "MODEL.ROI_HEADS.POSITIVE_FRACTION", "0.999",
    "INPUT.LOADER_S2D", "'off'", "INPUT.MIN_SIZE_TRAIN", "(96,)", "INPUT.MAX_SIZE_TRAIN", "128",
    "PAD.CANVAS_BUCKETS", "[[128, 128]]", "PAD.MAX_GT_PER_IMAGE", "12",
    "DATALOADER.NUM_WORKERS", "1", "SOLVER.IMS_PER_BATCH", "2", "SOLVER.MAX_ITER", "2",
    "SOLVER.CHECKPOINT_PERIOD", "100", "DATASETS.TEST", "()", "SEED", "3",
]


def _use_jax(root):
    for name in jax_catalog.DatasetCatalog.list():
        if name.startswith("coco_"):
            jax_catalog.DatasetCatalog.remove(name)
    jax_builtin.register_all_coco(root)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("datasets"))
    chip_smoke.write_chain_tree(root, 8, 2, 4, sizes=((96, 128), (128, 96)), seed=5, max_boxes=6)
    saved = os.environ.get("DETECTRON2_DATASETS")
    coco_full_run.use_datasets(root)
    _use_jax(root)
    yield root
    original = saved or "datasets"
    coco_full_run.use_datasets(original)
    _use_jax(original)
    if saved is None:
        os.environ.pop("DETECTRON2_DATASETS")


def _detections(root, split, seed):
    """Seeded detector rows on a split's images: 12 per image over four
    unseen and two seen classes."""
    ann = {"trainval": "cocosplit/datasplit/trainvalno5k.json",
           "unlabeled": "coco/annotations/image_info_unlabeled2017.json"}[split]
    with open(os.path.join(root, ann)) as f:
        images = json.load(f)["images"]
    rng = np.random.RandomState(seed)
    rows = []
    for im in images:
        for _ in range(12):
            w, h = rng.uniform(8, im["width"] / 2), rng.uniform(8, im["height"] / 2)
            x, y = rng.uniform(0, im["width"] - w), rng.uniform(0, im["height"] - h)
            rows.append({"image_id": im["id"], "category_id": int(rng.choice([1, 3, 18, 62, 8, 10])),
                         "bbox": [x, y, w, h], "score": float(rng.uniform(0.3, 1.0))})
    return rows


@pytest.fixture(scope="module")
def tools():
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import combine_pseudo_with_ignore as j_ignore
        import combine_qe_with_base as j_base
        import combine_ubbr_with_qe as j_ubbr
        import create_coco_dataset_from_dets_all as j_mine
        import train_net_qe_ig as j_qe_ig
    finally:
        sys.path.pop(0)
    return {
        "mine": (j_mine, create_coco_dataset_from_dets_all),
        "ubbr": (j_ubbr, combine_ubbr_with_qe),
        "ignore": (j_ignore, combine_pseudo_with_ignore),
        "base": (j_base, combine_qe_with_base),
        "qe_ig": (j_qe_ig, train_net_qe_ig),
    }


def _both(pair, tmp, inputs, make_argv):
    """Run the JAX tool and the port's on their own copies of ``inputs``
    (name -> path), check that they write equal files of one name, and
    return the port's file's content and path."""
    out = {}
    for side, tool in zip(("jax", "port"), pair):
        d = os.path.join(tmp, side)
        os.makedirs(d, exist_ok=True)
        paths = {k: shutil.copy(v, os.path.join(d, os.path.basename(v))) for k, v in inputs.items()}
        written = tool.main(tool.parser.parse_args(make_argv(paths)))
        with open(written) as f:
            out[side] = os.path.basename(written), json.load(f)
    assert out["port"][0] == out["jax"][0]
    assert out["port"][1] == out["jax"][1]
    return out["port"][1], os.path.join(tmp, "port", out["port"][0])


MINING = {
    "score_full": ("trainval", ["--full", "--K-min", "0.6", "--K-max", "1.0"]),
    "top": ("trainval", ["--top", "--K-min", "5", "--K-max", "1"]),
    "area_ratio": ("trainval", ["--full", "--K-min", "0.5", "--K-max", "0.95", "--ar", "0.02"]),
    "unlabeled_all_cats": ("unlabeled", ["--full", "--K-min", "0.6", "--K-max", "1.0", "--all-cats"]),
}


@pytest.mark.parametrize("case", list(MINING))
def test_mining_matches_jax(tree, tools, tmp_path, case):
    split, flags = MINING[case]
    dt = tmp_path / f"coco_instances_{split}_results.json"
    dt.write_text(json.dumps(_detections(tree, split, seed=len(case))))
    got, _ = _both(tools["mine"], str(tmp_path), {"dt": str(dt)}, lambda p: [
        "--json-data", f"coco_{split}_all", "--gt-data", "coco_trainval_all_30shot", *flags, "--dt-path", p["dt"]])
    kept = [a for a in got["annotations"] if not a.get("ignore_qe")]
    assert kept and got["images"]
    if "--full" in flags:
        assert any(a.get("ignore_qe") for a in got["annotations"])


def test_combine_tools_match_jax(tree, tools, tmp_path):
    dt = tmp_path / "coco_instances_trainval_results.json"
    dt.write_text(json.dumps(_detections(tree, "trainval", seed=11)))
    mined, mined_path = _both(tools["mine"], str(tmp_path / "mine"), {"dt": str(dt)}, lambda p: [
        "--json-data", "coco_trainval_all", "--gt-data", "coco_trainval_all_30shot", "--full", "--K-min", "0.6",
        "--K-max", "1.0", "--dt-path", p["dt"]])
    # the verified candidates: every other kept one; their corrected boxes, moved a little
    kept = [a for a in mined["annotations"] if not a.get("ignore_qe")][::2]
    verified = tmp_path / "verified.json"
    verified.write_text(json.dumps(dict(mined, annotations=kept)))
    rng = np.random.RandomState(0)
    ubbr = tmp_path / "verified_ubbr.json"
    ubbr.write_text(json.dumps([
        {"id": a["id"], "image_id": a["image_id"], "category_id": a["category_id"], "score": a["score"],
         "bbox": [float(v + rng.uniform(-2, 2)) for v in a["bbox"]], "bbox_orig": a["bbox"]} for a in kept]))

    got, id_path = _both(tools["ubbr"], str(tmp_path / "ubbr"), {"ubbr": str(ubbr), "qe": str(verified)},
                            lambda p: ["--ubbr-data", p["ubbr"], "--qe-data", p["qe"]])
    assert {a["id"] for a in got["annotations"]} == {a["id"] for a in kept}
    got, ignore_path = _both(tools["ignore"], str(tmp_path / "ignore"), {"ps": id_path, "ig": mined_path},
                                lambda p: ["--ps-data", p["ps"], "--ig-data", p["ig"]])
    assert any(a.get("ignore_qe") for a in got["annotations"])
    # a result list as the pseudo-annotations: COCO refuses it and loadRes renumbers it
    results = tmp_path / "results.json"
    results.write_text(json.dumps([{k: a[k] for k in ("image_id", "category_id", "bbox", "score")} for a in kept]))
    _both(tools["ignore"], str(tmp_path / "ignore_results"), {"ps": str(results), "ig": mined_path},
          lambda p: ["--ps-data", p["ps"], "--ig-data", p["ig"]])
    base = os.path.join(tree, "cocosplit", "datasplit", "trainvalno5k.json")
    for flag in ([], ["--base-ignore"]):
        got, _ = _both(tools["base"], str(tmp_path / f"base{len(flag)}"), {"ps": ignore_path, "bs": base},
                          lambda p: ["--ps-data", p["ps"], "--bs-data", p["bs"], *flag])
        assert len(got["annotations"]) > len(kept)


def _ft_variables():
    cfg = jax_get_cfg()
    cfg.merge_from_file(FT_YAML)
    cfg.merge_from_list(NARROW)
    model = jax_build_model(cfg)
    batch = {"image": jnp.zeros((1, 128, 128, 3)), "image_size": jnp.asarray([[96, 128]], np.int32)}
    shapes = jax.eval_shape(functools.partial(model.init, train=False), {"params": jax.random.PRNGKey(0)}, batch)
    var = jax.tree_util.tree_map(np.asarray, materialize_variables(shapes, seed=0, conv_init="he"))
    for block in var["params"]["backbone"]["bottom_up"].values():
        for leaf in jax.tree_util.tree_leaves(block):
            if leaf.ndim == 4:
                leaf *= 0.7
    rpn = var["params"]["proposal_generator"]["rpn_head"]
    rpn["conv"]["conv"]["kernel"] *= 0.1
    rpn["objectness_logits"]["conv"]["kernel"] *= 0.1
    rpn["anchor_deltas"]["conv"]["kernel"] *= 0.01
    var["params"]["roi_heads"]["box_predictor"]["bbox_pred"]["kernel"] *= 0.3
    return var


def test_train_net_qe_ig_matches_jax(tree, tools, tmp_path, monkeypatch):
    """Step 18 on a pseudo-label file whose boxes include ignore regions."""
    with open(os.path.join(tree, "cocosplit", "datasplit", "trainvalno5k.json")) as f:
        gt = json.load(f)
    rng = np.random.RandomState(2)
    anns = []
    for im in gt["images"][:6]:
        for k in range(3):
            w, h = rng.uniform(16, 40, 2)
            x, y = rng.uniform(0, im["width"] - w), rng.uniform(0, im["height"] - h)
            anns.append({"id": 50000 + len(anns), "image_id": im["id"], "category_id": (1, 18, 8)[k],
                         "bbox": [x, y, w, h], "area": w * h, "score": 0.9, "iscrowd": 0, "ignore_qe": int(k == 2)})
    pseudo = tmp_path / "pseudo_wbase.json"
    pseudo.write_text(json.dumps({"images": gt["images"][:6], "annotations": anns, "categories": gt["categories"]}))
    variables = _ft_variables()
    (j_tool, p_tool) = tools["qe_ig"]
    monkeypatch.setattr(j_tool.TrainerQEIgnore, "_materialize",
                        lambda self, shapes, seed: jax.tree_util.tree_map(np.array, variables))
    monkeypatch.setattr(p_tool.TrainerQEIgnore, "_materialize",
                        lambda self, model, seed: model.load_state_dict(from_flax(variables)))
    storages = {}
    for side, tool, parser in (("jax", j_tool, jax_parser), ("port", p_tool, default_argument_parser)):
        cls = tool.TrainerQEIgnore
        monkeypatch.setattr(cls, "train", lambda self, cls=cls, side=side: (
            storages.__setitem__(side, self), super(cls, self).train())[1])
        extra = ["MODEL.DEVICE", "cpu"] if side == "port" else []
        tool.main(parser().parse_args([
            "--config-file", FT_YAML, *NARROW, *extra, "OUTPUT_DIR", str(tmp_path / side), "MODEL.WEIGHTS", "",
            "DATASETS.DT_PATH", f"('{pseudo}',)", "QUERY_EXPAND.ENABLED", "True", "MODEL.BACKBONE.FREEZE", "False"]))
    keys = ("loss_rpn_cls", "loss_rpn_loc", "loss_cls", "loss_box_reg", "total_loss")
    for k in keys:
        got = list(storages["port"].storage.histories()[k]._deque)
        want = list(storages["jax"].storage.histories()[k]._deque)
        assert len(got) == len(want) == 2, k
        for g, w in zip(got, want):
            assert g == pytest.approx(w, rel=1e-4), (k, got, want)
