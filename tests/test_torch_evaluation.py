"""The port's COCOEvaluator, result rows and result checks against the JAX
package's on the CPU.

Seeded ground truth on 8 images of 480x640 over 10 COCO categories (6 base,
4 novel), registered in both catalogs as ``*_test_all``, ``*_test_base`` and
``*_test_novel`` with the few-shot COCO metadata. The same padded
detections (10 slots an image at a 600x800 canvas, some invalid; a padded
last batch) go to both evaluators: the port's as torch tensors, JAX's as
numpy arrays. Tolerance: none. The result dicts (the all/base/novel split
with its b/n prefixes and the per-category APs) and the result JSON equal
JAX's, and so do ``verify_results``, ``flatten_results_dict`` and
``print_csv_format``.
"""
import json
import logging
import math
import os

import numpy as np
import pytest
import torch

from lvc_tpu.config import get_cfg as jax_get_cfg
from lvc_tpu.data import catalog as jax_catalog
from lvc_tpu.data.builtin_meta import _get_builtin_metadata as jax_meta
from lvc_tpu.data.meta_coco import register_meta_coco as jax_register
from lvc_tpu.evaluation import testing as jax_testing
from lvc_tpu.evaluation.coco_evaluation import COCOEvaluator as JaxEvaluator
from lvc_tpu.modeling.roi_heads.fast_rcnn import Detections as JaxDetections
from lvc_tpu_torch.config import get_cfg
from lvc_tpu_torch.data import catalog as port_catalog
from lvc_tpu_torch.data.builtin_meta import _get_builtin_metadata as port_meta
from lvc_tpu_torch.data.meta_coco import register_meta_coco as port_register
from lvc_tpu_torch.evaluation import testing
from lvc_tpu_torch.evaluation.coco_evaluation import COCOEvaluator
from lvc_tpu_torch.modeling.roi_heads.fast_rcnn import Detections

BASE_IDS = [8, 10, 11, 13, 14, 15]
NOVEL_IDS = [1, 2, 3, 18]
N_IMG, D = 8, 10
SCALE = 1.25  # canvas / original


@pytest.fixture(scope="module")
def gt_file(tmp_path_factory):
    root = tmp_path_factory.mktemp("evaltree")
    rng = np.random.RandomState(0)
    from lvc_tpu_torch.data.builtin_meta import COCO_CATEGORIES

    images = [{"id": i + 1, "file_name": f"{i}.jpg", "height": 480, "width": 640} for i in range(N_IMG)]
    anns = []
    for img in images:
        for _ in range(rng.randint(1, 6)):
            w, h = rng.uniform(20, 250, 2)
            x, y = rng.uniform(0, 640 - w), rng.uniform(0, 480 - h)
            anns.append({"id": len(anns) + 1, "image_id": img["id"],
                         "category_id": int(rng.choice(BASE_IDS + NOVEL_IDS)),
                         "bbox": [x, y, w, h], "area": w * h, "iscrowd": int(rng.rand() < 0.1)})
    path = str(root / "gt.json")
    with open(path, "w") as f:
        json.dump({"images": images, "annotations": anns,
                   "categories": [{"id": c["id"], "name": c["name"]} for c in COCO_CATEGORIES]}, f)
    for split in ("all", "base", "novel"):
        name = f"evaltree_test_{split}"
        for catalog, register, meta in ((jax_catalog.DatasetCatalog, jax_register, jax_meta),
                                        (port_catalog.DatasetCatalog, port_register, port_meta)):
            if name in catalog:
                catalog.remove(name)
            register(name, meta("coco_fewshot"), str(root), path)
    return path, anns


def _detections(anns, split, seed):
    """Padded detections near the ground truth (in the 1.25x canvas) and
    false positives, with contiguous class ids of the split's metadata."""
    meta = port_meta("coco_fewshot")
    id_map = {"all": meta["thing_dataset_id_to_contiguous_id"],
              "base": meta["base_dataset_id_to_contiguous_id"],
              "novel": meta["novel_dataset_id_to_contiguous_id"]}[split]
    rng = np.random.RandomState(seed)
    boxes = np.zeros((N_IMG, D, 4), np.float32)
    scores = np.zeros((N_IMG, D), np.float32)
    classes = np.zeros((N_IMG, D), np.int64)
    valid = np.zeros((N_IMG, D), bool)
    for i in range(N_IMG):
        own = [a for a in anns if a["image_id"] == i + 1 and a["category_id"] in id_map]
        for j in range(D):
            if j < len(own) and rng.rand() < 0.8:
                x, y, w, h = np.asarray(own[j]["bbox"]) + rng.normal(0, 6, 4)
                cat = id_map[own[j]["category_id"]]
            else:
                x, y, w, h = rng.uniform([0, 0, 10, 10], [500, 380, 140, 100])
                cat = rng.randint(len(id_map))
            boxes[i, j] = np.array([x, y, x + w, y + h]) * SCALE
            scores[i, j] = rng.uniform(0.05, 1.0)
            classes[i, j] = cat
            valid[i, j] = rng.rand() < 0.9
    return boxes, scores, classes, valid


def _metas(ids):
    return [{"image_id": i + 1, "orig_size": np.array([480, 640], np.int32),
             "image_size": np.array([600, 800], np.int32), "padding": False} for i in ids]


def _run(evaluator, det_cls, to, arrays, out_dir):
    boxes, scores, classes, valid = arrays
    evaluator.reset()
    for lo in range(0, N_IMG, 3):  # batches of 3; the last is padded
        ids = list(range(lo, min(lo + 3, N_IMG)))
        metas = _metas(ids)
        while len(ids) < 3:
            ids.append(ids[-1])
            metas.append(dict(metas[-1], padding=True))
        sel = np.asarray(ids)
        dets = det_cls(to(boxes[sel]), to(scores[sel]), to(classes[sel]), to(valid[sel]),
                       to(np.zeros((3, D), np.int64)))
        evaluator.process_detections(dets, metas)
    res = evaluator.evaluate()
    with open(os.path.join(out_dir, "coco_instances_test_results.json")) as f:
        return res, json.load(f)


def _assert_results_equal(got, want):
    assert list(got) == list(want)
    for task in want:
        assert list(got[task]) == list(want[task])
        for k, v in want[task].items():
            assert (math.isnan(v) and math.isnan(got[task][k])) or got[task][k] == v, (task, k)


@pytest.mark.parametrize("split", ["all", "base", "novel"])
def test_coco_evaluator_equals_jax(gt_file, tmp_path, split):
    _, anns = gt_file
    name = f"evaltree_test_{split}"
    arrays = _detections(anns, split, seed=1)
    got, got_rows = _run(COCOEvaluator(name, get_cfg(), output_dir=str(tmp_path / "port")), Detections,
                         torch.from_numpy, arrays, str(tmp_path / "port"))
    want, want_rows = _run(JaxEvaluator(name, jax_get_cfg(), output_dir=str(tmp_path / "jax")),
                           lambda *f: JaxDetections(*f), np.asarray, arrays, str(tmp_path / "jax"))
    assert got_rows == want_rows and len(got_rows) > 20
    _assert_results_equal(got, want)
    keys = {"all": ("AP", "AP50", "bAP", "nAP"), "base": ("bAP", "AP"), "novel": ("nAP", "AP")}[split]
    assert all(k in got["bbox"] for k in keys) and got["bbox"]["AP"] > 0
    assert testing.flatten_results_dict(got) == jax_testing.flatten_results_dict(want)


def test_result_checks_equal_jax(gt_file, tmp_path, caplog):
    _, anns = gt_file
    got, _ = _run(COCOEvaluator("evaltree_test_all", get_cfg(), output_dir=str(tmp_path)), Detections,
                  torch.from_numpy, _detections(anns, "all", seed=2), str(tmp_path))
    ap50 = got["bbox"]["AP50"]
    for expected in ([["bbox", "AP50", ap50, 1.0]], [["bbox", "AP50", ap50 + 5.0, 1.0]]):
        cfgs = get_cfg(), jax_get_cfg()
        for cfg in cfgs:
            cfg.TEST.EXPECTED_RESULTS = expected
        assert testing.verify_results(cfgs[0], got) == jax_testing.verify_results(cfgs[1], got)
    assert testing.verify_results(cfgs[0], got) is False
    with caplog.at_level(logging.INFO):
        caplog.clear()
        testing.print_csv_format(got)
        port_lines = [r.getMessage() for r in caplog.records]
        caplog.clear()
        jax_testing.print_csv_format(got)
        assert port_lines == [r.getMessage() for r in caplog.records] and len(port_lines) == 3


def test_evaluator_takes_int32_classes(gt_file, tmp_path):
    """The result does not depend on the integer type of the classes."""
    _, anns = gt_file
    boxes, scores, classes, valid = _detections(anns, "all", seed=3)
    a, _ = _run(COCOEvaluator("evaltree_test_all", get_cfg(), output_dir=str(tmp_path / "a")), Detections,
                torch.from_numpy, (boxes, scores, classes, valid), str(tmp_path / "a"))
    b, _ = _run(COCOEvaluator("evaltree_test_all", get_cfg(), output_dir=str(tmp_path / "b")), Detections,
                torch.from_numpy, (boxes, scores, classes.astype(np.int32), valid), str(tmp_path / "b"))
    _assert_results_equal(a, b)
