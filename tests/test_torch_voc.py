"""The PASCAL VOC data and evaluation against the JAX package on the CPU.

A seeded VOC tree (``chip_smoke.write_voc_tree``: VOC2007 trainval/test,
VOC2012 trainval with underscore ids, 1-shot lists under ``vocsplit`` and
``vocsplit/seed3``, some objects ``<difficult>1</difficult>``) is written
once for the module.

- Records: the fixed splits through ``load_filtered_voc_instances`` (base,
  novel and all classes) and the few-shot names through the registered
  catalogs, from the tree's directory as the working directory (the lists
  are read relative to it, as in JAX), with ``np.random.seed`` before each
  call (the shot subsample draws from numpy's global state): equal records.
  Difficult objects load as ordinary boxes in both packages.
- ``voc_ap`` and ``voc_eval_class`` on seeded curves and detections, with
  the 11-point (2007) and area rules: equal to 1e-12.
- ``PascalVOCDetectionEvaluator.evaluate`` on the same seeded detections
  (2007 and 2012 splits): every key within abs 1e-9.
- Its merge over 2 gloo ranks, each fed its contiguous shard: equal to one
  process fed all images.
"""
import os

import numpy as np
import pytest
import torch

import chip_smoke
from lvc_tpu.data import builtin as jax_builtin  # noqa: F401  (registers the VOC names)
from lvc_tpu.data import meta_pascal_voc as jvoc
from lvc_tpu.data.builtin_meta import _get_builtin_metadata as jax_meta
from lvc_tpu.data.catalog import DatasetCatalog as JaxDatasetCatalog
from lvc_tpu.evaluation import pascal_voc_evaluation as jeval
from lvc_tpu.modeling.roi_heads.fast_rcnn import Detections as JaxDetections

from lvc_tpu_torch.data import builtin  # noqa: F401
from lvc_tpu_torch.data import meta_pascal_voc as tvoc
from lvc_tpu_torch.data.builtin_meta import _get_builtin_metadata
from lvc_tpu_torch.data.catalog import DatasetCatalog, MetadataCatalog
from lvc_tpu_torch.data.samplers import InferenceSampler
from lvc_tpu_torch.engine.launch import launch
from lvc_tpu_torch.evaluation import pascal_voc_evaluation as teval
from lvc_tpu_torch.modeling.roi_heads.fast_rcnn import Detections
from lvc_tpu_torch.utils import comm

PROBES = {  # evaluator probes: name -> (VOC directory, split, year)
    "vocprobe_2007_test_all1": ("VOC2007", "test", 2007),
    "vocprobe_2012_trainval_all1": ("VOC2012", "trainval", 2012),
}


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("voc"))
    chip_smoke.write_voc_tree(os.path.join(root, "datasets"), 24, 10, 8, sizes=((75, 100), (100, 75)),
                              shot_seeds=(3,))
    return root


def _register(root, register, catalog, meta):
    for name, (dirname, split, year) in PROBES.items():
        if name in catalog:
            catalog.remove(name)
        register(name, meta, os.path.join(root, "datasets", dirname), split, year, "base_novel_1", 1)


@pytest.mark.parametrize("dirname,split,keep", [("VOC2007", "trainval", "base"), ("VOC2007", "test", "novel"),
                                                ("VOC2012", "trainval", "all")])
def test_fixed_splits_load_as_jax(tree, dirname, split, keep):
    meta = _get_builtin_metadata("pascal_voc_fewshot")
    classes = {"base": meta["base_classes"], "novel": meta["novel_classes"], "all": meta["thing_classes"]}[keep][1]
    path = os.path.join(tree, "datasets", dirname)
    got = tvoc.load_filtered_voc_instances(f"voc_{split}", path, split, classes)
    want = jvoc.load_filtered_voc_instances(f"voc_{split}", path, split, classes)
    assert got == want and len(got) >= 8
    assert all(isinstance(d["image_id"], str) for d in got)
    if dirname == "VOC2012":
        assert all("_" in d["image_id"] for d in got)
    # difficult objects are ordinary boxes: every object of a kept class loads
    import xml.etree.ElementTree as ET

    n_objects = n_difficult = 0
    for d in got:
        objs = [o for o in ET.parse(os.path.join(path, "Annotations", d["image_id"] + ".xml")).findall("object")
                if o.find("name").text in classes]
        n_objects += len(objs)
        n_difficult += sum(o.find("difficult").text == "1" for o in objs)
        assert all("difficult" not in a for a in d["annotations"])
    assert n_objects == sum(len(d["annotations"]) for d in got)
    assert n_difficult > 0 or keep != "all"
    # VOC's 1-indexed pixels: xmin and ymin shift by one, xmax and ymax do not
    a = next(a for d in got for a in d["annotations"])
    assert a["bbox"][0] == int(a["bbox"][0]) and a["bbox_mode"] == 0


@pytest.mark.parametrize("name", ["voc_2007_trainval_all1_1shot", "voc_2007_trainval_novel2_1shot",
                                  "voc_2012_trainval_all3_1shot_seed3", "voc_2007_trainval_novel1_1shot_seed3"])
def test_few_shot_names_load_as_jax(tree, name, monkeypatch):
    monkeypatch.chdir(tree)
    np.random.seed(5)
    got = DatasetCatalog.get(name)
    np.random.seed(5)
    want = JaxDatasetCatalog.get(name)
    assert got == want and len(got) >= 5
    assert all(len(d["annotations"]) == 1 for d in got)
    years = {d["file_name"].split(os.sep)[1] for d in got}
    assert years <= {"VOC2007", "VOC2012"}


def test_voc_ap_matches_jax():
    rng = np.random.RandomState(0)
    for _ in range(20):
        n = rng.randint(1, 40)
        rec = np.sort(rng.rand(n))
        prec = rng.rand(n)
        for use_07 in (True, False):
            assert teval.voc_ap(rec, prec, use_07) == pytest.approx(jeval.voc_ap(rec, prec, use_07), abs=1e-12)


def _gt_and_dets(seed, n_images=6):
    rng = np.random.RandomState(seed)
    gt, dets = {}, []
    for i in range(n_images):
        n = rng.randint(0, 5)
        xy = rng.rand(n, 2) * 80
        boxes = np.concatenate([xy, xy + 10 + rng.rand(n, 2) * 40], 1)
        gt[f"{i:06d}"] = {"boxes": boxes, "difficult": rng.rand(n) < 0.3}
        for b in boxes:
            for _ in range(rng.randint(0, 3)):
                dets.append({"image_id": f"{i:06d}", "bbox": list(b + rng.randn(4) * 4), "score": float(rng.rand())})
        for _ in range(rng.randint(0, 3)):
            xy = rng.rand(2) * 80
            dets.append({"image_id": f"{i:06d}", "bbox": list(np.r_[xy, xy + 20]), "score": float(rng.rand())})
    return gt, dets


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_voc_eval_class_matches_jax(seed):
    gt, dets = _gt_and_dets(seed)
    for thresh in (0.5, 0.75):
        for use_07 in (True, False):
            want = jeval.voc_eval_class(dets, gt, thresh, use_07)
            assert teval.voc_eval_class(dets, gt, thresh, use_07) == pytest.approx(want, abs=1e-12)
    assert jeval.voc_eval_class(dets, gt, 0.5, True) > 0


def _detections(records, seed):
    """Per image (in ``records`` order): the meta and its seeded detections
    (jittered gt boxes of the right class, a few wrong ones), in a canvas
    scaled by 0.8 from the original image."""
    rng = np.random.RandomState(seed)
    out = []
    for d in records:
        h, w = d["height"], d["width"]
        meta = {"image_id": d["image_id"], "orig_size": np.array([h, w]),
                "image_size": np.array([round(h * 0.8), round(w * 0.8)]), "padding": False}
        rows = [(np.asarray(a["bbox"]) + rng.randn(4) * 2, a["category_id"]) for a in d["annotations"]]
        rows += [(np.r_[xy, xy + 15], rng.randint(20)) for xy in rng.rand(2, 2) * 50]
        D = 8
        boxes = np.zeros((1, D, 4), np.float32)
        scores = np.zeros((1, D), np.float32)
        classes = np.zeros((1, D), np.int64)
        valid = np.zeros((1, D), bool)
        for j, (b, c) in enumerate(rows[:D]):
            boxes[0, j] = b * 0.8
            scores[0, j] = rng.rand()
            classes[0, j] = c
            valid[0, j] = True
        out.append((meta, boxes, scores, classes, valid))
    return out


def _port_eval(name, items):
    ev = teval.PascalVOCDetectionEvaluator(name)
    ev.reset()
    for meta, boxes, scores, classes, valid in items:
        ev.process_detections(Detections(*[torch.from_numpy(x) for x in (boxes, scores, classes, valid)],
                                         torch.zeros(classes.shape, dtype=torch.long)), [meta])
    return ev.evaluate()


@pytest.mark.parametrize("name", list(PROBES))
def test_evaluator_matches_jax(tree, name):
    from lvc_tpu.data.catalog import DatasetCatalog as JDC

    _register(tree, tvoc.register_meta_pascal_voc, DatasetCatalog, _get_builtin_metadata("pascal_voc_fewshot"))
    _register(tree, jvoc.register_meta_pascal_voc, JDC, jax_meta("pascal_voc_fewshot"))
    items = _detections(DatasetCatalog.get(name), seed=4)
    got = _port_eval(name, items)
    ev = jeval.PascalVOCDetectionEvaluator(name)
    for meta, *fields in items:
        ev.process_detections(JaxDetections(*fields, np.zeros(fields[2].shape, np.int32)), [meta])
    want = ev.evaluate()
    assert list(got["bbox"]) == list(want["bbox"])
    for k, v in want["bbox"].items():
        assert got["bbox"][k] == pytest.approx(v, abs=1e-9, nan_ok=True), k
    assert {"AP", "AP50", "AP75", "bAP50", "nAP50", "AP50-bird"} <= set(got["bbox"]) and want["bbox"]["AP50"] > 20


def _rank_main(root, out):
    _register(root, tvoc.register_meta_pascal_voc, DatasetCatalog, _get_builtin_metadata("pascal_voc_fewshot"))
    name = "vocprobe_2007_test_all1"
    items = _detections(DatasetCatalog.get(name), seed=4)
    shard = [items[i] for i in InferenceSampler(len(items), comm.get_rank(), comm.get_world_size())]
    torch.save(_port_eval(name, shard), os.path.join(out, f"voc_rank{comm.get_rank()}.pt"))


def test_evaluator_merge_equals_one_process(tree, tmp_path):
    launch(_rank_main, 2, args=(tree, str(tmp_path)), devices=["cpu", "cpu"])
    r0, r1 = (torch.load(os.path.join(tmp_path, f"voc_rank{r}.pt"), weights_only=False) for r in range(2))
    _register(tree, tvoc.register_meta_pascal_voc, DatasetCatalog, _get_builtin_metadata("pascal_voc_fewshot"))
    name = "vocprobe_2007_test_all1"
    want = _port_eval(name, _detections(DatasetCatalog.get(name), seed=4))
    assert r0 == want and r1 == {} and MetadataCatalog.get(name).year == 2007
