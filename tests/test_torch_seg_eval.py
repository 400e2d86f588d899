"""The semantic, panoptic and Cityscapes evaluators and the Cityscapes loaders
against the JAX package on the CPU.

- ``SemSegEvaluator`` on seeded label maps and (H, W, C) logits with ignore
  pixels and out-of-range predictions, over several images: every stat
  within abs 1e-9 of JAX's (NaN where JAX has NaN).
- ``pq_single_image`` and ``COCOPanopticEvaluator`` on seeded segment maps
  with crowd segments, void pixels and unmatched predictions: the per-category
  counts equal and PQ/SQ/RQ (all, things, stuff) within abs 1e-9.
- A seeded Cityscapes tree (``chip_smoke.write_cityscapes_tree``: polygon
  JSONs with crowds, stuff and a degenerate object, labelIds PNGs):
  ``load_cityscapes_instances``/``load_cityscapes_semantic`` and the
  registered names give JAX's dataset dicts; ``CityscapesInstanceEvaluator``
  on oracle and 3-px-shifted boxes (``chip_smoke.cityscapes_oracle``) and
  ``CityscapesSemSegEvaluator`` on the labelIds maps and perturbed copies give
  JAX's numbers within abs 1e-9 (the oracle: AP and mIoU 100).
"""
import math
from collections import namedtuple

import numpy as np
import pytest
from PIL import Image

import chip_smoke
from lvc_tpu.data import catalog as jax_catalog
from lvc_tpu.data import cityscapes as jcity
from lvc_tpu.evaluation import cityscapes_evaluation as jcity_eval
from lvc_tpu.evaluation import panoptic_evaluation as jpan
from lvc_tpu.evaluation import sem_seg_evaluation as jsem
from lvc_tpu_torch.data import catalog as port_catalog
from lvc_tpu_torch.data import cityscapes as city
from lvc_tpu_torch.evaluation import cityscapes_evaluation as city_eval
from lvc_tpu_torch.evaluation import panoptic_evaluation as pan
from lvc_tpu_torch.evaluation import sem_seg_evaluation as sem

NumpyDets = namedtuple("NumpyDets", "boxes scores classes valid")


def _assert_stats(got, want):
    assert list(got) == list(want)
    for task in want:
        assert list(got[task]) == list(want[task])
        for k, v in want[task].items():
            if isinstance(v, str):
                assert got[task][k] == v
            elif math.isnan(v):
                assert math.isnan(got[task][k]), k
            else:
                assert abs(got[task][k] - v) <= 1e-9, (k, got[task][k], v)


def test_sem_seg_evaluator_matches_jax():
    rng = np.random.RandomState(0)
    C = 6
    evs = [sem.SemSegEvaluator("probe", num_classes=C, class_names=[f"c{i}" for i in range(C)]),
           jsem.SemSegEvaluator("probe", num_classes=C, class_names=[f"c{i}" for i in range(C)])]
    for i in range(4):
        gt = rng.randint(0, C - 1, (24, 32))  # class C - 1 never in the gt: its IoU has no gt pixels
        gt[rng.rand(24, 32) < 0.1] = 255
        if i % 2:
            pred = rng.normal(0, 1, (24, 32, C)).astype(np.float32)  # logits
        else:
            pred = np.where(rng.rand(24, 32) < 0.7, gt, rng.randint(0, C + 2, (24, 32)))  # out-of-range folds
            pred = np.where(pred == 255, 0, pred)
        for ev in evs:
            ev.process(pred, gt)
    got, want = evs[0].evaluate(), evs[1].evaluate()
    _assert_stats(got, want)
    assert 0 < got["sem_seg"]["mIoU"] < 100


def _panoptic_image(rng, H=40, W=48, things=(1, 2), stuff=(10, 11)):
    """A gt and a predicted segment map with infos: gt things, one crowd, a
    stuff region and void; the prediction moves and drops segments and adds
    one of its own."""
    gt = np.zeros((H, W), np.int64)
    gt[:, :] = 1  # stuff id 1
    segs_gt = [{"id": 1, "category_id": int(rng.choice(stuff))}]
    pred = np.zeros((H, W), np.int64)
    pred[:, :] = 7
    segs_pred = [{"id": 7, "category_id": segs_gt[0]["category_id"]}]
    for j in range(rng.randint(3, 6)):
        h, w = rng.randint(4, 16, 2)
        y, x = rng.randint(0, H - h), rng.randint(0, W - w)
        sid = 2 + j
        gt[y:y + h, x:x + w] = sid
        cat = int(rng.choice(things))
        segs_gt.append({"id": sid, "category_id": cat, "iscrowd": int(j == 2)})
        if j != 1:
            dy, dx = rng.randint(-2, 3, 2)
            pred[max(y + dy, 0):y + h + dy, max(x + dx, 0):x + w + dx] = 20 + j
            segs_pred.append({"id": 20 + j, "category_id": cat})
    gt[rng.rand(H, W) < 0.05] = 0  # void
    pred[:5, :5] = 40
    segs_pred.append({"id": 40, "category_id": int(things[0])})
    return gt, segs_gt, pred, segs_pred


def test_panoptic_quality_matches_jax():
    rng = np.random.RandomState(1)
    evs = [pan.COCOPanopticEvaluator((1, 2), (10, 11)), jpan.COCOPanopticEvaluator((1, 2), (10, 11))]
    for _ in range(5):
        case = _panoptic_image(rng)
        got, want = pan.pq_single_image(*case), jpan.pq_single_image(*case)
        assert {k: dict(v) for k, v in got.items()} == {k: dict(v) for k, v in want.items()}
        for ev in evs:
            ev.process(*case)
    got, want = evs[0].evaluate(), evs[1].evaluate()
    _assert_stats(got, want)
    assert 0 < got["panoptic_seg"]["PQ_th"] < 100 and got["panoptic_seg"]["PQ_st"] > 0
    # a segmentation against itself: PQ 100
    ev = pan.COCOPanopticEvaluator((1, 2), (10, 11))
    gt, segs, _, _ = _panoptic_image(rng)
    ev.process(gt, segs, gt, [s for s in segs if not s.get("iscrowd")])
    assert ev.evaluate()["panoptic_seg"]["PQ"] == 100.0


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cityscapes"))
    chip_smoke.write_cityscapes_tree(root, per_city=2)
    return root


def test_cityscapes_loaders_match_jax(tree):
    image_dir, gt_dir = f"{tree}/leftImg8bit/val", f"{tree}/gtFine/val"
    got = city.load_cityscapes_instances(image_dir, gt_dir)
    assert got == jcity.load_cityscapes_instances(image_dir, gt_dir)
    assert city.load_cityscapes_semantic(image_dir, gt_dir) == jcity.load_cityscapes_semantic(image_dir, gt_dir)
    assert city.get_cityscapes_files(image_dir, gt_dir) == jcity.get_cityscapes_files(image_dir, gt_dir)
    assert len(got) == 4 and all(a["category_id"] < 8 for d in got for a in d["annotations"])
    assert any(a["iscrowd"] for d in got for a in d["annotations"])
    names = city.register_cityscapes(tree, "val")
    assert names == jcity.register_cityscapes(tree, "val")
    for name in names:
        assert port_catalog.DatasetCatalog.get(name) == jax_catalog.DatasetCatalog.get(name)
        meta, jmeta = port_catalog.MetadataCatalog.get(name), jax_catalog.MetadataCatalog.get(name)
        assert meta.evaluator_type == jmeta.evaluator_type and meta.gt_dir == jmeta.gt_dir


def test_cityscapes_evaluators_match_jax(tree):
    dicts = city.load_cityscapes_instances(f"{tree}/leftImg8bit/val", f"{tree}/gtFine/val")
    aps = []
    for shift in (0.0, 3.0):
        evs = [city_eval.CityscapesInstanceEvaluator("probe"), jcity_eval.CityscapesInstanceEvaluator("probe")]
        for image_id, hw, boxes, classes, dets in chip_smoke.cityscapes_oracle(dicts, "cpu", shift):
            np_dets = NumpyDets(*(t.numpy() for t in dets[:4]))
            for ev in evs:
                ev.process_image(image_id, hw, boxes, classes, np_dets)
        got, want = evs[0].evaluate(), evs[1].evaluate()
        _assert_stats(got, want)
        aps.append(got["bbox"]["AP"])
    assert aps[0] == pytest.approx(100.0) and 0 < aps[1] < 100
    rng = np.random.RandomState(2)
    evs = [city_eval.CityscapesSemSegEvaluator("probe"), jcity_eval.CityscapesSemSegEvaluator("probe")]
    oracle = city_eval.CityscapesSemSegEvaluator("probe")
    for d in city.load_cityscapes_semantic(f"{tree}/leftImg8bit/val", f"{tree}/gtFine/val"):
        gt = np.asarray(Image.open(d["sem_seg_file_name"]), np.int64)
        pred = np.where(rng.rand(*gt.shape) < 0.8, gt, rng.randint(0, 19, gt.shape))
        pred = np.where(pred == 255, 0, pred)
        for ev in evs:
            ev.process(pred, gt)
        oracle.process(np.where(gt == 255, 0, gt), gt)
    _assert_stats(evs[0].evaluate(), evs[1].evaluate())
    assert oracle.evaluate()["sem_seg"]["mIoU"] == pytest.approx(100.0)
