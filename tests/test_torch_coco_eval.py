"""The port's COCOeval and COCOeval_opt against the JAX package's on the CPU.

Seeded ground truth over 3 categories on 12 images (two with no boxes at all,
some crowd boxes, box sizes spanning the small, medium and large ranges)
and seeded detections (jittered copies of the boxes, false positives, one
image with detections and no ground truth). Tolerance: none. The stats, the
precision and recall arrays (float64) and every per-image match equal
JAX's exactly. The port's native matching equals its python matching in
the stats, those arrays and every detection's match; its ground-truth
entries differ in form, as in the JAX package (the python path orders them
ignored-last and ``gtMatches`` holds detection ids, the native path keeps
the input order and detection positions + 1), and ``accumulate`` reads
none of them.
"""
import numpy as np
import pytest

from lvc_tpu.data.coco_api import COCO as JaxCOCO
from lvc_tpu.evaluation.coco_eval import COCOeval as JaxCOCOeval
from lvc_tpu.evaluation.coco_eval import bbox_iou_xywh as jax_bbox_iou
from lvc_tpu.evaluation.fast_eval_api import COCOeval_opt as JaxCOCOeval_opt
from lvc_tpu_torch.data.coco_api import COCO
from lvc_tpu_torch.evaluation import fast_eval_api
from lvc_tpu_torch.evaluation.coco_eval import COCOeval, Params, bbox_iou_xywh
from lvc_tpu_torch.evaluation.fast_eval_api import COCOeval_opt

N_IMG, N_CAT = 12, 3


def _data(seed):
    rng = np.random.RandomState(seed)
    images = [{"id": i + 1, "height": 480, "width": 640} for i in range(N_IMG)]
    cats = [{"id": c * 2 + 1, "name": f"c{c}"} for c in range(N_CAT)]
    anns, dets = [], []
    for img in images[:-2]:  # the last two images have no ground truth
        for _ in range(rng.randint(1, 7)):
            side = float(np.exp(rng.uniform(np.log(8), np.log(300))))  # small to large
            w, h = side * rng.uniform(0.6, 1.4), side * rng.uniform(0.6, 1.4)
            x, y = rng.uniform(0, 640 - w), rng.uniform(0, 480 - h)
            cat = cats[rng.randint(N_CAT)]["id"]
            crowd = int(rng.rand() < 0.15)
            anns.append({"id": len(anns) + 1, "image_id": img["id"], "category_id": cat,
                         "bbox": [x, y, w, h], "area": w * h, "iscrowd": crowd})
            for _ in range(rng.randint(0, 3)):  # jittered detections of it
                j = rng.normal(0, 0.15 * side, 4)
                dets.append({"image_id": img["id"], "category_id": cat,
                             "bbox": [x + j[0], y + j[1], max(w + j[2], 1.0), max(h + j[3], 1.0)],
                             "score": float(rng.rand())})
        for _ in range(rng.randint(0, 4)):  # false positives
            dets.append({"image_id": img["id"], "category_id": cats[rng.randint(N_CAT)]["id"],
                         "bbox": list(rng.uniform([0, 0, 4, 4], [500, 400, 120, 120])),
                         "score": float(rng.rand())})
    dets.append({"image_id": images[-1]["id"], "category_id": 1, "bbox": [5.0, 5.0, 40.0, 30.0],
                 "score": 0.7})
    return {"images": images, "annotations": anns, "categories": cats}, dets


def _run(coco_cls, eval_cls, gt, dets, cat_ids=None):
    gt_api = coco_cls(gt)
    ev = eval_cls(gt_api, gt_api.loadRes(dets), "bbox")
    if cat_ids is not None:
        ev.params.catIds = list(cat_ids)
    ev.evaluate()
    ev.accumulate()
    ev.summarize()
    return ev


MATCH_KEYS = ("dtIds", "gtIds", "dtMatches", "gtMatches", "dtScores", "gtIgnore", "dtIgnore")


def _assert_same(got, want, keys=MATCH_KEYS):
    np.testing.assert_array_equal(got.stats, want.stats)
    for k in ("precision", "recall", "scores"):
        np.testing.assert_array_equal(got.eval[k], want.eval[k], err_msg=k)
    assert got.evalImgs.keys() == want.evalImgs.keys()
    for key, w in want.evalImgs.items():
        g = got.evalImgs[key]
        assert (g is None) == (w is None), key
        if w is not None:
            for k in keys:
                np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]), err_msg=f"{key} {k}")


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("opt", [False, True], ids=["python", "native"])
def test_cocoeval_equals_jax(seed, opt):
    gt, dets = _data(seed)
    port_cls, jax_cls = (COCOeval_opt, JaxCOCOeval_opt) if opt else (COCOeval, JaxCOCOeval)
    got = _run(COCO, port_cls, gt, dets)
    want = _run(JaxCOCO, jax_cls, gt, dets)
    _assert_same(got, want)
    assert got.stats[0] > 0 and (got.stats[3:6] >= 0).sum() >= 2  # AP, and the area ranges hold boxes


def test_cocoeval_on_a_category_subset_equals_jax():
    gt, dets = _data(4)
    _assert_same(_run(COCO, COCOeval_opt, gt, dets, [1, 5]), _run(JaxCOCO, JaxCOCOeval_opt, gt, dets, [1, 5]))


@pytest.mark.parametrize("seed", [0, 3])
def test_native_matching_equals_python(seed):
    assert fast_eval_api._load_lib() is not None, "the native COCOeval library did not build"
    gt, dets = _data(seed)
    _assert_same(_run(COCO, COCOeval_opt, gt, dets), _run(COCO, COCOeval, gt, dets),
                 ("dtIds", "dtMatches", "dtScores", "dtIgnore"))


def test_empty_detections_and_iou_equal_jax():
    gt, _ = _data(5)
    got = _run(COCO, COCOeval, gt, [])
    want = _run(JaxCOCO, JaxCOCOeval, gt, [])
    np.testing.assert_array_equal(got.stats, want.stats)
    rng = np.random.RandomState(0)
    d, g = rng.uniform(1, 50, (7, 4)), rng.uniform(1, 50, (5, 4))
    crowd = np.array([0, 1, 0, 0, 1], bool)
    np.testing.assert_array_equal(bbox_iou_xywh(d, g, crowd), jax_bbox_iou(d, g, crowd))


def test_segm_raises_naming_the_roadmap_item():
    """The segm IoU type is ported (it raised until then, naming its ROADMAP
    item): ``Params("segm")`` equals JAX's, and a COCOeval of that type
    takes it."""
    from lvc_tpu.evaluation.coco_eval import Params as JaxParams

    got, want = Params("segm"), JaxParams("segm")
    assert set(vars(got)) == set(vars(want))
    for k, v in vars(want).items():
        np.testing.assert_array_equal(np.asarray(getattr(got, k)), np.asarray(v))
    assert COCOeval(iouType="segm").params.iouType == "segm"
    with pytest.raises(AssertionError):
        Params("keypoints")  # no OKS type, as in JAX
