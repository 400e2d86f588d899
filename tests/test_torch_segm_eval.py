"""The port's mask structures and segm evaluation against the JAX package on
the CPU.

- ``polygons_to_bitmask``, ``rle_to_bitmask`` (uncompressed counts and the
  COCO mask API's compressed string), ``bitmask_to_rle`` and
  ``paste_masks_np`` equal JAX's; the port's torch ``paste_masks_in_image``
  gives the same bits as ``paste_masks_np``.
- ``chip_smoke.write_segm_json``'s seeded tree (6 images of 480x640 over 3
  categories) whose ground truth mixes polygons (two-part ones too),
  uncompressed and compressed RLE and crowd regions; detections made from it (shifted, grown, shrunk and false
  masks, with their boxes): ``loadRes`` of segm rows equals JAX's (area and
  bbox from the mask), and segm ``COCOeval`` (the python and the native
  matcher) gives JAX's ``stats`` and IoUs within 1e-9.
- ``COCOEvaluator`` on the same tree, fed padded ``Detections`` with masks
  (the port's as torch tensors, JAX's as numpy): the result rows (RLE
  ``segmentation`` included) and the ``bbox`` and ``segm`` results equal
  JAX's within 1e-9.
"""
import copy

import numpy as np
import pytest
import torch

import chip_smoke
from lvc_tpu.data import catalog as jax_catalog
from lvc_tpu.data.coco_api import COCO as JaxCOCO
from lvc_tpu.evaluation import coco_eval as jax_coco_eval
from lvc_tpu.evaluation.coco_evaluation import COCOEvaluator as JaxEvaluator
from lvc_tpu.evaluation.fast_eval_api import COCOeval_opt as JaxCOCOevalOpt
from lvc_tpu.modeling.roi_heads.fast_rcnn import Detections as JaxDetections
from lvc_tpu.structures import masks as jmasks

from lvc_tpu_torch.data import catalog as port_catalog
from lvc_tpu_torch.data.coco_api import COCO
from lvc_tpu_torch.evaluation import coco_eval
from lvc_tpu_torch.evaluation.coco_evaluation import COCOEvaluator
from lvc_tpu_torch.evaluation.fast_eval_api import COCOeval_opt
from lvc_tpu_torch.modeling.roi_heads.fast_rcnn import Detections
from lvc_tpu_torch.modeling.roi_heads.mask_head import paste_masks_in_image
from lvc_tpu_torch.structures import masks

N_IMG, HW, CATS = 6, (480, 640), (1, 2, 3)
NAME = "segmtree_test"


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """``chip_smoke.write_segm_json``'s tree (phase 35's): (json path,
    dataset dict, the gt bitmasks by annotation id)."""
    path = str(tmp_path_factory.mktemp("segmtree") / "gt.json")
    dataset, bits = chip_smoke.write_segm_json(path, n_img=N_IMG, hw=HW)
    return path, dataset, bits


def _shift(m, dy, dx):
    return np.roll(np.roll(m, dy, 0), dx, 1)


def _result_rows(dataset, bits, seed=1):
    """Segm result rows made from the gt: exact, shifted, grown, shrunk and
    false masks, with each mask's tight box."""
    rng = np.random.RandomState(seed)
    h, w = HW
    rows = []
    for ann in dataset["annotations"]:
        m = bits[ann["id"]]
        for kind in rng.choice(["exact", "shift", "grow", "shrink", "miss"], 2):
            if kind == "shift":
                m2 = _shift(m, *rng.randint(-4, 5, 2))
            elif kind == "grow":
                m2 = m | _shift(m, 2, 2) | _shift(m, -2, -2)
            elif kind == "shrink":
                m2 = m & _shift(m, 2, 2) & _shift(m, -2, -2)
            elif kind == "miss":
                m2 = _shift(m, h // 2, w // 2)
            else:
                m2 = m
            ys, xs = np.nonzero(m2)
            bbox = [float(xs.min()), float(ys.min()), float(xs.max() + 1 - xs.min()), float(ys.max() + 1 - ys.min())] \
                if len(xs) else [0.0, 0.0, 0.0, 0.0]
            rows.append({"image_id": ann["image_id"], "category_id": int(rng.choice(CATS)) if kind == "miss"
                         else ann["category_id"], "score": float(rng.uniform(0.05, 1.0)), "bbox": bbox,
                         "segmentation": jmasks.bitmask_to_rle(m2)})
    return rows


# -------------------------------------------------------------- structures
def test_polygons_and_rle_equal_jax(tree):
    _, dataset, bits = tree
    h, w = HW
    for ann in dataset["annotations"]:
        seg = ann["segmentation"]
        if isinstance(seg, dict):
            got, want = masks.rle_to_bitmask(seg), jmasks.rle_to_bitmask(seg)
            assert masks._rle_counts(seg) == jmasks._rle_counts(seg)
        else:
            got, want = masks.polygons_to_bitmask(seg, h, w), jmasks.polygons_to_bitmask(seg, h, w)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, bits[ann["id"]])
        assert masks.bitmask_to_rle(got) == jmasks.bitmask_to_rle(got)
        back = masks.bitmask_to_rle(got)
        np.testing.assert_array_equal(masks.rle_to_bitmask(back), got)
        np.testing.assert_array_equal(masks.rle_to_bitmask(dict(back, counts=chip_smoke.rle_string(back["counts"]))), got)
    kinds = {type(a["segmentation"]).__name__ + str(a["iscrowd"]) for a in dataset["annotations"]}
    assert {"list0", "dict0", "dict1"} <= kinds
    assert any(isinstance(a["segmentation"], dict) and isinstance(a["segmentation"]["counts"], str)
               for a in dataset["annotations"])
    full = np.ones((3, 4), bool)  # a mask starting with foreground: a leading 0 run
    assert masks.bitmask_to_rle(full) == jmasks.bitmask_to_rle(full) == {"size": [3, 4], "counts": [0, 12]}


def test_paste_masks_equal_jax_and_torch():
    rng = np.random.RandomState(2)
    hw = (60, 80)
    probs = rng.rand(9, 28, 28).astype(np.float32)
    xy = rng.uniform(-10, 70, (9, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(0.5, 50, (9, 2))], -1).astype(np.float32)
    boxes[0] = [5.0, 5.0, 5.0, 20.0]  # zero width
    boxes[1] = [0.0, 0.0, 80.0, 60.0]  # the whole image
    for threshold in (0.5, -1.0):
        got = masks.paste_masks_np(probs, boxes, hw, threshold)
        np.testing.assert_array_equal(got, jmasks.paste_masks_np(probs, boxes, hw, threshold))
    bits = masks.paste_masks_np(probs, boxes, hw)
    assert bits.any(axis=(1, 2)).sum() >= 5
    torch_bits = paste_masks_in_image(torch.from_numpy(probs), torch.from_numpy(boxes), hw).numpy()
    np.testing.assert_array_equal(torch_bits, bits)


# --------------------------------------------------------------- COCOeval
@pytest.mark.parametrize("opt", [False, True])
@pytest.mark.parametrize("pop_bbox", [True, False])
def test_segm_cocoeval_equals_jax(tree, opt, pop_bbox):
    _, dataset, bits = tree
    rows = _result_rows(dataset, bits)
    if pop_bbox:  # the evaluator's form: area and bbox from the mask
        for r in rows:
            r.pop("bbox")
    out = {}
    for key, api, ev in (("port", COCO, COCOeval_opt if opt else coco_eval.COCOeval),
                         ("jax", JaxCOCO, JaxCOCOevalOpt if opt else jax_coco_eval.COCOeval)):
        gt = api(copy.deepcopy(dataset))
        dt = gt.loadRes(copy.deepcopy(rows))
        e = ev(gt, dt, iouType="segm")
        e.evaluate()
        e.accumulate()
        e.summarize()
        out[key] = (dt.dataset["annotations"], e.stats, e.ious)
    (p_anns, p_stats, p_ious), (j_anns, j_stats, j_ious) = out["port"], out["jax"]
    assert p_anns == j_anns
    np.testing.assert_allclose(p_stats, j_stats, rtol=0, atol=1e-9)
    assert set(p_ious) == set(j_ious)
    for k, v in j_ious.items():
        np.testing.assert_allclose(np.asarray(p_ious[k]), np.asarray(v), rtol=0, atol=1e-9)
    assert 0.2 < p_stats[0] < 0.95 and p_stats[1] > p_stats[2]


# ---------------------------------------------------------- COCOEvaluator
def _detections(dataset, seed=4, D=12, M=28):
    """Padded detections an image: boxes near the gt (and false ones), with
    probability masks; the last slots invalid."""
    rng = np.random.RandomState(seed)
    B = N_IMG
    boxes = np.zeros((B, D, 4), np.float32)
    for i in range(B):
        anns = [a for a in dataset["annotations"] if a["image_id"] == i + 1]
        for j in range(D):
            if j < len(anns):
                x, y, w, h = anns[j]["bbox"]
                boxes[i, j] = [x, y, x + w, y + h] + rng.normal(0, 1.0, 4)
            else:
                xy = rng.uniform(0, 50, 2)
                boxes[i, j] = np.concatenate([xy, xy + rng.uniform(5, 25, 2)])
    yy, xx = np.mgrid[0:M, 0:M] + 0.5
    blob = np.exp(-(((yy - M / 2) / (M / 3)) ** 2 + ((xx - M / 2) / (M / 3)) ** 2))
    probs = np.clip(blob[None, None] + rng.normal(0, 0.15, (B, D, M, M)), 0, 1).astype(np.float32)
    valid = np.arange(D)[None, :] < rng.randint(D - 4, D + 1, (B, 1))
    cat_idx = {c: i for i, c in enumerate(CATS)}
    classes = np.zeros((B, D), np.int64)
    for i in range(B):
        anns = [a for a in dataset["annotations"] if a["image_id"] == i + 1]
        for j in range(D):
            classes[i, j] = cat_idx[anns[j]["category_id"]] if j < len(anns) else rng.randint(0, len(CATS))
    scores = rng.uniform(0.05, 1.0, (B, D)).astype(np.float32)
    prop = np.zeros((B, D), np.int64)
    return boxes, scores, classes, valid, prop, probs


def test_coco_evaluator_segm_equals_jax(tree):
    path, dataset, _ = tree
    for catalog in (port_catalog.MetadataCatalog, jax_catalog.MetadataCatalog):
        catalog.get(NAME).set(json_file=path, thing_classes=[f"c{c}" for c in CATS],
                              thing_dataset_id_to_contiguous_id={c: i for i, c in enumerate(CATS)})
    boxes, scores, classes, valid, prop, probs = _detections(dataset)
    # a 1.25x canvas: the rows are rescaled to the original size
    metas = [{"image_id": i + 1, "image_size": (600, 800), "orig_size": HW} for i in range(N_IMG)]
    scaled = boxes * 1.25
    port, jax_ev = COCOEvaluator(NAME), JaxEvaluator(NAME)
    for lo in range(0, N_IMG, 4):
        sl = slice(lo, lo + 4)
        dets = Detections(*(torch.from_numpy(x[sl]) for x in (scaled, scores, classes, valid, prop)),
                          masks=torch.from_numpy(probs[sl]))
        port.process_detections(dets, metas[sl])
        jax_ev.process_detections(JaxDetections(*(x[sl] for x in (scaled, scores, classes, valid, prop)),
                                                masks=probs[sl]), metas[sl])
    assert port._predictions == jax_ev._predictions
    assert len(port._predictions) == int(valid.sum())
    assert all("segmentation" in r for r in port._predictions)
    got, want = port.evaluate(), jax_ev.evaluate()
    assert list(got) == list(want) == ["bbox", "segm"]
    for task in want:
        assert set(got[task]) == set(want[task])
        for k, v in want[task].items():
            if np.isnan(v):
                assert np.isnan(got[task][k]), (task, k)
            else:
                assert got[task][k] == pytest.approx(v, abs=1e-9), (task, k)
    assert got["segm"]["AP"] > 0 and got["segm"]["AP"] != got["bbox"]["AP"]
