"""The rotated family against the JAX package on the CPU: rotated boxes,
``Box2BoxTransformRotated``, rotated NMS, ``roi_align_rotated``,
``RROIHeads`` and the rotated COCO evaluation, on the same inputs made from a
numpy seed and the same weights (``from_flax``).

Tolerances: the box functions and IoUs abs 1e-5 (areas and IoUs of boxes a
few tens of px, float32); deltas abs 1e-5 and applied boxes abs 1e-4 px;
NMS keep masks equal, on sets where no IoU lies within 1e-4 of the
threshold; the rotated pool abs 1e-5 of the largest value and its feature
gradient rel L2 1e-4; a narrow ``RROIHeads`` (p2-p5 of a B=2 128x160 canvas,
16 channels, FC 32, 6 classes, exhaustive sampling) losses rel 1e-5,
gradients of the features and every parameter rel L2 1e-4, detections equal
in validity, class and proposal, boxes abs 1e-3 px and scores abs 1e-4;
``RotatedCOCOeval``'s stats abs 1e-9, and the evaluator's result dict equal.
"""
import functools
import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from lvc_tpu.data import catalog as jax_catalog
from lvc_tpu.data.builtin_meta import _get_builtin_metadata as jax_meta
from lvc_tpu.data.coco_api import COCO as JaxCOCO
from lvc_tpu.data.meta_coco import register_meta_coco as jax_register
from lvc_tpu.evaluation import rotated_coco_evaluation as jrce
from lvc_tpu.modeling.box_regression import Box2BoxTransformRotated as JaxTransform
from lvc_tpu.modeling.roi_heads.fast_rcnn import Detections as JaxDetections
from lvc_tpu.modeling.roi_heads.rotated_fast_rcnn import RROIHeads as JaxRROIHeads
from lvc_tpu.ops import nms as jnms
from lvc_tpu.ops import roi_align as jra
from lvc_tpu.structures import rotated_boxes as jrb

from lvc_tpu_torch.checkpoint.convert import from_flax, to_flax
from lvc_tpu_torch.data import catalog as port_catalog
from lvc_tpu_torch.data.builtin_meta import _get_builtin_metadata as port_meta
from lvc_tpu_torch.data.coco_api import COCO
from lvc_tpu_torch.data.meta_coco import register_meta_coco as port_register
from lvc_tpu_torch.evaluation import rotated_coco_evaluation as rce
from lvc_tpu_torch.modeling.box_regression import Box2BoxTransformRotated
from lvc_tpu_torch.modeling.roi_heads.fast_rcnn import Detections
from lvc_tpu_torch.modeling.roi_heads.rotated_fast_rcnn import RROIHeads
from lvc_tpu_torch.ops import nms
from lvc_tpu_torch.ops import roi_align as ra
from lvc_tpu_torch.structures import rotated_boxes as rb
from test_torch_swin import leaves, rel_l2

DEGENERATE = np.array([
    [50, 50, 20, 10, 0], [50, 50, 20, 10, 0],  # identical
    [50, 50, 20, 10, 180], [50, 50, 20, 10, -180],  # the same box at +-180
    [70, 50, 20, 10, 0], [50, 60, 20, 10, 0],  # touching an edge of the first
    [50, 50, 10, 20, 90], [200, 200, 4, 4, 45],  # the first box turned 90 degrees with w, h swapped; disjoint
    [50, 50, 0, 10, 0], [50, 50, 20, 0, 30],  # zero area
], np.float32)


def _rboxes(n, seed, lo=10.0, hi=90.0):
    rng = np.random.RandomState(seed)
    return np.stack([rng.uniform(lo, hi, n), rng.uniform(lo, hi, n), rng.uniform(2, 40, n), rng.uniform(2, 40, n),
                     rng.uniform(-180, 180, n)], 1).astype(np.float32)


def test_box_functions_match_jax():
    a = np.concatenate([_rboxes(30, 0, -20, 120), DEGENERATE])
    ta, ja = torch.from_numpy(a), jnp.asarray(a)
    np.testing.assert_allclose(rb.area_rotated(ta).numpy(), np.asarray(jrb.area_rotated(ja)), rtol=0, atol=1e-5)
    np.testing.assert_allclose(rb.normalize_angles(ta).numpy(), np.asarray(jrb.normalize_angles(ja)), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(rb.clip_rotated(ta, 100.0, 90.0, 30.0).numpy(),
                               np.asarray(jrb.clip_rotated(ja, 100.0, 90.0, 30.0)), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(rb.nonempty_rotated(ta).numpy(), np.asarray(jrb.nonempty_rotated(ja)))
    np.testing.assert_allclose(rb.corners(ta).numpy(), np.asarray(jrb.corners(ja)), rtol=0, atol=1e-5)


def test_pairwise_iou_matches_jax_on_degenerate_pairs():
    a = np.concatenate([_rboxes(40, 1), DEGENERATE])
    b = np.concatenate([_rboxes(30, 2), DEGENERATE])
    got = rb.pairwise_iou_rotated(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    want = np.asarray(jrb.pairwise_iou_rotated(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    inter = rb.pairwise_intersection_rotated(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(inter, np.asarray(jrb.pairwise_intersection_rotated(jnp.asarray(a), jnp.asarray(b))),
                               rtol=0, atol=1e-3)
    d = np.arange(len(DEGENERATE))
    iou = rb.pairwise_iou_rotated(torch.from_numpy(DEGENERATE), torch.from_numpy(DEGENERATE)).numpy()
    assert iou[0, 1] == pytest.approx(1.0, abs=1e-5) and iou[2, 3] == pytest.approx(1.0, abs=1e-5)
    assert iou[0, 4] == pytest.approx(0.0, abs=1e-5) and iou[0, 5] == pytest.approx(0.0, abs=1e-5)
    assert iou[0, 6] == pytest.approx(1.0, abs=1e-5) and iou[0, 7] == 0.0
    assert (iou[8] == 0).all() and (iou[:, 9] == 0).all() and len(d) == 10
    # leading batch dimensions are independent sets
    batched = rb.pairwise_iou_rotated(torch.from_numpy(np.stack([a[:20], a[20:40]])),
                                      torch.from_numpy(np.stack([b[:10], b[10:20]]))).numpy()
    np.testing.assert_allclose(batched[1], want[20:40, 10:20], rtol=0, atol=1e-5)


def test_box2box_transform_rotated_matches_jax():
    src, dst = _rboxes(50, 3), _rboxes(50, 4)
    dst[:5, 4] = src[:5, 4] + np.array([180, -180, 179.5, -190, 360])  # angle differences that wrap
    t, j = Box2BoxTransformRotated((10, 10, 5, 5, 1)), JaxTransform((10, 10, 5, 5, 1))
    d = t.get_deltas(torch.from_numpy(src), torch.from_numpy(dst))
    jd = j.get_deltas(jnp.asarray(src), jnp.asarray(dst))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=0, atol=1e-5)
    deltas = np.random.RandomState(5).randn(50, 3, 5).astype(np.float32) * 2
    deltas[0, 0, 2] = 20.0  # over the scale clamp
    got = t.apply_deltas(torch.from_numpy(deltas), torch.from_numpy(src)[:, None])
    want = j.apply_deltas(jnp.asarray(deltas), jnp.asarray(src)[:, None])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)
    round_trip = t.apply_deltas(d, torch.from_numpy(src)).numpy()
    np.testing.assert_allclose(round_trip[:, :4], dst[:, :4], rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("seed", [0])
def test_rotated_nms_matches_jax(seed):
    rng = np.random.RandomState(seed)
    n = 300
    boxes = _rboxes(n, 10 + seed, 20, 200)
    boxes[:, 2:4] *= 2
    scores = rng.permutation(n).astype(np.float32) / n  # distinct scores
    valid = rng.rand(n) < 0.9
    iou = np.asarray(jrb.pairwise_iou_rotated(jnp.asarray(boxes), jnp.asarray(boxes)))[valid][:, valid]
    for base in (0.3, 0.7):
        # the nearest threshold no valid pair's IoU lies within 1e-4 of (a near-tie decides nothing)
        thr = next(t for t in base + np.arange(50) * 1e-3 if np.abs(iou - t).min() > 1e-4)
        want = np.asarray(jnms.nms_rotated_mask(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid), thr))
        got = nms.nms_rotated_mask(torch.from_numpy(boxes), torch.from_numpy(scores), torch.from_numpy(valid), thr)
        np.testing.assert_array_equal(got.numpy(), want)
        assert 0 < want.sum() < valid.sum()
    classes = rng.randint(0, 4, n)
    want = np.asarray(jnms.batched_nms_rotated_mask(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(classes),
                                                    jnp.asarray(valid), 0.5))
    got = nms.batched_nms_rotated_mask(torch.from_numpy(np.stack([boxes, boxes])), torch.from_numpy(
        np.stack([scores, scores])), torch.from_numpy(np.stack([classes, classes])), torch.from_numpy(
        np.stack([valid, valid])), 0.5)
    np.testing.assert_array_equal(got[1].numpy(), want)


@pytest.mark.parametrize("aligned,ratio", [(True, 0), (False, 0), (True, 2)])
def test_roi_align_rotated_matches_jax(aligned, ratio):
    rng = np.random.RandomState(0)
    feat = rng.randn(2, 25, 30, 8).astype(np.float32)
    rois = np.stack([_rboxes(24, 1, -10, 130), _rboxes(24, 2, -10, 130)])
    rois[:, :3, 2:4] = [[300, 40], [0.5, 0.5], [60, 200]]  # wider than the level, tiny, tall
    gout = rng.randn(2, 24, 7, 7, 8).astype(np.float32)

    def f(feat):
        out = jax.vmap(lambda fm, r: jra.roi_align_rotated(fm, r, 0.25, sampling_ratio=ratio, aligned=aligned))(
            feat, jnp.asarray(rois))
        return jnp.sum(out * gout), out

    (_, want), j_g = jax.jit(jax.value_and_grad(f, has_aux=True))(jnp.asarray(feat))
    tf = torch.from_numpy(feat).requires_grad_(True)
    got = ra.roi_align_rotated(tf, torch.from_numpy(rois), 0.25, sampling_ratio=ratio, aligned=aligned, chunk=10)
    (got * torch.from_numpy(gout)).sum().backward()
    want = np.asarray(want)
    assert np.abs(got.detach().numpy() - want).max() <= 1e-5 * np.abs(want).max()
    assert rel_l2(tf.grad.numpy(), j_g) <= 1e-4


B, C = 2, 16
LEVELS = {"p2": (32, 40), "p3": (16, 20), "p4": (8, 10), "p5": (4, 5)}
STRIDES = {"p2": 4, "p3": 8, "p4": 16, "p5": 32}
HEAD_ARGS = dict(num_classes=6, batch_size_per_image=128, positive_fraction=0.999, fc_dim=32,
                 score_thresh_test=0.01, detections_per_image=12)


def _head_inputs():
    rng = np.random.RandomState(0)
    feats = {k: rng.randn(B, h, w, C).astype(np.float32) for k, (h, w) in LEVELS.items()}
    gt = np.zeros((B, 4, 5), np.float32)
    gt[:, :3] = np.stack([_rboxes(3, 5, 30, 130), _rboxes(3, 6, 30, 110)])
    gt[:, :3, 2:4] *= 2.5
    props = np.repeat(gt[:, :3], 8, axis=1) + rng.normal(0, 1, (B, 24, 5)).astype(np.float32) * [6, 6, 4, 4, 10]
    props = np.concatenate([props, np.stack([_rboxes(16, 7, 10, 150), _rboxes(16, 8, 10, 120)])], 1)
    valid = np.ones((B, 40), bool)
    valid[1, -4:] = False
    sizes = np.array([[128, 160], [112, 150]], np.int32)
    gt_dict = {"boxes": gt, "classes": np.array([[1, 4, 2, 0], [5, 0, 3, 0]], np.int32),
               "valid": np.array([[True] * 3 + [False]] * B)}
    return feats, props.astype(np.float32), valid, sizes, gt_dict


@functools.lru_cache(maxsize=None)
def _heads():
    feats, props, valid, sizes, _ = _head_inputs()
    jheads = JaxRROIHeads(in_features=tuple(LEVELS), strides=STRIDES, **HEAD_ARGS)
    jf = {k: jnp.asarray(v) for k, v in feats.items()}
    var = jax.jit(lambda k: jheads.init({"params": k}, jf, jnp.asarray(props), jnp.asarray(valid),
                                        jnp.asarray(sizes), None))(jax.random.PRNGKey(0))
    var = jax.tree_util.tree_map(np.array, var)
    var["params"]["box_predictor"]["cls_score"]["kernel"] *= 30.0  # spread class scores: no near-ties
    var["params"]["box_predictor"]["bbox_pred"]["kernel"] *= 10.0
    theads = RROIHeads(tuple(LEVELS), STRIDES, C, **HEAD_ARGS)
    sd = {k[len("roi_heads."):]: v for k, v in from_flax({"params": {"roi_heads": var["params"]}}).items()}
    theads.load_state_dict(sd, strict=True)
    return jheads, var, theads


def _nchw(feats, grad=False):
    return {k: torch.from_numpy(v).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
            .requires_grad_(grad) for k, v in feats.items()}


def test_rroi_heads_training_matches_jax():
    jheads, var, theads = _heads()
    feats, props, valid, sizes, gt = _head_inputs()
    jgt = {k: jnp.asarray(v) for k, v in gt.items()}

    def f(params, feats):
        losses = jheads.apply({"params": params}, feats, jnp.asarray(props), jnp.asarray(valid), jnp.asarray(sizes),
                              jgt, train=True, rngs={"sampling": jax.random.PRNGKey(0)})
        return sum(losses.values()), losses

    (_, j_losses), (j_gp, j_gf) = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(
        var["params"], {k: jnp.asarray(v) for k, v in feats.items()})
    theads.train()
    tf = _nchw(feats, grad=True)
    losses = theads(tf, torch.from_numpy(props), torch.from_numpy(valid), torch.from_numpy(sizes),
                    {k: torch.from_numpy(v) for k, v in gt.items()}, torch.Generator().manual_seed(0))
    sum(losses.values()).backward()
    assert set(losses) == set(j_losses) == {"loss_cls", "loss_box_reg"}
    for k, v in j_losses.items():
        assert float(v) > 0
        assert float(losses[k].detach()) == pytest.approx(float(v), rel=1e-5, abs=1e-7), k
    for k in feats:
        assert rel_l2(tf[k].grad.permute(0, 2, 3, 1).numpy(), j_gf[k]) <= 1e-4, k
    g = from_flax({"params": {"roi_heads": jax.tree_util.tree_map(np.asarray, j_gp)}})
    for n, p in theads.named_parameters():
        assert rel_l2(p.grad.numpy(), g[f"roi_heads.{n}"].numpy()) <= 1e-4, n


def test_rroi_heads_detections_match_jax():
    jheads, var, theads = _heads()
    feats, props, valid, sizes, _ = _head_inputs()
    jd = jax.jit(lambda v, f: jheads.apply(v, f, jnp.asarray(props), jnp.asarray(valid), jnp.asarray(sizes), None))(
        var, {k: jnp.asarray(v) for k, v in feats.items()})
    theads.eval()
    with torch.no_grad():
        td = theads(_nchw(feats), torch.from_numpy(props), torch.from_numpy(valid), torch.from_numpy(sizes))
    v = np.asarray(jd.valid)
    assert v.sum() >= 10 and td.boxes.shape == (B, 12, 5)
    np.testing.assert_array_equal(td.valid.numpy(), v)
    np.testing.assert_array_equal(td.classes.numpy()[v], np.asarray(jd.classes)[v])
    np.testing.assert_array_equal(td.proposal_idx.numpy()[v], np.asarray(jd.proposal_idx)[v])
    np.testing.assert_allclose(td.boxes.numpy()[v], np.asarray(jd.boxes)[v], rtol=0, atol=1e-3)
    np.testing.assert_allclose(td.scores.numpy()[v], np.asarray(jd.scores)[v], rtol=0, atol=1e-4)


def test_rroi_heads_weights_round_trip():
    _, var, theads = _heads()
    back = to_flax({f"roi_heads.{k}": v for k, v in theads.state_dict().items()})["params"]["roi_heads"]
    got, want = dict(leaves(back)), dict(leaves(var["params"]))
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v)
    assert tuple(theads.state_dict()["box_predictor.bbox_pred.weight"].shape) == (30, 32)
    fresh = RROIHeads(tuple(LEVELS), STRIDES, C, **HEAD_ARGS)
    fresh.load_state_dict(theads.state_dict(), strict=True)


N_IMG = 4


@pytest.fixture(scope="module")
def rotated_tree(tmp_path_factory):
    """Seeded ground truth (XYWH, one in five crowd) on 4 images of 480x640,
    2 boxes of each of 2 COCO categories an image, registered in both
    catalogs; and rotated detections in a 1.25x canvas, 3 of each category
    an image (2 near the gt, turned up to ~10 degrees, and 1 false
    positive). Every (image, category) holds 2 gt and 3 detections: JAX's
    evaluator compiles its IoU for every shape of pair set, so one shape
    keeps it to one compile."""
    root = tmp_path_factory.mktemp("rottree")
    rng = np.random.RandomState(0)
    cats = [1, 3]
    images = [{"id": i + 1, "file_name": f"{i}.jpg", "height": 480, "width": 640} for i in range(N_IMG)]
    anns = []
    for img in images:
        for cat in cats:
            for _ in range(2):
                w, h = rng.uniform(20, 200, 2)
                x, y = rng.uniform(0, 640 - w), rng.uniform(0, 480 - h)
                anns.append({"id": len(anns) + 1, "image_id": img["id"], "category_id": cat,
                             "bbox": [x, y, w, h], "area": w * h, "iscrowd": int(rng.rand() < 0.2)})
    from lvc_tpu_torch.data.builtin_meta import COCO_CATEGORIES

    path = str(root / "gt.json")
    with open(path, "w") as f:
        json.dump({"images": images, "annotations": anns,
                   "categories": [{"id": c["id"], "name": c["name"]} for c in COCO_CATEGORIES]}, f)
    name = "rottree_test"
    for catalog, register, meta in ((jax_catalog.DatasetCatalog, jax_register, jax_meta),
                                    (port_catalog.DatasetCatalog, port_register, port_meta)):
        if name in catalog:
            catalog.remove(name)
        register(name, meta("coco"), str(root), path)
    id_map = port_meta("coco")["thing_dataset_id_to_contiguous_id"]
    rows = []
    for i in range(N_IMG):
        for cat in cats:
            for a in [a for a in anns if a["image_id"] == i + 1 and a["category_id"] == cat]:
                x, y, w, h = a["bbox"]
                rows.append([x + w / 2 + rng.normal(0, 4), y + h / 2 + rng.normal(0, 4), w * rng.uniform(0.9, 1.1),
                             h * rng.uniform(0.9, 1.1), rng.normal(0, 5), id_map[cat]])
            rows.append(list(rng.uniform([50, 50, 10, 10, -90], [600, 430, 150, 100, 90])) + [id_map[cat]])
    rows = np.array(rows).reshape(N_IMG, 6, 6)
    boxes = (rows[..., :5] * [1.25, 1.25, 1.25, 1.25, 1.0]).astype(np.float32)
    scores = rng.uniform(0.05, 1.0, (N_IMG, 6)).astype(np.float32)
    classes = rows[..., 5].astype(np.int64)
    # a padded slot an image: invalid rows are dropped
    boxes = np.concatenate([boxes, boxes[:, :1]], 1)
    scores = np.concatenate([scores, scores[:, :1]], 1)
    classes = np.concatenate([classes, classes[:, :1]], 1)
    valid = np.ones(classes.shape, bool)
    valid[:, -1] = False
    metas = [{"image_id": i + 1, "image_size": (600, 800), "orig_size": (480, 640)} for i in range(N_IMG)]
    return path, (boxes, scores, classes, valid), metas


def test_rotated_cocoeval_matches_jax(rotated_tree):
    path, (boxes, scores, classes, valid), metas = rotated_tree
    rows = []
    for i, meta in enumerate(metas):
        one = Detections(torch.from_numpy(boxes[i]), torch.from_numpy(scores[i]), torch.from_numpy(classes[i]),
                         torch.from_numpy(valid[i]), torch.zeros(boxes.shape[1], dtype=torch.int64))
        rows += rce.rotated_detections_to_coco_json(one, meta)
    rev = {v: k for k, v in port_meta("coco")["thing_dataset_id_to_contiguous_id"].items()}
    for r in rows:
        r["category_id"] = rev[r["category_id"]]
    stats = []
    for coco, evaluator in ((COCO(path), rce.RotatedCOCOeval), (JaxCOCO(path), jrce.RotatedCOCOeval)):
        ev = evaluator(coco, coco.loadRes([dict(r) for r in rows]))
        ev.evaluate()
        ev.accumulate()
        ev.summarize()
        stats.append(np.asarray(ev.stats))
    np.testing.assert_allclose(stats[0], stats[1], rtol=0, atol=1e-9)
    assert 20 < stats[0][0] * 100 < 100
    ious = rce.rotated_iou_xywha(np.array([r["bbox"] for r in rows[:20]]), np.array([[10, 10, 50, 40]] * 3),
                                 np.array([0, 1, 0]))
    np.testing.assert_allclose(ious, jrce.rotated_iou_xywha(np.array([r["bbox"] for r in rows[:20]]),
                                                            np.array([[10, 10, 50, 40]] * 3), np.array([0, 1, 0])),
                               rtol=0, atol=1e-9)


def test_rotated_evaluator_matches_jax(rotated_tree, tmp_path):
    _, (boxes, scores, classes, valid), metas = rotated_tree
    results = []
    for evaluator, dets in (
        (rce.RotatedCOCOEvaluator("rottree_test", output_dir=str(tmp_path / "port")),
         Detections(torch.from_numpy(boxes), torch.from_numpy(scores), torch.from_numpy(classes),
                    torch.from_numpy(valid), torch.zeros(classes.shape, dtype=torch.int64))),
        (jrce.RotatedCOCOEvaluator("rottree_test", output_dir=str(tmp_path / "jax")),
         JaxDetections(boxes, scores, classes, valid, np.zeros(classes.shape, np.int64))),
    ):
        evaluator.reset()
        evaluator.process_detections(dets, metas[:3] + [dict(metas[3], padding=False)] + metas[4:])
        results.append(evaluator.evaluate())
    assert results[0].keys() == results[1].keys() == {"bbox"}
    port, jax_res = results[0]["bbox"], results[1]["bbox"]
    assert port.keys() == jax_res.keys()
    for k, v in jax_res.items():
        assert port[k] == pytest.approx(v, abs=1e-9, nan_ok=True), k
    with open(tmp_path / "port" / "coco_instances_results.json") as f, \
            open(tmp_path / "jax" / "coco_instances_results.json") as g:
        a, b = json.load(f), json.load(g)
    assert len(a) == len(b) == int(valid.sum())
    for x, y in zip(a, b):
        assert x["category_id"] == y["category_id"] and x["image_id"] == y["image_id"]
        np.testing.assert_allclose(x["bbox"], y["bbox"], rtol=1e-6)
