"""Test-time augmentation in the port against the JAX package on the CPU.

On ``tests/test_d2_surface.py::test_tta_mapper_and_merge``'s inputs (scales
64 and 96, MAX_SIZE 200, buckets 128 and 256, a 100 x 80 image) the variants'
canvases, sizes, scales, flips and widths are equal; boxes mapped back to the
original image are within abs 1e-4; the merge keeps and orders the same
detections. A narrow detector's TTA (``torch_narrow_detector.py``, JAX
weights carried by ``from_flax``) matches JAX's: boxes 1e-3 px, scores 1e-4,
classes and validity equal. At the defaults both packages raise on a
480 x 640 image (short side 1100 makes 1100 x 1467, wider than every bucket).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lvc_tpu.config import get_cfg as jax_get_cfg
from lvc_tpu.modeling import test_time_augmentation as jtta
from lvc_tpu.modeling.meta_arch.build import build_model as jax_build_model
from lvc_tpu_torch.checkpoint.convert import from_flax
from lvc_tpu_torch.config import get_cfg
from lvc_tpu_torch.modeling import test_time_augmentation as ptta
from lvc_tpu_torch.modeling.meta_arch.build import build_model
from torch_narrow_detector import narrow_cfg, narrow_variables


def _surface_cfg(cfg):
    cfg.TEST.AUG.MIN_SIZES = (64, 96)
    cfg.TEST.AUG.MAX_SIZE = 200
    cfg.PAD.CANVAS_BUCKETS = [[128, 128], [256, 256]]
    return cfg


def _image(h=100, w=80, seed=0):
    return (np.random.RandomState(seed).rand(h, w, 3) * 255).astype(np.uint8)


def test_mapper_variants_equal_jax():
    img = _image()
    got = ptta.DatasetMapperTTA(_surface_cfg(get_cfg()))(img)
    want = jtta.DatasetMapperTTA(_surface_cfg(jax_get_cfg()))(img)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        assert g["tta_flip"] == w["tta_flip"] and g["tta_width"] == w["tta_width"]
        for k in ("image", "image_size", "tta_scale"):
            assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), k


@pytest.mark.parametrize("flip", [False, True])
def test_boxes_to_original_match_jax(flip):
    rng = np.random.RandomState(1)
    xy = rng.rand(20, 2) * 60
    boxes = np.concatenate([xy, xy + rng.rand(20, 2) * 30], 1).astype(np.float32)
    scale = np.array([0.64, 0.8], np.float32)
    got = ptta._boxes_to_original(boxes, scale, flip, 64)
    want = jtta._boxes_to_original(boxes, scale, flip, 64)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_merge_keeps_and_orders_as_jax():
    rng = np.random.RandomState(2)
    n = 60
    xy = rng.rand(n, 2) * 50
    boxes = np.concatenate([xy, xy + 10 + rng.rand(n, 2) * 20], 1).astype(np.float32)
    boxes[n // 2:] = boxes[: n // 2] + rng.rand(n // 2, 4).astype(np.float32)  # near-copies, as from flips
    scores = rng.permutation(n).astype(np.float32) / n  # distinct
    classes = rng.randint(0, 3, n).astype(np.int32)
    valid = rng.rand(n) > 0.1
    b, s, c, ok = ptta.merge_tta_detections(
        *(torch.from_numpy(x) for x in (boxes, scores, classes, valid)), 0.5, n
    )
    jb, js, jc, jok = jtta.merge_tta_detections(*(jnp.asarray(x) for x in (boxes, scores, classes, valid)), 0.5, n)
    assert np.array_equal(ok.numpy(), np.asarray(jok))
    k = ok.numpy()
    assert 0 < k.sum() < valid.sum()  # the near-copies were suppressed
    assert np.array_equal(b.numpy()[k], np.asarray(jb)[k])
    assert np.array_equal(s.numpy()[k], np.asarray(js)[k])
    assert np.array_equal(c.numpy()[k], np.asarray(jc)[k])


def test_default_scales_raise_as_jax():
    img = _image(480, 640)
    for mapper in (ptta.DatasetMapperTTA(get_cfg()), jtta.DatasetMapperTTA(jax_get_cfg())):
        with pytest.raises(ValueError):
            mapper(img)


def _tta_cfg(cfg):
    cfg = narrow_cfg(cfg, "auto")
    cfg.TEST.AUG.MIN_SIZES = (80, 96)  # both scales of a 96 x 128 image on one canvas
    cfg.TEST.AUG.MAX_SIZE = 400
    cfg.PAD.CANVAS_BUCKETS = [[128, 192]]
    return cfg


def test_narrow_detector_tta_matches_jax():
    variables = narrow_variables()
    img = _image(96, 128, seed=5)
    jcfg = _tta_cfg(jax_get_cfg())
    jmodel = jax_build_model(jcfg)
    jvars = jax.tree_util.tree_map(jnp.asarray, variables)
    apply = jax.jit(lambda batch: jmodel.apply(jvars, batch, train=False))
    jb, js, jc, jok = jtta.GeneralizedRCNNWithTTA(jcfg, lambda b: apply({k: jnp.asarray(v) for k, v in b.items()}))(img)

    cfg = _tta_cfg(get_cfg())
    model = build_model(cfg, device="cpu")
    model.load_state_dict(from_flax(variables))
    tta = ptta.GeneralizedRCNNWithTTA(cfg, model)
    b, s, c, ok = tta(img)
    assert np.array_equal(ok, np.asarray(jok)) and ok.sum() > 5
    np.testing.assert_allclose(b[ok], np.asarray(jb)[ok], rtol=0, atol=1e-3)
    np.testing.assert_allclose(s[ok], np.asarray(js)[ok], rtol=0, atol=1e-4)
    assert np.array_equal(c[ok], np.asarray(jc)[ok])
    # the identity variant at each scale is the plain eval forward on its canvas
    variants = tta.tta_mapper(img)
    (vb, vs, vc, vv), _ = tta.variant_detections(img)
    D = cfg.TEST.DETECTIONS_PER_IMAGE
    for i, v in enumerate(variants):
        if v["tta_flip"]:
            continue
        dets = model({"image": v["image"][None], "image_size": v["image_size"][None]})
        np.testing.assert_array_equal(vs[i * D:(i + 1) * D], dets.scores[0].numpy())
        np.testing.assert_array_equal(vv[i * D:(i + 1) * D], dets.valid[0].numpy())
