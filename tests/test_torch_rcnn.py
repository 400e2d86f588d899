"""The port's whole serving slice against the JAX package on the CPU.

A narrow R-50-FPN (RES2_OUT_CHANNELS 64, WIDTH_PER_GROUP 16, FPN 64 wide) on
a B=2 128x192 canvas, JAX weights carried over by ``from_flax``, float32.
Proposals must be equal slot for slot and detections equal in ``valid`` and
``classes``, with boxes to 1e-3 and scores to 1e-4: the two frameworks' convs
differ by ~1e-6 relative, far inside those tolerances, and the weights are
scaled so that RPN logits and class scores are well spread (no near-ties
that such differences could reorder).

JAX's Pallas pools run in interpret mode; the test patches that into the
``lvc_tpu.ops.roi_align`` module attribute for its own duration only.
"""
import functools

import numpy as np
import pytest

import jax
import torch

import lvc_tpu.ops.roi_align as jax_roi_align
from lvc_tpu.config import get_cfg as jax_get_cfg
from lvc_tpu.modeling.meta_arch.build import build_model as jax_build_model
from lvc_tpu.modeling.proposal_generator.rpn import RPN as JaxRPN
from lvc_tpu.utils.init import materialize_variables

from lvc_tpu_torch.checkpoint.convert import from_flax
from lvc_tpu_torch.config import get_cfg
from lvc_tpu_torch.modeling.meta_arch.build import build_model
from lvc_tpu_torch.ops import roi_align as torch_roi_align

B, H, W = 2, 128, 192


def _narrow(cfg, impl):
    cfg.merge_from_file("configs/Base-RCNN-FPN.yaml")
    cfg.MODEL.RESNETS.DEPTH = 50
    cfg.MODEL.RESNETS.RES2_OUT_CHANNELS = 64
    cfg.MODEL.RESNETS.WIDTH_PER_GROUP = 16
    cfg.MODEL.FPN.OUT_CHANNELS = 64
    cfg.MODEL.ROI_HEADS.NUM_CLASSES = 5
    cfg.MODEL.ROI_BOX_HEAD.FC_DIM = 128
    cfg.MODEL.RPN.PRE_NMS_TOPK_TEST = 200
    cfg.MODEL.RPN.POST_NMS_TOPK_TEST = 100
    cfg.MODEL.ROI_HEADS.POOLER_IMPL = impl
    cfg.TEST.DETECTIONS_PER_IMAGE = 30
    return cfg


def _batch():
    rng = np.random.RandomState(3)
    image = (rng.rand(B, H, W, 3) * 255).astype(np.float32)
    sizes = np.array([[H, W], [112, 160]], np.int32)
    return {"image": image, "image_size": sizes}


@pytest.fixture(scope="module")
def variables():
    model = jax_build_model(_narrow(jax_get_cfg(), "exact"))
    batch = {k: jax.numpy.asarray(v) for k, v in _batch().items()}
    shapes = jax.eval_shape(
        functools.partial(model.init, train=False), {"params": jax.random.PRNGKey(0)}, batch
    )
    var = materialize_variables(shapes, seed=0, conv_init="he")
    # Scale the He init so that FPN features are O(10), RPN logits have a
    # std of ~1-2 with deltas of ~0.1 (proposals move off the anchor grid,
    # whose exact IoUs could sit at the NMS threshold), and class scores
    # spread over (0.05, 0.5): no near-ties for 1e-6 conv differences to flip.
    for block in var["params"]["backbone"]["bottom_up"].values():
        for path, leaf in _leaves(block):
            if path[-1] == "kernel":
                leaf *= 0.7
    rpn = var["params"]["proposal_generator"]["rpn_head"]
    rpn["conv"]["conv"]["kernel"] *= 0.1
    rpn["objectness_logits"]["conv"]["kernel"] *= 0.1
    rpn["anchor_deltas"]["conv"]["kernel"] *= 0.01
    head = var["params"]["roi_heads"]["box_predictor"]
    head["cls_score"]["kernel"] *= 0.03
    head["bbox_pred"]["kernel"] *= 0.3
    return var


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def _run_jax(variables, impl):
    model = jax_build_model(_narrow(jax_get_cfg(), impl))
    batch = {k: jax.numpy.asarray(v) for k, v in _batch().items()}
    dets, state = model.apply(
        variables, batch, train=False,
        capture_intermediates=lambda mdl, name: isinstance(mdl, JaxRPN) and name == "__call__",
    )
    props = state["intermediates"]["proposal_generator"]["__call__"][0]
    return [np.asarray(x) for x in props[:3]], dets


@pytest.mark.parametrize("impl", ["pallas_fast", "pallas"])
def test_slice_matches_jax(variables, impl, monkeypatch):
    for name in (
        "batched_multilevel_roi_align_pallas_patch_ml",
        "batched_multilevel_roi_align_pallas_paired",
    ):
        orig = getattr(jax_roi_align, name)
        monkeypatch.setattr(jax_roi_align, name, functools.partial(orig, interpret=True))
    (j_boxes, j_scores, j_valid), j_dets = _run_jax(variables, impl)

    model = build_model(_narrow(get_cfg(), impl), device="cpu")
    model.load_state_dict(from_flax(variables))
    launches = (torch_roi_align.roi_align_band.launches, torch_roi_align.roi_align_paired.launches)
    t_boxes, t_scores, t_valid = model.proposals(_batch())
    dets = model(_batch())
    # CPU tensors take the plain versions: no kernel launched
    assert launches == (torch_roi_align.roi_align_band.launches, torch_roi_align.roi_align_paired.launches)

    np.testing.assert_array_equal(t_valid.numpy(), j_valid)
    assert j_valid.sum() > 50
    np.testing.assert_allclose(t_boxes.numpy(), j_boxes, atol=1e-3, rtol=0)
    np.testing.assert_allclose(t_scores.numpy(), j_scores, atol=1e-4, rtol=1e-5)

    valid = np.asarray(j_dets.valid)
    assert valid.sum() >= 10
    np.testing.assert_array_equal(dets.valid.numpy(), valid)
    np.testing.assert_array_equal(dets.classes.numpy()[valid], np.asarray(j_dets.classes)[valid])
    np.testing.assert_array_equal(
        dets.proposal_idx.numpy()[valid], np.asarray(j_dets.proposal_idx)[valid]
    )
    np.testing.assert_allclose(dets.boxes.numpy()[valid], np.asarray(j_dets.boxes)[valid], atol=1e-3, rtol=0)
    np.testing.assert_allclose(dets.scores.numpy()[valid], np.asarray(j_dets.scores)[valid], atol=1e-4, rtol=0)
