"""The C4 detector (``build_resnet_backbone`` + ``Res5ROIHeads``, the default
configuration of both packages: res4 features, a 14 x 14 pool, three res5
blocks in the head) against the JAX package on the CPU.

- The head alone (res2 out 16, so res4 is 64 wide and res5 128; width per
  group 4), on seeded res4 features (stride 16, B=2 256x320 canvas),
  proposals and gt with exhaustive sampling: losses rel 1e-5, gradients of
  the features and every head parameter rel L2 1e-4, detections as in
  tests/test_torch_extra_heads.py (boxes abs 1e-4, scores abs 1e-5).
- The whole narrow model (``build_model``, the same widths, a B=2 128x192
  canvas, RPN 200/100 at test) from JAX's seeded weights through
  ``from_flax``: proposals equal slot for slot to 1e-3 px, detections equal
  in validity and class, boxes to 1e-3 px and scores to 1e-4 (the
  tolerances of tests/test_torch_rcnn.py, with its weight scaling).
- The single-level pools at P=14 that the C4 head sends to the kernels'
  plain versions, against JAX's interpret-mode Pallas kernels on boxes up to
  the whole canvas, two wider than the paired window (46 columns at stride
  16): ``pallas_fast`` (JAX falls back to its band kernel, the port
  to K1's band form), ``pallas`` (K2) and ``pallas_train`` (K2 forward, the
  flat paired backward / K3): atol 1e-5 forward and backward. The JAX
  kernels run jitted under ``force_tpu_interpret_mode`` (a third of the
  time of ``interpret=True`` at P=14).
"""
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.experimental.pallas.tpu import force_tpu_interpret_mode

import lvc_tpu.ops.roi_align as jra
from lvc_tpu.config import get_cfg as jax_get_cfg
from lvc_tpu.modeling.meta_arch.build import build_model as jax_build_model
from lvc_tpu.modeling.proposal_generator.rpn import RPN as JaxRPN
from lvc_tpu.utils.init import materialize_variables

from lvc_tpu_torch.checkpoint.convert import from_flax
from lvc_tpu_torch.config import get_cfg
from lvc_tpu_torch.modeling.backbone.resnet import ResNet
from lvc_tpu_torch.modeling.meta_arch.build import build_model
from lvc_tpu_torch.modeling.roi_heads.extra_heads import Res5ROIHeads
from lvc_tpu_torch.ops import roi_align as tra
from test_torch_extra_heads import _heads, check_detections, check_training

B, H, W, C4 = 2, 256, 320, 64
NARROW = ["MODEL.BACKBONE.NAME", "build_resnet_backbone", "MODEL.RESNETS.RES2_OUT_CHANNELS", 16,
          "MODEL.RESNETS.WIDTH_PER_GROUP", 4, "MODEL.RESNETS.STEM_OUT_CHANNELS", 16]


def _head_opts():
    return NARROW + [
        "MODEL.ROI_HEADS.NUM_CLASSES", 6, "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", 64,
        "MODEL.ROI_HEADS.POSITIVE_FRACTION", 0.999, "MODEL.ROI_HEADS.POOLER_IMPL", "exact",
        "MODEL.ROI_HEADS.SCORE_THRESH_TEST", 0.01, "TEST.DETECTIONS_PER_IMAGE", 8,
    ]


def res4_inputs(seed=6):
    rng = np.random.RandomState(seed)
    feats = {"res4": np.maximum(rng.normal(0, 1, (B, H // 16, W // 16, C4)), 0).astype(np.float32)}
    xy = rng.uniform(0, 150, (B, 10, 2))
    wh = rng.uniform(24, 170, (B, 10, 2))
    proposals = np.concatenate([xy, np.minimum(xy + wh, [W - 1, H - 1])], -1).astype(np.float32)
    gt_boxes = proposals[:, [0, 4, 6], :] + rng.uniform(-4, 4, (B, 3, 4)).astype(np.float32)
    gt = {"boxes": gt_boxes, "classes": np.array([[1, 4, 5], [0, 2, 2]], np.int32),
          "valid": np.array([[True, True, True], [True, False, True]])}
    return feats, proposals, np.ones((B, 10), bool), np.array([[H, W], [H - 32, W]], np.int32), gt


@pytest.fixture(scope="module")
def res5_heads():
    feats, proposals, valid, sizes, gt = res4_inputs()
    jheads, _, make = _heads(_head_opts(), {"res4": 16}, C4, cls_gain=10.0)
    var, theads = make((feats, proposals, valid, sizes, {k: jnp.asarray(v) for k, v in gt.items()}))
    assert isinstance(theads, Res5ROIHeads) and not hasattr(theads, "box_head")
    return jheads, var, theads


def test_res5_head_training_matches_jax(res5_heads):
    feats, proposals, valid, sizes, gt = res4_inputs()
    losses = check_training(*res5_heads, feats, proposals, valid, sizes, gt, 6)
    assert set(losses) == {"loss_cls", "loss_box_reg"} and losses["loss_box_reg"] > 0


def test_res5_head_detections_match_jax(res5_heads):
    feats, proposals, valid, sizes, _ = res4_inputs()
    dets = check_detections(*res5_heads, feats, proposals, valid, sizes)
    assert tuple(dets.boxes.shape) == (B, 8, 4)


def _model_cfg(cfg):
    cfg.merge_from_list(NARROW + [
        "MODEL.ROI_HEADS.NUM_CLASSES", 5, "MODEL.RPN.PRE_NMS_TOPK_TEST", 200,
        "MODEL.RPN.POST_NMS_TOPK_TEST", 100, "TEST.DETECTIONS_PER_IMAGE", 30,
    ])
    return cfg


def test_c4_model_matches_jax():
    """The whole C4 model's serving forward; ``build_model`` builds the plain
    ResNet to res4 (no FPN) and gives the RPN and the head res4's width."""
    rng = np.random.RandomState(3)
    batch = {"image": (rng.rand(B, 128, 192, 3) * 255).astype(np.float32),
             "image_size": np.array([[128, 192], [112, 160]], np.int32)}
    jmodel = jax_build_model(_model_cfg(jax_get_cfg()))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    shapes = jax.eval_shape(functools.partial(jmodel.init, train=False), {"params": jax.random.PRNGKey(0)}, jbatch)
    var = jax.tree_util.tree_map(np.array, materialize_variables(shapes, seed=0, conv_init="he"))
    params = var["params"]
    for name, block in params["backbone"].items():
        for leaf in jax.tree_util.tree_leaves(block):
            if leaf.ndim == 4:
                leaf *= 0.7
    rpn = params["proposal_generator"]["rpn_head"]
    rpn["conv"]["conv"]["kernel"] *= 0.1
    rpn["objectness_logits"]["conv"]["kernel"] *= 0.1
    rpn["anchor_deltas"]["conv"]["kernel"] *= 0.01
    params["roi_heads"]["box_predictor"]["cls_score"]["kernel"] *= 0.3
    params["roi_heads"]["box_predictor"]["bbox_pred"]["kernel"] *= 0.3
    dets_j, state = jax.jit(lambda v, b: jmodel.apply(
        v, b, train=False,
        capture_intermediates=lambda mdl, name: isinstance(mdl, JaxRPN) and name == "__call__"))(var, jbatch)
    j_boxes, _, j_valid = [np.asarray(x) for x in state["intermediates"]["proposal_generator"]["__call__"][0][:3]]

    model = build_model(_model_cfg(get_cfg()), device="cpu")
    assert isinstance(model.backbone, ResNet) and model.backbone.out_features == ("res4",)
    assert model.proposal_generator.rpn_head.conv.in_channels == C4
    model.load_state_dict(from_flax(var), strict=True)
    t_boxes, _, t_valid = model.proposals(batch)
    dets = model(batch)
    np.testing.assert_array_equal(t_valid.numpy(), j_valid)
    assert j_valid.sum() > 50
    np.testing.assert_allclose(t_boxes.numpy(), j_boxes, atol=1e-3, rtol=0)
    v = np.asarray(dets_j.valid)
    assert v.sum() >= 10
    np.testing.assert_array_equal(dets.valid.numpy(), v)
    np.testing.assert_array_equal(dets.classes.numpy()[v], np.asarray(dets_j.classes)[v])
    np.testing.assert_allclose(dets.boxes.numpy()[v], np.asarray(dets_j.boxes)[v], atol=1e-3, rtol=0)
    np.testing.assert_allclose(dets.scores.numpy()[v], np.asarray(dets_j.scores)[v], atol=1e-4, rtol=0)


def _single_level():
    """res4 of a B=2 512x1024 canvas (32 x 64, C=16) and 2 boxes an image:
    the whole canvas, one 980 px wide at the bottom edge, one tall and thin,
    one small (the interpret-mode kernels take seconds a box)."""
    rng = np.random.RandomState(17)
    feats = [rng.rand(B, 32, 64, 16).astype(np.float32)]
    boxes = np.array([[[0.0, 0.0, 1024.0, 512.0], [20.0, 470.0, 1000.0, 512.0]],
                      [[900.0, 0.0, 940.0, 500.0], [33.5, 61.25, 120.0, 90.0]]], np.float32)
    gout = rng.rand(B, 2, 14, 14, 16).astype(np.float32)
    return feats, boxes, (16,), gout


POOL14 = dict(output_size=14, sampling_ratio=0, max_grid=2, min_level=4)


@pytest.mark.parametrize("impl", ["pallas_fast", "pallas"])
def test_single_level_serving_pools_match_jax(impl):
    feats, boxes, strides, _ = _single_level()
    jfn = jra.batched_multilevel_roi_align_pallas_patch_ml if impl == "pallas_fast" else \
        jra.batched_multilevel_roi_align_pallas_paired
    with force_tpu_interpret_mode():
        want = jax.jit(lambda f, b: jfn(f, b, strides, **POOL14))([jnp.asarray(f) for f in feats], jnp.asarray(boxes))
    tfeats, tboxes = [torch.from_numpy(f) for f in feats], torch.from_numpy(boxes)
    before = tra.roi_align_band.launches, tra.roi_align_paired.launches
    if impl == "pallas_fast":
        got = tra.pool_band(tfeats, tboxes, strides, **POOL14)
    else:
        got = tra.pool_paired(tfeats, tboxes, strides, **POOL14)
    assert (tra.roi_align_band.launches, tra.roi_align_paired.launches) == before
    assert got.shape == want.shape == (B, 2, 14, 14, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_single_level_train_pool_matches_jax():
    """JAX's ``pallas_train`` on one level: the padded-flat paired forward and
    the flat paired backward (``roi_align.py:2743-2749, 3264-3269``)."""
    feats, boxes, strides, gout = _single_level()

    @jax.jit
    def jax_pool(f, b, g):
        out, vjp = jax.vjp(lambda fs: jra.batched_multilevel_roi_align_pallas_train_ml(
            fs, b, strides, 14, 0, 2, 4, 224, 4, 48), f)
        return out, vjp(g)[0]

    with force_tpu_interpret_mode():
        want_out, (want_grad,) = jax_pool((jnp.asarray(feats[0]),), jnp.asarray(boxes), jnp.asarray(gout))
    level = torch.from_numpy(feats[0]).requires_grad_()
    out = tra.pool_paired_train([level], torch.from_numpy(boxes), strides, **POOL14)
    (grad,) = torch.autograd.grad(out, [level], torch.from_numpy(gout))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), atol=1e-5, rtol=0)
    np.testing.assert_allclose(grad.numpy(), np.asarray(want_grad), atol=1e-5, rtol=0)
