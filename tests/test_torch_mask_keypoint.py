"""The mask and keypoint heads, their losses and inference, the weight bridge
and a narrow Mask and Keypoint R-CNN against the JAX package on the CPU.

- ``MaskRCNNConvUpsampleHead`` and ``KRCNNConvDeconvUpsampleHead`` against
  the flax heads on the same weights (``from_flax``), at an even and an odd
  pool size: rel 1e-5 of the largest output. This holds the ConvTranspose
  kernel flip and the keypoint head's 2x bilinear upsample, its edge rows
  and columns included.
- ``crop_gt_masks``, ``mask_rcnn_loss``, ``mask_rcnn_inference``,
  ``paste_masks_in_image``, ``keypoints_to_heatmap_targets`` (keypoints on
  the box's right and bottom edges, outside it and invisible),
  ``keypoint_rcnn_loss`` and ``keypoint_rcnn_inference`` against JAX's
  functions on the same seeded inputs: the bins and pasted bits equal,
  losses rel 1e-6, probabilities abs 1e-6, crops abs 1e-5 (a float32 ulp of
  a sample position, which XLA rounds otherwise), keypoints abs 1e-5.
- A narrow R-50-FPN (res2 64, FPN 64, 5 classes, FC 128, mask and keypoint
  heads 2 convs 32 wide) with MASK_ON and KEYPOINT_ON together, on a B=2
  128x192 canvas with gt bitmasks at 1/4 of the canvas and 17 keypoints a
  gt, POOLER_IMPL exact in both packages and exhaustive sampling (both
  sample the same sets): one training forward and backward, every loss
  (``loss_mask`` and ``loss_keypoint`` included) rel 1e-5, every
  parameter's gradient rel L2 1e-4 (``score_lowres``'s bias, 0 in exact
  arithmetic, abs 1e-6); eval mode: the detections as in
  tests/test_torch_rcnn.py (boxes 1e-3 px, scores 1e-4), masks abs 5e-5
  (JAX's own float32 masks are 2.0e-5 from a float64 run), keypoints 1e-3
  px (or one heatmap cell, where two cells tie within float32 rounding: at
  most 1% of them) and their scores 1e-5.
- ``to_flax`` gives JAX's tree back; a state dict in detectron2's layout
  (its names and shapes for both heads) loads strictly.

JAX's model is built and run once for the module.
"""
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from lvc_tpu.config import get_cfg as jax_get_cfg
from lvc_tpu.modeling.meta_arch.build import build_model as jax_build_model
from lvc_tpu.modeling.roi_heads import keypoint_head as jkp
from lvc_tpu.modeling.roi_heads import mask_head as jmask
from lvc_tpu.utils.init import materialize_variables

from lvc_tpu_torch.checkpoint.convert import from_flax, to_flax
from lvc_tpu_torch.config import get_cfg
from lvc_tpu_torch.modeling.meta_arch.build import build_model
from lvc_tpu_torch.modeling.roi_heads import keypoint_head as kp
from lvc_tpu_torch.modeling.roi_heads import mask_head as mh

B, H, W, G, K = 2, 128, 192, 4, 17
NUM_CONV, CONV_DIM = 2, 32


def _narrow(cfg):
    cfg.merge_from_file("configs/Base-RCNN-FPN.yaml")
    cfg.merge_from_list([
        "MODEL.RESNETS.DEPTH", 50, "MODEL.RESNETS.RES2_OUT_CHANNELS", 64, "MODEL.RESNETS.WIDTH_PER_GROUP", 16,
        "MODEL.FPN.OUT_CHANNELS", 64, "MODEL.ROI_HEADS.NUM_CLASSES", 5, "MODEL.ROI_BOX_HEAD.FC_DIM", 128,
        "MODEL.ROI_HEADS.POOLER_IMPL", "exact", "MODEL.RPN.PRE_NMS_TOPK_TRAIN", 200,
        "MODEL.RPN.POST_NMS_TOPK_TRAIN", 100, "MODEL.RPN.BATCH_SIZE_PER_IMAGE", 8192,
        "MODEL.RPN.POSITIVE_FRACTION", 0.999, "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", 128,
        "MODEL.ROI_HEADS.POSITIVE_FRACTION", 0.999, "MODEL.RPN.PRE_NMS_TOPK_TEST", 200,
        "MODEL.RPN.POST_NMS_TOPK_TEST", 100, "TEST.DETECTIONS_PER_IMAGE", 30,
        "MODEL.MASK_ON", True, "MODEL.KEYPOINT_ON", True,
        "MODEL.ROI_MASK_HEAD.NUM_CONV", NUM_CONV, "MODEL.ROI_MASK_HEAD.CONV_DIM", CONV_DIM,
        "MODEL.ROI_KEYPOINT_HEAD.NUM_CONV", NUM_CONV, "MODEL.ROI_KEYPOINT_HEAD.CONV_DIM", CONV_DIM,
    ])
    return cfg


def _batch():
    rng = np.random.RandomState(3)
    gt_boxes = np.zeros((B, G, 4), np.float32)
    gt_boxes[0, :3] = [[20, 30, 90, 100], [60, 10, 150, 70], [5, 70, 40, 120]]
    gt_boxes[1, :3] = [[100, 20, 180, 110], [10, 10, 60, 50], [70, 60, 130, 100]]
    masks = np.zeros((B, G, H // 4, W // 4), np.float32)
    kps = np.zeros((B, G, K, 3), np.float32)
    for b in range(B):
        for g in range(3):
            x0, y0, x1, y1 = gt_boxes[b, g] / 4
            yy, xx = np.mgrid[0:H // 4, 0:W // 4] + 0.5
            cy, cx, ry, rx = (y0 + y1) / 2, (x0 + x1) / 2, (y1 - y0) / 2, (x1 - x0) / 2
            masks[b, g] = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1  # an ellipse in the box
            x0, y0, x1, y1 = gt_boxes[b, g]
            kps[b, g, :, 0] = rng.uniform(x0, x1, K)
            kps[b, g, :, 1] = rng.uniform(y0, y1, K)
            kps[b, g, :, 2] = rng.choice([0, 1, 2], K, p=[0.2, 0.3, 0.5])
    return {
        # image seed 5: no pre-activation of the heads' ReLUs lies within float32 rounding of 0 (checked
        # against a float64 run of the port); at such a kink either package may route its gradient either way
        "image": (np.random.RandomState(5).rand(B, H, W, 3) * 255).astype(np.float32),
        "image_size": np.array([[H, W], [112, 160]], np.int32),
        "gt_boxes": gt_boxes,
        "gt_classes": np.array([[3, 1, 3, 0], [0, 2, 4, 0]], np.int32),
        "gt_valid": np.array([[True] * 3 + [False]] * B),
        "gt_masks": masks,
        "gt_keypoints": kps,
    }


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def _scale(var):
    """tests/test_torch_rcnn.py's scaling: spread RPN logits and class
    scores, so that no near-tie can reorder them; small mask and heatmap
    logits."""
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
    # near detectron2's N(0, 0.001) mask predictor: logits O(1), not O(100)
    var["params"]["roi_heads"]["mask_head"]["predictor"]["kernel"] *= 0.01
    var["params"]["roi_heads"]["keypoint_head"]["score_lowres"]["kernel"] *= 0.1
    return var


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# --------------------------------------------------------------------- heads
def _head_pair(kind, P, C=24, N=6, seed=0):
    """A flax head and the port's on the same weights, and a seeded input."""
    if kind == "mask":
        fhead = jmask.MaskRCNNConvUpsampleHead(num_classes=5, num_conv=NUM_CONV, conv_dim=CONV_DIM)
        thead = mh.MaskRCNNConvUpsampleHead(C, 5, NUM_CONV, CONV_DIM)
    else:
        fhead = jkp.KRCNNConvDeconvUpsampleHead(num_keypoints=K, num_conv=NUM_CONV, conv_dim=CONV_DIM)
        thead = kp.KRCNNConvDeconvUpsampleHead(C, K, NUM_CONV, CONV_DIM)
    x = np.random.RandomState(seed).normal(0, 1, (N, P, P, C)).astype(np.float32)
    params = jax.tree_util.tree_map(np.asarray, fhead.init(jax.random.PRNGKey(seed), jnp.asarray(x))["params"])
    # biases are zero at init: give them values so that they are held too
    rng = np.random.RandomState(seed + 1)
    params = {m: {k: (v + rng.normal(0, 0.1, v.shape).astype(np.float32) if k == "bias" else v)
                  for k, v in leaves.items()} for m, leaves in params.items()}
    name = f"{kind if kind == 'mask' else 'keypoint'}_head"
    state = from_flax({"params": {"roi_heads": {name: params}}})
    thead.load_state_dict({k.split(".", 2)[2]: v for k, v in state.items()}, strict=True)
    want = np.asarray(jax.jit(fhead.apply)({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = thead(torch.from_numpy(x)).permute(0, 2, 3, 1).numpy()
    return got, want, params, thead


@pytest.mark.parametrize("kind", ["mask", "keypoint"])
@pytest.mark.parametrize("P", [7, 14])
def test_head_matches_flax(kind, P):
    got, want, *_ = _head_pair(kind, P)
    assert got.shape == want.shape == ((6, 2 * P, 2 * P, 5) if kind == "mask" else (6, 4 * P, 4 * P, K))
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)
    if kind == "keypoint":  # the upsample's edge rows and columns
        for sl in (np.s_[:, 0], np.s_[:, -1], np.s_[:, :, 0], np.s_[:, :, -1]):
            np.testing.assert_allclose(got[sl], want[sl], rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("kind", ["mask", "keypoint"])
def test_head_weights_round_trip(kind):
    _, _, params, thead = _head_pair(kind, 5)
    name = f"{kind if kind == 'mask' else 'keypoint'}_head"
    back = to_flax({f"roi_heads.{name}.{k}": v for k, v in thead.state_dict().items()})["params"]["roi_heads"][name]
    assert set(back) == set(params)
    for m, leaves in params.items():
        assert set(back[m]) == set(leaves)
        for k, v in leaves.items():
            np.testing.assert_array_equal(back[m][k], v)


# ----------------------------------------------------------------- functions
def _boxes(rng, n, size=64.0):
    xy = rng.uniform(-4, size - 8, (n, 2))
    wh = rng.uniform(2, 40, (n, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def test_crop_gt_masks_matches_jax():
    rng = np.random.RandomState(0)
    gt = rng.rand(3, 16, 24) > 0.5
    boxes = _boxes(rng, 9, 24.0)
    idx = rng.randint(0, 3, 9).astype(np.int32)
    want = jax.jit(jmask.crop_gt_masks, static_argnums=(1, 4))(jnp.asarray(gt), (16, 24), jnp.asarray(boxes),
                                                               jnp.asarray(idx), 28)
    got = mh.crop_gt_masks(torch.from_numpy(gt), torch.from_numpy(boxes), torch.from_numpy(idx), 28)
    # the sample positions (tens of pixels) round differently under XLA's fused multiply-adds: a float32 ulp
    # there (2e-6) moves a bilinear weight, times a step of at most 1 in each axis
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("classes", [5, 1])
def test_mask_loss_and_inference_match_jax(classes):
    rng = np.random.RandomState(1)
    S, M = 12, 28
    logits = rng.normal(0, 3, (S, M, M, classes)).astype(np.float32)
    crops = rng.rand(S, M, M).astype(np.float32)
    cls = rng.randint(0, 6, S).astype(np.int32)
    fg = (rng.rand(S) > 0.4) & (cls < 5)
    want = jax.jit(jmask.mask_rcnn_loss)(*map(jnp.asarray, (logits, crops, cls, fg)))
    t_logits = torch.from_numpy(logits).permute(0, 3, 1, 2)
    got = mh.mask_rcnn_loss(t_logits, torch.from_numpy(crops), torch.from_numpy(cls), torch.from_numpy(fg))
    assert float(got) == pytest.approx(float(want), rel=1e-6)
    want = jax.jit(jmask.mask_rcnn_inference)(jnp.asarray(logits), jnp.asarray(cls))
    got = mh.mask_rcnn_inference(t_logits, torch.from_numpy(cls))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


def test_paste_masks_matches_jax():
    rng = np.random.RandomState(2)
    masks = rng.rand(7, 28, 28).astype(np.float32)
    boxes = _boxes(rng, 7, 48.0)
    boxes[0] = [10.3, 5.7, 10.3, 30.1]  # zero width
    for threshold in (0.5, -1.0):
        want = np.asarray(jax.jit(jmask.paste_masks_in_image, static_argnums=(2, 3))(
            jnp.asarray(masks), jnp.asarray(boxes), (40, 56), threshold))
        got = mh.paste_masks_in_image(torch.from_numpy(masks), torch.from_numpy(boxes), (40, 56), threshold).numpy()
        if threshold >= 0:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def _keypoint_inputs(seed=3, S=10, M=56):
    rng = np.random.RandomState(seed)
    boxes = _boxes(rng, S)
    kps = np.zeros((S, K, 3), np.float32)
    kps[..., 0] = rng.uniform(boxes[:, 0:1] - 5, boxes[:, 2:3] + 5, (S, K))
    kps[..., 1] = rng.uniform(boxes[:, 1:2] - 5, boxes[:, 3:4] + 5, (S, K))
    kps[..., 2] = rng.choice([0, 1, 2], (S, K))
    kps[0, 0, :] = [boxes[0, 2], boxes[0, 3], 2]  # on the right and bottom edges: the last cell, counted
    kps[0, 1, :] = [boxes[0, 2], (boxes[0, 1] + boxes[0, 3]) / 2, 1]  # on the right edge
    kps[0, 2, :] = [(boxes[0, 0] + boxes[0, 2]) / 2, boxes[0, 3], 1]  # on the bottom edge
    kps[0, 3, :] = [boxes[0, 0], boxes[0, 1], 2]  # the top-left corner: the first cell
    logits = rng.normal(0, 2, (S, M, M, K)).astype(np.float32)
    fg = rng.rand(S) > 0.3
    return kps, boxes, logits, fg


def test_heatmap_targets_match_jax():
    kps, boxes, _, _ = _keypoint_inputs()
    want = jax.jit(jkp.keypoints_to_heatmap_targets, static_argnums=2)(jnp.asarray(kps), jnp.asarray(boxes), 56)
    got = kp.keypoints_to_heatmap_targets(torch.from_numpy(kps), torch.from_numpy(boxes), 56)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[0][0, :4].tolist() == [56 * 56 - 1, int(got[0][0, 1]), int(got[0][0, 2]), 0]
    assert got[0][0, 1] % 56 == 55 and got[0][0, 2] // 56 == 55 and bool(got[1][0, :4].all())
    assert not bool(got[1].all()) and bool(got[1].any())


def test_keypoint_loss_and_inference_match_jax():
    kps, boxes, logits, fg = _keypoint_inputs()
    t_logits = torch.from_numpy(logits).permute(0, 3, 1, 2)
    for normalizer in (None, 37.0):
        want = jax.jit(jkp.keypoint_rcnn_loss, static_argnums=4)(*map(jnp.asarray, (logits, kps, boxes, fg)),
                                                                normalizer)
        got = kp.keypoint_rcnn_loss(t_logits, *map(torch.from_numpy, (kps, boxes, fg)), normalizer)
        assert float(got) == pytest.approx(float(want), rel=1e-6)
    want = np.asarray(jax.jit(jkp.keypoint_rcnn_inference)(jnp.asarray(logits), jnp.asarray(boxes)))
    got = kp.keypoint_rcnn_inference(t_logits, torch.from_numpy(boxes)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


# ---------------------------------------------------------------- the model
@pytest.fixture(scope="module")
def jax_run():
    """JAX's variables, its losses and gradients of one training forward and
    its eval detections."""
    jmodel = jax_build_model(_narrow(jax_get_cfg()))
    batch = _batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    shapes = jax.eval_shape(functools.partial(jmodel.init, train=False), {"params": jax.random.PRNGKey(0)},
                            {k: jb[k] for k in ("image", "image_size")})
    var = jax.tree_util.tree_map(lambda v: np.array(v, np.float32),
                                 materialize_variables(shapes, seed=0, conv_init="he"))
    var = _scale(var)
    key = jax.random.PRNGKey(7)

    def loss_fn(params):
        losses = jmodel.apply({"params": params, "batch_stats": var["batch_stats"]}, jb, train=True,
                              rngs={"sampling": key, "dropout": key})
        return sum(losses.values()), losses

    (_, losses), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(var["params"])
    dets = jax.jit(lambda v, b: jmodel.apply(v, b, train=False))(var, {k: jb[k] for k in ("image", "image_size")})
    return var, {k: float(v) for k, v in losses.items()}, jax.tree_util.tree_map(np.asarray, grads), dets


def _port(var):
    model = build_model(_narrow(get_cfg()), device="cpu")
    model.load_state_dict(from_flax(var))
    return model


def test_losses_and_gradients_match_jax(jax_run):
    var, want, j_grads, _ = jax_run
    model = _port(var).train()
    losses = model(_batch(), torch.Generator().manual_seed(0))
    assert set(losses) == set(want) == {"loss_cls", "loss_box_reg", "loss_rpn_cls", "loss_rpn_loc", "loss_mask",
                                        "loss_keypoint"}
    for k, v in want.items():
        assert float(losses[k].detach()) == pytest.approx(v, rel=1e-5, abs=1e-7), k
    assert want["loss_mask"] > 0 and want["loss_keypoint"] > 0
    sum(losses.values()).backward()
    j_grad = from_flax({"params": j_grads})
    names = [n for n, _ in model.named_parameters()]
    assert any(".mask_head." in n for n in names) and any(".keypoint_head." in n for n in names)
    for name, p in model.named_parameters():
        assert p.grad is not None, name
        if name == "roi_heads.keypoint_head.score_lowres.bias":
            # 0 in exact arithmetic (a softmax over the upsampled cells ignores a constant): rounding in both
            np.testing.assert_allclose(p.grad.numpy(), j_grad[name].numpy(), rtol=0, atol=1e-6)
            continue
        assert _rel_l2(p.grad.numpy(), j_grad[name].numpy()) <= 1e-4, name
    assert float(model.roi_heads.mask_head.deconv.weight.grad.abs().sum()) > 0


def test_eval_masks_and_keypoints_match_jax(jax_run):
    var, _, _, dets = jax_run
    got = _port(var)({k: v for k, v in _batch().items() if k in ("image", "image_size")})
    want = [np.asarray(x) for x in dets[:4]]
    v = want[3]
    np.testing.assert_array_equal(got.valid.numpy(), v)
    assert v.sum() > 5
    np.testing.assert_array_equal(got.classes.numpy()[v], want[2][v])
    np.testing.assert_allclose(got.boxes.numpy()[v], want[0][v], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got.scores.numpy()[v], want[1][v], rtol=0, atol=1e-4)
    assert got.masks.shape == (B, 30, 28, 28) and got.masks.dtype == torch.float32
    # each package's float32 masks lie 0.9-2.0e-5 from a float64 run of the port (their boxes 2-4e-4 px)
    np.testing.assert_allclose(got.masks.numpy()[v], np.asarray(dets.masks)[v], rtol=0, atol=5e-5)
    assert got.keypoints.shape == (B, 30, K, 3)
    jk, gk = np.asarray(dets.keypoints)[v], got.keypoints.numpy()[v]
    np.testing.assert_allclose(gk[..., 2], jk[..., 2], rtol=0, atol=1e-5)
    # a heatmap whose two best cells tie within float32 rounding may take either: the point moves by one
    # cell of its box (a 56th), its score stays
    boxes = np.asarray(dets.boxes)[v]
    cell = np.stack([boxes[:, 2] - boxes[:, 0], boxes[:, 3] - boxes[:, 1]], -1)[:, None, :] / 56
    err = np.abs(gk[..., :2] - jk[..., :2])
    near = err <= 1e-3
    assert (near | (np.abs(err - cell) <= 1e-3)).all() and near.mean() > 0.99


def test_weights_round_trip_and_detectron2_layout(jax_run):
    """``to_flax`` gives back JAX's tree (the heads' bare modules and the
    flipped transposed kernels included), and a state dict under
    detectron2's names and shapes for both heads loads strictly."""
    var = jax_run[0]
    model = _port(var)
    back = dict(_leaves(to_flax(model.state_dict())["params"]))
    for path, want in _leaves(var["params"]):
        np.testing.assert_array_equal(back[path], want)
    d2 = {f"roi_heads.mask_head.mask_fcn{i + 1}.weight": (CONV_DIM, 64 if i == 0 else CONV_DIM, 3, 3)
          for i in range(NUM_CONV)}
    d2.update({f"roi_heads.keypoint_head.conv_fcn{i + 1}.weight": (CONV_DIM, 64 if i == 0 else CONV_DIM, 3, 3)
               for i in range(NUM_CONV)})
    d2.update({"roi_heads.mask_head.deconv.weight": (CONV_DIM, CONV_DIM, 2, 2),
               "roi_heads.mask_head.predictor.weight": (5, CONV_DIM, 1, 1),
               "roi_heads.keypoint_head.score_lowres.weight": (CONV_DIM, K, 4, 4)})
    d2.update({k.replace(".weight", ".bias"): (s[1] if "score_lowres" in k or "deconv" in k else s[0],)
               for k, s in list(d2.items())})
    state = {k: v for k, v in model.state_dict().items() if not k.startswith(("roi_heads.mask_head.",
                                                                           "roi_heads.keypoint_head."))}
    state.update({k: torch.zeros(s) for k, s in d2.items()})
    model.load_state_dict(state, strict=True)


def test_build_model_defaults_to_cuda():
    cfg = _narrow(get_cfg())
    if torch.cuda.is_available():
        model = build_model(cfg)
        assert model.roi_heads.mask_head.predictor.weight.is_cuda
    else:
        with pytest.raises(RuntimeError, match="no GPU was found"):
            build_model(cfg)
