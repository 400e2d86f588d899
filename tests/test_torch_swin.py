"""The Swin Transformer backbone and the Swin-FPN detector against the JAX
package on the CPU, on the same weights (``from_flax``).

- The window helpers, the relative position index and the shift mask: equal.
- ``WindowAttention`` (with a shift mask), ``SwinBlock`` (shifted and not, on
  a token grid that needs padding) and ``PatchMerging`` (odd H and W) against
  the flax modules, and a narrow ``SwinTransformer`` (embed 32, 2 blocks a
  stage, heads 1-2-4-8, window 7) on a 90x133 image: H is not a multiple of
  4 (flax's SAME patch embedding pads it), and every stage's token grid
  (23x34, 12x17, 6x9, 3x5) needs padding to the window. float32: outputs
  abs 1e-5 of the largest, gradients of the input and of every parameter
  rel L2 1e-4. bf16 (parameters and input cast, as JAX's AMP step and bf16
  serving cast them): outputs abs 3e-2 of the largest and at most 3 times
  JAX's own bf16 distance from its float32 outputs.
- A narrow Swin-FPN Faster R-CNN (that Swin, FPN 64 wide, 5 classes, B=2 on
  a 128x192 canvas, exhaustive sampling, POOLER_IMPL exact) through
  ``make_train_step`` and inference, with the tolerances of
  tests/test_torch_rcnn.py and tests/test_torch_train.py: losses rel 1e-5,
  the step's gradients of every trainable tensor rel L2 1e-3 (as
  tests/test_torch_train.py holds the R-50-FPN's: deep in the DCN backbone
  the float32 gradients of both packages are ill-conditioned, each as far
  from a float64 run of the same step as from the other), parameters after
  the step within 1e-3 of each tensor's update, detections equal in
  validity, class and proposal, boxes abs 1e-3 px, scores abs 1e-4.
- The weight-decay groups and the trainability of every parameter equal
  JAX's (``_wd_group_masks``, ``trainability_mask``) with the three decays
  set to three different values, and one optimizer step from zero gradients
  (the decays alone) equal to optax's: updates rel L2 1e-3.
- The weights round-trip through ``to_flax``; a state dict in the public
  Swin names loads strictly; every SWIN_SIZE builds with JAX's shapes.
- From zero biases the canvas padding blows the gradients up (every padded
  token is 0, each LayerNorm at variance 0); the seeded biases of
  ``chip_smoke.backbone_init`` do not (the port alone: JAX's math is the
  same).

The narrow Swin is registered as SWIN_SIZE "narrow" in both packages'
``SWIN_CONFIGS`` for this module.
"""
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from lvc_tpu.config import get_cfg as jax_get_cfg
from lvc_tpu.engine.train_loop import TrainState
from lvc_tpu.engine.train_loop import make_train_step as jax_make_train_step
from lvc_tpu.modeling.backbone import swin as jswin
from lvc_tpu.modeling.meta_arch.build import build_model as jax_build_model
from lvc_tpu.solver.build import _wd_group_masks, trainability_mask as jax_trainability_mask
from lvc_tpu.solver.build import build_optimizer as jax_build_optimizer
from lvc_tpu.utils.init import materialize_variables

from lvc_tpu_torch.checkpoint.convert import from_flax, to_flax
from lvc_tpu_torch.config import get_cfg
from lvc_tpu_torch.engine.train_loop import make_train_step
from lvc_tpu_torch.modeling.backbone import swin
from lvc_tpu_torch.modeling.meta_arch.build import build_backbone, build_model
from lvc_tpu_torch.solver.build import build_lr_schedule, build_optimizer, trainability_mask, wd_groups

NARROW = dict(embed_dim=32, depths=(2, 2, 2, 2), num_heads=(1, 2, 4, 8))
for _configs in (jswin.SWIN_CONFIGS, swin.SWIN_CONFIGS):
    _configs.setdefault("narrow", NARROW)

B, H, W, G = 2, 128, 192, 4
SWIN_OPTS = ["MODEL.BACKBONE.NAME", "build_swin_transformer_fpn_backbone", "MODEL.SWIN.SWIN_SIZE", "narrow"]
DETECTOR = [
    "MODEL.FPN.OUT_CHANNELS", 64, "MODEL.ROI_HEADS.NUM_CLASSES", 5, "MODEL.ROI_BOX_HEAD.FC_DIM", 128,
    "MODEL.ROI_HEADS.POOLER_IMPL", "exact", "MODEL.RPN.PRE_NMS_TOPK_TRAIN", 200, "MODEL.RPN.POST_NMS_TOPK_TRAIN", 100,
    "MODEL.RPN.BATCH_SIZE_PER_IMAGE", 8192, "MODEL.RPN.POSITIVE_FRACTION", 0.999,
    "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", 128, "MODEL.ROI_HEADS.POSITIVE_FRACTION", 0.999,
    "MODEL.RPN.PRE_NMS_TOPK_TEST", 200, "MODEL.RPN.POST_NMS_TOPK_TEST", 100, "TEST.DETECTIONS_PER_IMAGE", 20,
    "MODEL.ROI_HEADS.SCORE_THRESH_TEST", 0.01, "SOLVER.BASE_LR", 0.01, "SOLVER.WARMUP_ITERS", 0,
]


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, path + (k,))
        else:
            yield path + (k,), v


def detector_cfg(get, opts):
    cfg = get()
    cfg.merge_from_file("configs/Base-RCNN-FPN.yaml")
    cfg.merge_from_list([list(o) if isinstance(o, tuple) else o for o in opts] + DETECTOR)
    return cfg


def detector_batch():
    rng = np.random.RandomState(3)
    gt = np.zeros((B, G, 4), np.float32)
    gt[0, :3] = [[20, 30, 90, 100], [60, 10, 150, 70], [5, 70, 40, 120]]
    gt[1, :3] = [[100, 20, 180, 110], [10, 10, 60, 50], [70, 60, 130, 100]]
    return {
        "image": (rng.rand(B, H, W, 3) * 255).astype(np.float32),
        "image_size": np.array([[H, W], [112, 160]], np.int32),
        "gt_boxes": gt,
        "gt_classes": np.array([[3, 1, 4, 0], [0, 2, 3, 0]], np.int32),
        "gt_valid": np.array([[True] * 3 + [False]] * B),
    }


def detector_variables(jmodel, rescale=None):
    """JAX's he-init weights with the RPN and box predictor scaled as in
    tests/test_torch_train.py (well-spread logits and deltas: no near-ties
    for 1e-6 framework differences to flip in NMS); ``rescale(var)`` may
    adjust the backbone."""
    batch = {k: jnp.asarray(v) for k, v in detector_batch().items() if k in ("image", "image_size")}
    shapes = jax.eval_shape(functools.partial(jmodel.init, train=False), {"params": jax.random.PRNGKey(0)}, batch)
    var = jax.tree_util.tree_map(lambda v: np.array(v, np.float32), materialize_variables(shapes, seed=0))
    if rescale is not None:
        rescale(var)
    rpn = var["params"]["proposal_generator"]["rpn_head"]
    rpn["conv"]["conv"]["kernel"] *= 0.1
    rpn["objectness_logits"]["conv"]["kernel"] *= 0.1
    rpn["anchor_deltas"]["conv"]["kernel"] *= 0.01
    head = var["params"]["roi_heads"]["box_predictor"]
    head["cls_score"]["kernel"] *= 0.03
    head["bbox_pred"]["kernel"] *= 0.3
    return var


def _keep_grads(tx):
    """``tx`` whose state also holds the last gradients it was given."""

    def init(params):
        return tx.init(params), jax.tree_util.tree_map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        updates, inner = tx.update(grads, state[0], params)
        return updates, (inner, grads)

    return optax.GradientTransformation(init, update)


@functools.lru_cache(maxsize=None)
def jax_detector_run(opts, rescale=None):
    """(variables, one make_train_step step's metrics, gradients and updated
    parameters, the eval detections from the starting weights)."""
    cfg = detector_cfg(jax_get_cfg, opts)
    jmodel = jax_build_model(cfg)
    var = detector_variables(jmodel, rescale)
    tx = _keep_grads(jax_build_optimizer(cfg, var["params"]))
    state = jax.jit(lambda v: TrainState.create(v, tx))(var)  # one compile, not one a leaf shape
    batch = {k: jnp.asarray(v) for k, v in detector_batch().items()}
    state, metrics = jax.jit(jax_make_train_step(jmodel, tx))(state, batch, jax.random.PRNGKey(7))
    grads = jax.tree_util.tree_map(np.asarray, state.opt_state[1])
    params = jax.tree_util.tree_map(np.asarray, state.params)
    eval_batch = {k: batch[k] for k in ("image", "image_size")}
    dets = jax.jit(lambda v, b: jmodel.apply(v, b, train=False))(var, eval_batch)
    return var, {k: float(v) for k, v in metrics.items()}, grads, params, jax.tree_util.tree_map(np.asarray, dets)


def check_detector(opts, rescale=None, min_valid=10):
    """The port's ``make_train_step`` step and eval forward against JAX's,
    from the same weights."""
    var, j_metrics, j_grads, j_params, j_dets = jax_detector_run(
        tuple(tuple(o) if isinstance(o, list) else o for o in opts), rescale)
    cfg = detector_cfg(get_cfg, opts)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(from_flax(var))
    dets = model(detector_batch())
    v = j_dets.valid
    assert v.sum() >= min_valid
    np.testing.assert_array_equal(dets.valid.numpy(), v)
    np.testing.assert_array_equal(dets.classes.numpy()[v], j_dets.classes[v])
    np.testing.assert_array_equal(dets.proposal_idx.numpy()[v], j_dets.proposal_idx[v])
    np.testing.assert_allclose(dets.boxes.numpy()[v], j_dets.boxes[v], rtol=0, atol=1e-3)
    np.testing.assert_allclose(dets.scores.numpy()[v], j_dets.scores[v], rtol=0, atol=1e-4)

    model.train()
    opt = build_optimizer(cfg, model)
    metrics = make_train_step(model, opt, build_lr_schedule(cfg, opt))(detector_batch(), torch.Generator())
    assert set(metrics) == set(j_metrics)
    for k, want in j_metrics.items():
        assert float(metrics[k]) == pytest.approx(want, rel=1e-5, abs=1e-7), k
    assert j_metrics["loss_box_reg"] > 0 and j_metrics["loss_rpn_loc"] > 0
    j_grad = from_flax({"params": j_grads})
    grads = {n: p.grad for n, p in model.named_parameters() if p.requires_grad}
    assert len(grads) > 50
    for name, g in grads.items():
        assert rel_l2(g.numpy(), j_grad[name].numpy()) <= 1e-3, name
    got = dict(leaves(to_flax(model.state_dict())["params"]))
    start = dict(leaves(var["params"]))
    for path, want in leaves(j_params):
        update = np.linalg.norm(np.asarray(want, np.float64) - start[path])
        err = np.linalg.norm(np.asarray(got[path], np.float64) - want)
        assert err <= 1e-3 * update + 1e-12, (path, err, update)
    return model


def _flax_grads(module, variables, inputs, weights):
    """JAX's output and the gradients of sum(out * weights) for the
    parameters and the inputs."""
    def f(params, *xs):
        out = module.apply({"params": params}, *xs)
        return jnp.sum(out * weights), out

    (_, out), grads = jax.jit(jax.value_and_grad(f, argnums=tuple(range(len(inputs) + 1)), has_aux=True))(
        variables["params"], *inputs)
    return np.asarray(out), grads


def _check_piece(jmod, tmod, path, x_nhwc, mask=None):
    """Forward abs 1e-5 of the largest, and the gradients of the input and
    every parameter rel L2 1e-4; the flax variables are carried by
    ``from_flax`` as the module at ``path`` of a Swin bottom-up."""
    rng = np.random.RandomState(1)
    inputs = (jnp.asarray(x_nhwc),) if mask is None else (jnp.asarray(x_nhwc), jnp.asarray(mask))
    var = jax.tree_util.tree_map(np.asarray, jax.jit(jmod.init)(jax.random.PRNGKey(0), *inputs))
    wts = rng.randn(*jax.eval_shape(lambda v: jmod.apply(v, *inputs), var).shape).astype(np.float32)
    j_out, grads = _flax_grads(jmod, var, inputs, jnp.asarray(wts))

    def port(tree):
        for name in reversed(path):
            tree = {name: tree}
        prefix = "bottom_up." + ".".join(path) + "."
        return {k[len(prefix):]: v for k, v in from_flax({"params": {"bottom_up": tree}}).items()}

    tmod.load_state_dict(port(var["params"]), strict=True)
    tx = torch.from_numpy(x_nhwc).requires_grad_(True)
    out = tmod(tx) if mask is None else tmod(tx, torch.from_numpy(mask))
    (out * torch.from_numpy(wts)).sum().backward()
    assert np.abs(out.detach().numpy() - j_out).max() <= 1e-5 * np.abs(j_out).max()
    assert rel_l2(tx.grad.numpy(), grads[1]) <= 1e-4
    g = port(jax.tree_util.tree_map(np.asarray, grads[0]))
    for name, p in tmod.named_parameters():
        assert rel_l2(p.grad.numpy(), g[name].numpy()) <= 1e-4, name


def test_window_helpers_match_jax():
    rng = np.random.RandomState(0)
    x = rng.rand(2, 14, 21, 8).astype(np.float32)
    w = swin.window_partition(torch.from_numpy(x), 7)
    np.testing.assert_array_equal(w.numpy(), np.asarray(jswin.window_partition(jnp.asarray(x), 7)))
    np.testing.assert_array_equal(swin.window_reverse(w, 7, 14, 21).numpy(), x)
    np.testing.assert_array_equal(swin.relative_position_index(7), jswin.relative_position_index(7))
    for hp, wp in ((14, 21), (28, 35)):
        block = jswin.SwinBlock(8, 2, 7, shift=3)
        np.testing.assert_array_equal(swin.shift_mask(hp, wp, 7, 3), np.asarray(block._attn_mask(hp, wp)))


@pytest.mark.parametrize("piece", ["attention", "block", "shifted_block", "merging"])
def test_swin_pieces_match_jax(piece):
    rng = np.random.RandomState(0)
    if piece == "attention":
        x = rng.randn(6, 49, 16).astype(np.float32)
        mask = swin.shift_mask(14, 21, 7, 3)
        _check_piece(jswin.WindowAttention(16, 2, 7), swin.WindowAttention(16, 2, 7), ("layers.0.blocks.1", "attn"),
                     x, mask)
    elif piece == "merging":
        x = rng.randn(2, 13, 9, 16).astype(np.float32)
        _check_piece(jswin.PatchMerging(16), swin.PatchMerging(16), ("layers.0.downsample",), x)
    else:
        shift = 3 if piece == "shifted_block" else 0
        x = rng.randn(2, 12, 17, 16).astype(np.float32)
        _check_piece(jswin.SwinBlock(16, 2, 7, shift=shift), swin.SwinBlock(16, 2, 7, shift), ("layers.0.blocks.1",),
                     x)


@functools.lru_cache(maxsize=None)
def _transformer():
    jm = jswin.SwinTransformer(window_size=7, **NARROW)
    x = np.random.RandomState(0).randn(2, 3, 90, 133).astype(np.float32)
    xj = jnp.asarray(x.transpose(0, 2, 3, 1))
    var = jax.tree_util.tree_map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(0), xj))
    return jm, var, x


def _port_transformer(var):
    m = swin.SwinTransformer(**NARROW)
    sd = from_flax({"params": {"bottom_up": var["params"]}})
    m.load_state_dict({k[len("bottom_up."):]: v for k, v in sd.items()}, strict=True)
    return m


@functools.lru_cache(maxsize=None)
def _transformer_grads():
    """JAX's float32 outputs of the narrow Swin, the output weights, and the
    gradients of sum(out * weights) for the parameters and the input."""
    jm, var, x = _transformer()
    xj = jnp.asarray(x.transpose(0, 2, 3, 1))
    rng = np.random.RandomState(2)
    shapes = jax.eval_shape(lambda v: jm.apply(v, xj), var)
    wts = {k: jnp.asarray(rng.randn(*s.shape).astype(np.float32)) for k, s in shapes.items()}
    assert [tuple(s.shape[1:3]) for s in shapes.values()] == [(23, 34), (12, 17), (6, 9), (3, 5)]

    def f(params, x):
        out = jm.apply({"params": params}, x)
        return sum(jnp.sum(out[k] * wts[k]) for k in out), out

    (_, j_out), (j_gp, j_gx) = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(var["params"], xj)
    return j_out, wts, j_gp, j_gx


def test_swin_transformer_matches_jax():
    jm, var, x = _transformer()
    j_out, wts, j_gp, j_gx = _transformer_grads()
    m = _port_transformer(var)
    tx = torch.from_numpy(x).requires_grad_(True)
    out = m(tx)
    sum((out[k] * torch.from_numpy(np.asarray(wts[k])).permute(0, 3, 1, 2)).sum() for k in out).backward()
    assert set(out) == set(j_out)
    for k, want in j_out.items():
        want = np.asarray(want).transpose(0, 3, 1, 2)
        assert np.abs(out[k].detach().numpy() - want).max() <= 1e-5 * np.abs(want).max(), k
    assert rel_l2(tx.grad.numpy().transpose(0, 2, 3, 1), j_gx) <= 1e-4
    g = from_flax({"params": {"bottom_up": jax.tree_util.tree_map(np.asarray, j_gp)}})
    for name, p in m.named_parameters():
        assert rel_l2(p.grad.numpy(), g[f"bottom_up.{name}"].numpy()) <= 1e-4, name


def test_swin_transformer_bf16_matches_jax():
    jm, var, x = _transformer()
    xj = jnp.asarray(x.transpose(0, 2, 3, 1))
    vb = jax.tree_util.tree_map(lambda v: jnp.asarray(v, jnp.bfloat16), var)
    j_out, j_f32 = jax.jit(jm.apply)(vb, xj.astype(jnp.bfloat16)), _transformer_grads()[0]
    out = _port_transformer(var)(torch.from_numpy(x).bfloat16())
    for k, want in j_out.items():
        assert out[k].dtype == torch.bfloat16
        want = np.asarray(want.astype(jnp.float32)).transpose(0, 3, 1, 2)
        own = np.abs(want - np.asarray(j_f32[k]).transpose(0, 3, 1, 2)).max()  # JAX's own bf16 rounding
        err = np.abs(out[k].float().detach().numpy() - want).max()
        assert err <= 3e-2 * np.abs(want).max() and err <= 3 * own, k


def test_swin_fpn_detector_matches_jax():
    check_detector(SWIN_OPTS)


DECAYS = ["SOLVER.WEIGHT_DECAY", 1e-2, "SOLVER.WEIGHT_DECAY_BIAS", 3e-3, "SOLVER.WEIGHT_DECAY_NORM", 7e-4,
          "SOLVER.MOMENTUM", 0.9, "SOLVER.WARMUP_ITERS", 0, "SOLVER.BASE_LR", 1.0]


def check_wd_groups(opts, size=(64, 64), base="configs/Base-RCNN-FPN.yaml"):
    """The port's weight-decay group and trainability of every parameter
    against JAX's ``_wd_group_masks`` and ``trainability_mask`` on the
    model ``opts`` builds on ``base`` (a yaml, or None for the bare
    defaults), with the three decays set
    to three different values; then one step from zero gradients (the
    decays alone, at BASE_LR 1) against optax's: each parameter's update
    rel L2 1e-3 (the float32 rounding of the parameter itself is 1e-4 of
    the smallest decay's update), frozen ones unmoved. Returns the port's
    groups."""
    jcfg, cfg = jax_get_cfg(), get_cfg()
    for c in (jcfg, cfg):
        if base:
            c.merge_from_file(base)
        c.merge_from_list(list(opts) + DECAYS)
    jmodel = jax_build_model(jcfg)
    batch = {"image": jnp.zeros((1,) + size + (3,)), "image_size": jnp.asarray([size], jnp.int32)}
    shapes = jax.eval_shape(functools.partial(jmodel.init, train=False), {"params": jax.random.PRNGKey(0)}, batch)
    var = jax.tree_util.tree_map(lambda v: np.array(v, np.float32), materialize_variables(shapes, seed=0))
    params = var["params"]
    bias, norm, _ = _wd_group_masks(params)
    code = jax.tree_util.tree_map(lambda b, n, p: np.full(p.shape, 1.0 if b else 2.0 if n else 0.0, np.float32),
                                  bias, norm, params)
    want_group = {k: ("other", "bias", "norm")[int(v.flatten()[0])] for k, v in from_flax({"params": code}).items()}
    mask = jax.tree_util.tree_map(lambda t, p: np.full(p.shape, float(t), np.float32),
                                  jax_trainability_mask(params, jcfg), params)
    want_train = {k: bool(v.flatten()[0]) for k, v in from_flax({"params": mask}).items()}

    model = build_model(cfg, device="cpu")
    start = from_flax(var)
    model.load_state_dict(start)
    groups = wd_groups(model)
    assert groups == {k: want_group[k] for k in groups}
    assert trainability_mask(model, cfg) == {k: want_train[k] for k in groups}

    j_tx = jax_build_optimizer(jcfg, params)

    @jax.jit
    def step(p):
        upd, _ = j_tx.update(jax.tree_util.tree_map(jnp.zeros_like, p), j_tx.init(p), p)
        return optax.apply_updates(p, upd)

    j_new = from_flax({"params": jax.tree_util.tree_map(np.asarray, step(params))})
    opt = build_optimizer(cfg, model)
    for p in model.parameters():
        p.grad = torch.zeros_like(p) if p.requires_grad else None
    opt.step()
    for name, p in model.named_parameters():
        want, got = (j_new[name] - start[name]).numpy(), (p.detach() - start[name]).numpy()
        if not np.any(want):
            assert not np.any(got), name
        else:
            assert rel_l2(got, want) <= 1e-3, name
        assert np.any(want) == (want_train[name] and bool(np.any(start[name].numpy()))), name
    return groups


def test_swin_weight_decay_groups_and_trainability_match_jax():
    groups = check_wd_groups(SWIN_OPTS + ["MODEL.BACKBONE.FREEZE_AT", 2, "MODEL.ROI_HEADS.FREEZE_BBOX_PRED", True])
    assert groups["backbone.bottom_up.patch_embed.norm.weight"] == "other"
    assert groups["backbone.bottom_up.layers.0.downsample.norm.bias"] == "bias"
    assert groups["backbone.bottom_up.norm2.weight"] == "other"


def test_swin_weights_round_trip_and_public_names_load():
    var = _transformer()[1]
    m = _port_transformer(var)
    back = to_flax({f"backbone.bottom_up.{k}": v for k, v in m.state_dict().items()})
    flat = dict(leaves(back["params"]["backbone"]["bottom_up"]))
    want = dict(leaves(var["params"]))
    assert set(flat) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(flat[k], v)
    public = {"patch_embed.proj.weight", "patch_embed.proj.bias", "patch_embed.norm.weight", "norm3.bias",
              "layers.0.blocks.1.attn.relative_position_bias_table", "layers.0.blocks.1.attn.qkv.weight",
              "layers.2.blocks.0.mlp.fc2.bias", "layers.1.downsample.reduction.weight",
              "layers.1.downsample.norm.weight", "layers.3.blocks.1.norm2.weight"}
    sd = m.state_dict()
    assert public <= set(sd) and not any("relative_position_index" in k for k in sd)
    fresh = swin.SwinTransformer(**NARROW)
    fresh.load_state_dict({k: v.clone() for k, v in sd.items()}, strict=True)


@pytest.mark.parametrize("size", ["tiny", "small", "base"])
def test_every_swin_size_builds_with_jax_shapes(size):
    cfg, jcfg = get_cfg(), jax_get_cfg()
    for c in (cfg, jcfg):
        c.merge_from_file("configs/Base-RCNN-FPN.yaml")
        c.merge_from_list(["MODEL.BACKBONE.NAME", "build_swin_transformer_fpn_backbone", "MODEL.SWIN.SWIN_SIZE", size])
    backbone, strides, channels = build_backbone(cfg)
    assert strides == {"p2": 4, "p3": 8, "p4": 16, "p5": 32, "p6": 64}
    assert set(channels.values()) == {256}
    jb = jswin.build_swin_fpn_backbone(jcfg)
    shapes = jax.eval_shape(lambda: jb.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes["params"]["bottom_up"])
    want = {k: tuple(v.shape) for k, v in from_flax({"params": {"bottom_up": zeros}}).items()}
    got = {k: tuple(v.shape) for k, v in backbone.bottom_up.state_dict(prefix="bottom_up.").items()}
    assert got == want


def test_unknown_backbone_raises():
    cfg = get_cfg()
    cfg.merge_from_file("configs/Base-RCNN-FPN.yaml")
    cfg.MODEL.BACKBONE.NAME = "build_unknown_backbone"
    with pytest.raises(ValueError, match="Unknown backbone"):
        build_backbone(cfg)


def test_zero_biases_blow_up_on_the_padding():
    """The canvas padding is 0 after normalising (as in JAX), so from zero
    biases every padded token stays 0 through the Swin and each LayerNorm
    sits at variance 0, where its backward scales by rsqrt(eps): the patch
    embedding's bias gradient is over 1e4 times larger on a padded canvas
    than on an unpadded one. With the seeded biases of
    ``chip_smoke.backbone_init`` (as trained weights have them) it stays
    within 1e2 of it."""
    import chip_smoke
    from lvc_tpu_torch.utils.init import damped_init

    def bias_grad(init, padded):
        model = init(build_model(detector_cfg(get_cfg, SWIN_OPTS), device="cpu")).train()
        batch = detector_batch()
        if not padded:
            batch["image_size"][1] = batch["image_size"][0]
        losses = model(batch, torch.Generator().manual_seed(0))
        sum(losses.values()).backward()
        return float(model.backbone.bottom_up.patch_embed.proj.bias.grad.abs().max())

    zero = lambda m: damped_init(m, seed=0)  # noqa: E731
    seeded = lambda m: chip_smoke.backbone_init("swin", m)  # noqa: E731
    assert bias_grad(zero, True) > 1e4 * bias_grad(zero, False)
    assert bias_grad(seeded, True) < 1e2 * bias_grad(seeded, False)
