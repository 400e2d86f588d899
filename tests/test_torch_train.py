"""The port's training slice against the JAX package on the CPU.

A narrow R-50-FPN (RES2_OUT_CHANNELS 64, WIDTH_PER_GROUP 16, FPN 64 wide,
5 classes) on a B=2 128x192 canvas with 3 valid gt boxes per image (4 gt
slots), float32, POOLER_IMPL=exact on both sides (both pools are
differentiable in boxes and features; an interpret-mode pallas_train step is
too slow here, so tests/test_torch_train_pool.py holds that pool at module
level and chip_smoke.py holds it in the whole step, card against CPU).
Sampling is exhaustive (RPN BATCH_SIZE_PER_IMAGE 8192 >= the 6138 anchors,
ROI BATCH_SIZE_PER_IMAGE 128 >= POST_NMS_TOPK_TRAIN + G, POSITIVE_FRACTION
0.999), so torch's and JAX's generators pick the same sets and the losses,
which are sums, agree up to rounding. The JAX weights are carried over by
``from_flax`` and scaled as in tests/test_torch_rcnn.py, so the step-1
proposals match slot for slot.

Tolerances: losses of each of three ``make_train_step`` steps to rel 1e-4;
step-1 gradients of every trainable tensor to rel L2 1e-3; parameters after
3 steps (through ``to_flax``) within 1e-3 of each tensor's update norm
(frozen tensors exactly equal). The proposals match at every step here, so
steps 2 and 3 are held as tightly as step 1. One AMP step against JAX's AMP
step: losses rel 5e-2 / abs 5e-3 and update cosine > 0.98, as
tests/test_mixed_precision.py holds JAX's AMP against its float32. REMAT on
and off give equal gradients (rel L2 1e-5: the recomputed blocks' backward
sums their gradient contributions in another float32 order, measured up to
1.0e-6).

The JAX side is computed once per module (one jitted step function, with an
optimizer wrapper that keeps each step's gradients in the optimizer state).
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
from lvc_tpu.modeling.meta_arch.build import build_model as jax_build_model
from lvc_tpu.solver.build import build_optimizer as jax_build_optimizer
from lvc_tpu.utils.init import materialize_variables

from lvc_tpu_torch.checkpoint.convert import from_flax, to_flax
from lvc_tpu_torch.config import get_cfg
from lvc_tpu_torch.engine.train_loop import make_train_step
from lvc_tpu_torch.modeling.meta_arch.build import build_model
from lvc_tpu_torch.solver.build import build_lr_schedule, build_optimizer

B, H, W, G = 2, 128, 192, 4
STEPS = 3


def _narrow(cfg):
    cfg.merge_from_file("configs/Base-RCNN-FPN.yaml")
    cfg.MODEL.RESNETS.DEPTH = 50
    cfg.MODEL.RESNETS.RES2_OUT_CHANNELS = 64
    cfg.MODEL.RESNETS.WIDTH_PER_GROUP = 16
    cfg.MODEL.FPN.OUT_CHANNELS = 64
    cfg.MODEL.ROI_HEADS.NUM_CLASSES = 5
    cfg.MODEL.ROI_BOX_HEAD.FC_DIM = 128
    cfg.MODEL.ROI_HEADS.POOLER_IMPL = "exact"
    cfg.MODEL.RPN.PRE_NMS_TOPK_TRAIN = 200
    cfg.MODEL.RPN.POST_NMS_TOPK_TRAIN = 100
    cfg.MODEL.RPN.BATCH_SIZE_PER_IMAGE = 8192
    cfg.MODEL.RPN.POSITIVE_FRACTION = 0.999
    cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE = 128
    cfg.MODEL.ROI_HEADS.POSITIVE_FRACTION = 0.999
    cfg.SOLVER.BASE_LR = 0.01
    cfg.SOLVER.WARMUP_ITERS = 2
    return cfg


def _batch():
    rng = np.random.RandomState(3)
    gt_boxes = np.zeros((B, G, 4), np.float32)
    gt_boxes[0, :3] = [[20, 30, 90, 100], [60, 10, 150, 70], [5, 70, 40, 120]]
    gt_boxes[1, :3] = [[100, 20, 180, 110], [10, 10, 60, 50], [70, 60, 130, 100]]
    return {
        "image": (rng.rand(B, H, W, 3) * 255).astype(np.float32),
        "image_size": np.array([[H, W], [112, 160]], np.int32),
        "gt_boxes": gt_boxes,
        "gt_classes": np.array([[3, 1, 4, 0], [0, 2, 3, 0]], np.int32),
        "gt_valid": np.array([[True] * 3 + [False]] * B),
    }


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def _variables(model):
    batch = {k: jnp.asarray(v) for k, v in _batch().items() if k in ("image", "image_size")}
    shapes = jax.eval_shape(
        functools.partial(model.init, train=False), {"params": jax.random.PRNGKey(0)}, batch
    )
    var = materialize_variables(shapes, seed=0, conv_init="he")
    # the scaling of tests/test_torch_rcnn.py: well-spread RPN logits and
    # deltas, so no near-ties for 1e-6 framework differences to flip in NMS
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


def _keep_grads(tx):
    """``tx`` whose state also holds the last gradients it was given."""

    def init(params):
        return tx.init(params), jax.tree_util.tree_map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        updates, inner = tx.update(grads, state[0], params)
        return updates, (inner, grads)

    return optax.GradientTransformation(init, update)


def _jax_steps(cfg, variables, mixed_precision, steps):
    model = jax_build_model(cfg)
    tx = _keep_grads(jax_build_optimizer(cfg, variables["params"]))
    state = TrainState.create(jax.tree_util.tree_map(jnp.asarray, variables), tx)
    step = jax.jit(jax_make_train_step(model, tx, mixed_precision=mixed_precision))
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}
    metrics, grads = [], []
    for i in range(steps):
        state, m = step(state, batch, jax.random.PRNGKey(7))
        metrics.append({k: float(v) for k, v in m.items()})
        grads.append(jax.tree_util.tree_map(np.asarray, state.opt_state[1]))
    params = jax.tree_util.tree_map(np.asarray, state.params)
    return metrics, grads, params


@pytest.fixture(scope="module")
def reference():
    cfg = _narrow(jax_get_cfg())
    variables = _variables(jax_build_model(cfg))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    f32 = _jax_steps(cfg, variables, False, STEPS)
    amp = _jax_steps(cfg, variables, True, 1)
    return variables, f32, amp


def _port(variables, remat=True):
    cfg = _narrow(get_cfg())
    cfg.MODEL.BACKBONE.REMAT = remat
    model = build_model(cfg, device="cpu")
    model.load_state_dict(from_flax(variables))
    model.train()
    opt = build_optimizer(cfg, model)
    return model, opt, build_lr_schedule(cfg, opt)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_train_steps_match_jax(reference):
    variables, (j_metrics, j_grads, j_params), _ = reference
    model, opt, sched = _port(variables)
    step = make_train_step(model, opt, sched)
    gen = torch.Generator().manual_seed(0)
    metrics = []
    for i in range(STEPS):
        metrics.append({k: float(v) for k, v in step(_batch(), gen).items()})
        if i == 0:
            grads = {n: p.grad.clone() for n, p in model.named_parameters() if p.requires_grad}
    for mine, ref in zip(metrics, j_metrics):
        assert set(mine) == set(ref)
        for k in ref:
            assert mine[k] == pytest.approx(ref[k], rel=1e-4), (k, mine[k], ref[k])
    assert j_metrics[0]["loss_box_reg"] > 0 and j_metrics[0]["loss_rpn_loc"] > 0

    # step-1 gradients, tensor by tensor, in the port's layout
    j_grad = from_flax({"params": j_grads[0]})
    trainable = set(grads)
    assert len(trainable) > 50
    for name, g in grads.items():
        assert _rel_l2(g.numpy(), j_grad[name].numpy()) <= 1e-3, name
    # frozen: the stem and res2 (FREEZE_AT 2) got no gradient and no update
    frozen = [n for n, p in model.named_parameters() if not p.requires_grad]
    assert frozen and all(".stem." in n or ".res2." in n for n in frozen)

    # parameters after the steps, in the JAX layout
    got = dict(_leaves(to_flax(model.state_dict())["params"]))
    start = dict(_leaves(variables["params"]))
    for path, want in _leaves(j_params):
        update = np.linalg.norm(np.asarray(want, np.float64) - start[path])
        err = np.linalg.norm(np.asarray(got[path], np.float64) - want)
        assert err <= 1e-3 * update, (path, err, update)


def test_amp_step_matches_jax_amp(reference):
    variables, _, (j_metrics, _, j_params) = reference
    model, opt, sched = _port(variables)
    m = make_train_step(model, opt, sched, mixed_precision=True)(
        _batch(), torch.Generator().manual_seed(0)
    )
    step_metrics = {k: float(v) for k, v in m.items()}
    for k, ref in j_metrics[0].items():
        assert step_metrics[k] == pytest.approx(ref, rel=5e-2, abs=5e-3), (k, step_metrics[k], ref)
    assert model.compute_dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in model.parameters())
    got = dict(_leaves(to_flax(model.state_dict())["params"]))
    start = dict(_leaves(variables["params"]))
    upd_t, upd_j = [], []
    for path, want in _leaves(j_params):
        upd_j.append((np.asarray(want, np.float64) - start[path]).ravel())
        upd_t.append((np.asarray(got[path], np.float64) - start[path]).ravel())
    a, b = np.concatenate(upd_t), np.concatenate(upd_j)
    cos = float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))
    assert cos > 0.98, cos


def test_remat_gives_equal_grads(reference):
    variables = reference[0]
    grads = []
    for remat in (True, False):
        model, _, _ = _port(variables, remat=remat)
        losses = model(_batch(), generator=torch.Generator().manual_seed(0))
        sum(losses.values()).backward()
        grads.append({n: p.grad for n, p in model.named_parameters() if p.requires_grad})
    for name, g in grads[0].items():
        assert _rel_l2(g.numpy(), grads[1][name].numpy()) <= 1e-5, name


def test_non_finite_loss_raises(reference):
    variables = reference[0]
    model, opt, sched = _port(variables)
    with torch.no_grad():
        model.roi_heads.box_predictor.cls_score.bias[0] = float("nan")
    with pytest.raises(FloatingPointError, match="infinite or NaN"):
        make_train_step(model, opt, sched)(_batch(), torch.Generator().manual_seed(0))
