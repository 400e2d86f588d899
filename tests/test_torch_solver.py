"""The port's solver against the JAX package's (optax) on the CPU.

- Both LR schedules equal JAX's at count 0, mid-warmup and around each
  milestone (rel 1e-6, or 4 float32 ulps of BASE_LR where that is larger:
  JAX evaluates the schedule in float32, and near the cosine's end
  ``1 + cos`` cancels), and the ``LambdaLR`` runs step ``count`` at the JAX
  schedule's value for ``count`` (optax's ``scale_by_learning_rate`` uses the
  count before the update, 0 for the first).
- Five ``build_optimizer`` steps on a small parameter tree (a frozen stem and
  res2, a trainable res3, an RPN conv, box head fcs; weights and biases)
  against optax, to 1e-6 per element: the three weight-decay groups, value
  and global-norm clipping of the raw gradients (before the decay), Nesterov
  on and off, and frozen leaves with neither decay nor update. optax's
  ``trace`` equals torch SGD's momentum buffer with dampening 0, first step
  included.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch
from torch import nn

from lvc_tpu.config import get_cfg as jax_get_cfg
from lvc_tpu.solver.build import build_lr_schedule as jax_build_lr_schedule
from lvc_tpu.solver.build import build_optimizer as jax_build_optimizer

from lvc_tpu_torch.checkpoint.convert import from_flax, to_flax
from lvc_tpu_torch.config import get_cfg
from lvc_tpu_torch.solver.build import build_lr_schedule, build_optimizer, lr_schedule, trainability_mask


def _cfgs(**solver):
    out = []
    for cfg in (jax_get_cfg(), get_cfg()):
        cfg.SOLVER.BASE_LR = 0.02
        cfg.SOLVER.STEPS = (6, 9)
        cfg.SOLVER.MAX_ITER = 12
        cfg.SOLVER.WARMUP_ITERS = 4
        for k, v in solver.items():
            node, key = cfg.SOLVER, k
            if "." in k:
                sub, key = k.split(".")
                node = cfg.SOLVER[sub]
            node[key] = v
        out.append(cfg)
    return out


@pytest.mark.parametrize("name", ["WarmupMultiStepLR", "WarmupCosineLR"])
@pytest.mark.parametrize("method", ["linear", "constant"])
def test_schedules_match_jax(name, method):
    jcfg, tcfg = _cfgs(LR_SCHEDULER_NAME=name, WARMUP_METHOD=method)
    want = jax_build_lr_schedule(jcfg)
    got = lr_schedule(tcfg)
    f32_abs = 4 * 2.0 ** -24 * tcfg.SOLVER.BASE_LR
    for count in (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12):
        assert got(count) == pytest.approx(float(want(count)), rel=1e-6, abs=f32_abs), count
    # the LambdaLR: the optimizer's lr at step `count` is the schedule at count
    p = nn.Parameter(torch.zeros(1))
    opt = torch.optim.SGD([p], lr=tcfg.SOLVER.BASE_LR)
    sched = build_lr_schedule(tcfg, opt)
    for count in range(12):
        assert opt.param_groups[0]["lr"] == pytest.approx(float(want(count)), rel=1e-6, abs=f32_abs), count
        opt.step()
        sched.step()


class _Tiny(nn.Module):
    """detectron2 names over a small tree: backbone.bottom_up.{stem,res2,res3},
    proposal_generator.rpn_head.conv, roi_heads.box_head.fc1 and
    roi_heads.box_predictor.bbox_pred."""

    def __init__(self):
        super().__init__()
        g = torch.Generator().manual_seed(0)

        def conv(o, i, bias):
            m = nn.Module()
            m.weight = nn.Parameter(torch.randn(o, i, 3, 3, generator=g) * 0.3)
            if bias:
                m.bias = nn.Parameter(torch.randn(o, generator=g) * 0.3)
            return m

        def lin(o, i):
            m = nn.Linear(i, o)
            with torch.no_grad():
                m.weight.copy_(torch.randn(o, i, generator=g) * 0.3)
                m.bias.copy_(torch.randn(o, generator=g) * 0.3)
            return m

        bu = nn.Module()
        bu.stem = nn.Module()
        bu.stem.conv1 = conv(4, 3, False)
        bu.add_module("res2", nn.Module())
        getattr(bu, "res2").add_module("0", nn.Module())
        getattr(getattr(bu, "res2"), "0").conv1 = conv(4, 4, False)
        bu.add_module("res3", nn.Module())
        getattr(bu, "res3").add_module("0", nn.Module())
        getattr(getattr(bu, "res3"), "0").conv1 = conv(6, 4, False)
        self.backbone = nn.Module()
        self.backbone.bottom_up = bu
        self.backbone.fpn_lateral3 = conv(5, 6, True)
        self.proposal_generator = nn.Module()
        self.proposal_generator.rpn_head = nn.Module()
        self.proposal_generator.rpn_head.conv = conv(5, 5, True)
        self.roi_heads = nn.Module()
        self.roi_heads.box_head = nn.Module()
        self.roi_heads.box_head.fc1 = lin(7, 9)
        self.roi_heads.box_predictor = nn.Module()
        self.roi_heads.box_predictor.bbox_pred = lin(8, 7)


def _grads(step, shapes):
    rng = np.random.RandomState(100 + step)
    return {k: (rng.randn(*s) * (3.0 if step % 2 else 0.05)).astype(np.float32) for k, s in shapes.items()}


@pytest.mark.parametrize(
    "solver",
    [
        {},
        {"NESTEROV": True, "WEIGHT_DECAY_BIAS": 0.0},
        {"CLIP_GRADIENTS.ENABLED": True, "CLIP_GRADIENTS.CLIP_TYPE": "value",
         "CLIP_GRADIENTS.CLIP_VALUE": 0.5, "WEIGHT_DECAY": 0.01},
        {"CLIP_GRADIENTS.ENABLED": True, "CLIP_GRADIENTS.CLIP_TYPE": "norm",
         "CLIP_GRADIENTS.CLIP_VALUE": 2.0, "WEIGHT_DECAY_BIAS": 0.003, "NESTEROV": True},
        {"MOMENTUM": 0.0},
    ],
    ids=["default", "nesterov", "clip_value", "clip_norm", "no_momentum"],
)
def test_optimizer_steps_match_optax(solver):
    jcfg, tcfg = _cfgs(**solver)
    model = _Tiny()
    params0 = to_flax(model.state_dict())["params"]
    tx = jax_build_optimizer(jcfg, params0)
    jparams = jax.tree_util.tree_map(jnp.asarray, params0)
    opt_state = tx.init(jparams)
    opt = build_optimizer(tcfg, model)
    sched = build_lr_schedule(tcfg, opt)
    named = dict(model.named_parameters())
    shapes = {k: tuple(v.shape) for k, v in named.items()}
    for step in range(5):
        g = _grads(step, shapes)
        jgrads = jax.tree_util.tree_map(jnp.asarray, to_flax({k: torch.from_numpy(v) for k, v in g.items()})["params"])
        updates, opt_state = tx.update(jgrads, opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in named.items():
            p.grad = torch.from_numpy(g[k].copy()) if p.requires_grad else None
        opt.step()
        sched.step()
        want = from_flax({"params": jax.tree_util.tree_map(np.asarray, jparams)})
        for k, p in named.items():
            np.testing.assert_allclose(p.detach().numpy(), want[k].numpy(), rtol=1e-6, atol=1e-6, err_msg=f"{k} step {step}")
    # frozen leaves (FREEZE_AT 2: stem and res2) stayed where they were
    frozen = [k for k, p in named.items() if not p.requires_grad]
    assert sorted(frozen) == ["backbone.bottom_up.res2.0.conv1.weight", "backbone.bottom_up.stem.conv1.weight"]


def test_trainability_mask_follows_the_freeze_flags():
    _, cfg = _cfgs()
    cfg.MODEL.BACKBONE.FREEZE_AT = 3
    cfg.MODEL.PROPOSAL_GENERATOR.FREEZE = True
    cfg.MODEL.ROI_HEADS.FREEZE_BBOX_PRED = True
    mask = trainability_mask(_Tiny(), cfg)
    assert [k for k, v in mask.items() if v] == [
        "backbone.fpn_lateral3.weight", "backbone.fpn_lateral3.bias",
        "roi_heads.box_head.fc1.weight", "roi_heads.box_head.fc1.bias",
    ]
