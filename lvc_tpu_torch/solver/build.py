"""Optimizer and LR schedule (counterpart of ``lvc_tpu/solver/build.py``).

The JAX package chains optax transforms: clipping of the raw gradients,
weight decay by group (other, bias, norm), momentum (``optax.trace``), the
scheduled learning rate, all under a trainability mask that gives frozen
leaves no update. Here that is ``torch.optim.SGD`` with the three
weight-decay groups, which adds the decay to the gradient, then momentum
(with dampening 0 its buffer is optax's trace, first step included), then
the learning rate; the clipping runs on the raw gradients in ``step`` before
that; frozen parameters get ``requires_grad=False`` and stay out of the
optimizer. The schedule is a ``LambdaLR`` whose factor at count 0 is the
JAX schedule at count 0, which optax uses for the first update.

``build_clip_optimizer`` (``build.py:195-208``, the ResNet-D retrain of
``train_net_qe_ig``) scales the whole SGD update of ``backbone.bottom_up``
by ``CLIP_LR / max(BASE_LR, 1e-12)``. With dampening 0 the momentum buffer
is in gradient units, so that is the same as those parameters' groups
stepping at the scaled learning rate, which is what it builds.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, Optional

import torch
from torch import nn


# ----------------------------------------------------------------- schedules
def warmup_factor_at(method: str, it: int, warmup_iters: int, warmup_factor: float) -> float:
    """d2 ``_get_warmup_factor_at_iter`` (``build.py:22-34``)."""
    if warmup_iters <= 0 or it >= warmup_iters:
        return 1.0
    if method == "constant":
        return warmup_factor
    if method == "linear":
        alpha = it / warmup_iters
        return warmup_factor * (1.0 - alpha) + alpha
    raise ValueError(f"Unknown warmup method: {method}")


def lr_schedule(cfg) -> Callable[[int], float]:
    """count -> learning rate: warmup multistep or warmup cosine
    (``build.py:37-90``)."""
    s = cfg.SOLVER
    name = s.LR_SCHEDULER_NAME

    def warmup(count):
        return warmup_factor_at(s.WARMUP_METHOD, count, s.WARMUP_ITERS, s.WARMUP_FACTOR)

    if name == "WarmupMultiStepLR":
        steps = list(s.STEPS)
        return lambda count: s.BASE_LR * warmup(count) * s.GAMMA ** sum(count >= m for m in steps)
    if name == "WarmupCosineLR":
        return lambda count: (
            s.BASE_LR * warmup(count) * 0.5 * (1.0 + math.cos(math.pi * count / s.MAX_ITER))
        )
    raise ValueError(f"Unknown LR scheduler: {name}")


def build_lr_schedule(cfg, optimizer: torch.optim.Optimizer) -> torch.optim.lr_scheduler.LambdaLR:
    """A ``LambdaLR`` over ``optimizer`` (whose groups start at BASE_LR):
    step ``count`` runs at ``lr_schedule(cfg)(count)``."""
    schedule = lr_schedule(cfg)
    base = cfg.SOLVER.BASE_LR
    return torch.optim.lr_scheduler.LambdaLR(optimizer, lambda count: schedule(count) / base)


# ------------------------------------------------------------------- masking
def trainability_mask(model: nn.Module, cfg) -> Dict[str, bool]:
    """parameter name -> trainable, by the JAX path rules (``build.py:98-130``)
    on detectron2 names. FrozenBN holds buffers only, so it has no entry; a
    ``SyncBatchNorm`` affine follows the path rules (its running statistics
    are buffers, never parameters)."""
    m = cfg.MODEL
    freeze_at = m.BACKBONE.FREEZE_AT

    def decide(name: str) -> bool:
        if m.BACKBONE.FREEZE and name.startswith("backbone."):
            return False
        if m.BACKBONE.FREEZE_BOTTOM_UP and name.startswith("backbone.bottom_up."):
            return False
        if freeze_at >= 1 and "backbone.bottom_up.stem." in name:
            return False
        for stage in range(2, 6):
            if freeze_at >= stage and f"backbone.bottom_up.res{stage}." in name:
                return False
        if m.PROPOSAL_GENERATOR.FREEZE and name.startswith("proposal_generator."):
            return False
        if m.ROI_HEADS.FREEZE_FEAT and "roi_heads.box_head." in name:
            return False
        if m.ROI_HEADS.FREEZE_BBOX_PRED and "bbox_pred" in name:
            return False
        return True

    return {name: decide(name) for name, _ in model.named_parameters()}


def wd_groups(model: nn.Module) -> Dict[str, str]:
    """parameter name -> its weight-decay group by JAX's path rule
    (``_wd_group_masks``, ``build.py:133-149``): "norm" for the parameters
    of a GroupNorm or a ``SyncBatchNorm`` (JAX: the path holds ``GroupNorm``
    or ``SyncBatchNorm``; FrozenBN holds buffers here); "bias" for any other
    ``bias`` (JAX: a
    path ending in ``/bias`` without ``Norm``, which takes Swin's LayerNorm
    biases, flax-named ``norm1`` and the like); "other" for the rest, Swin's
    LayerNorm scales among them."""
    from lvc_tpu_torch.modeling.layers import GroupNorm, SyncBatchNorm

    norm = {id(p) for m in model.modules() if isinstance(m, (GroupNorm, SyncBatchNorm))
            for p in m.parameters(recurse=False)}
    return {
        name: "norm" if id(p) in norm else "bias" if name.endswith(".bias") or name == "bias" else "other"
        for name, p in model.named_parameters()
    }


# ---------------------------------------------------------------- optimizer
class SGD(torch.optim.SGD):
    """``torch.optim.SGD`` that first clips the raw gradients (by value, or by
    their global L2 norm as ``optax.clip_by_global_norm`` does:
    ``g / norm * max`` when ``norm >= max``), then lets SGD add the weight
    decay. A trainable parameter without a gradient steps with a zero one,
    as every leaf of the optax tree does."""

    def __init__(self, params: Iterable, clip_type: Optional[str] = None, clip_value: float = 0.0,
                 **kwargs):
        super().__init__(params, **kwargs)
        self.clip_type = clip_type
        self.clip_value = clip_value

    @torch.no_grad()
    def step(self, closure=None):
        params = [p for g in self.param_groups for p in g["params"]]
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params]
        if self.clip_type == "value":
            for g in grads:
                g.clamp_(-self.clip_value, self.clip_value)
        elif self.clip_type == "norm" and grads:
            norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
            under = norm < self.clip_value
            one = torch.ones((), device=norm.device)
            div = torch.where(under, one, norm)
            mul = torch.where(under, one, torch.full_like(norm, self.clip_value))
            for g in grads:
                g.div_(div).mul_(mul)
        return super().step(closure)


def build_optimizer(cfg, model: nn.Module, lr_scale=None) -> SGD:
    """SGD with momentum, d2's weight-decay groups and the freeze mask:
    frozen parameters get ``requires_grad=False`` and no group.
    ``lr_scale``: name -> a factor on that parameter's learning rate (its
    groups are split from the others')."""
    s = cfg.SOLVER
    mask = trainability_mask(model, cfg)
    decay = {"other": s.WEIGHT_DECAY, "bias": s.WEIGHT_DECAY_BIAS, "norm": s.WEIGHT_DECAY_NORM}
    wd = wd_groups(model)
    groups: Dict[tuple, list] = {}
    for name, p in model.named_parameters():
        p.requires_grad_(mask[name])
        if mask[name]:
            scale = 1.0 if lr_scale is None else lr_scale(name)
            groups.setdefault((wd[name], scale), []).append(p)
    param_groups = [
        {"params": ps, "weight_decay": decay[k], "lr": s.BASE_LR * scale}
        for (k, scale), ps in sorted(groups.items(), key=lambda kv: (kv[0][1] != 1.0, list(decay).index(kv[0][0])))
    ]
    clip = s.CLIP_GRADIENTS
    return SGD(
        param_groups,
        clip_type=("value" if clip.CLIP_TYPE == "value" else "norm") if clip.ENABLED else None,
        clip_value=clip.CLIP_VALUE,
        lr=s.BASE_LR,
        momentum=s.MOMENTUM,
        nesterov=s.NESTEROV,
    )


def build_clip_optimizer(cfg, model: nn.Module) -> SGD:
    """``build_optimizer`` whose ``backbone.bottom_up`` parameters step at
    ``CLIP_LR``: their learning rate scaled by ``CLIP_LR / max(BASE_LR,
    1e-12)`` (JAX scales their whole update by it; see the module
    docstring)."""
    ratio = cfg.SOLVER.CLIP_LR / max(cfg.SOLVER.BASE_LR, 1e-12)
    return build_optimizer(cfg, model, lambda name: ratio if name.startswith("backbone.bottom_up.") else 1.0)
