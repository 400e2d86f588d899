"""Seeded weights for a model that has no checkpoint (counterpart of the
``conv_init`` rules of ``lvc_tpu/utils/init.py:21``, ``materialize_variables``):
``he_init``, the trainer's default, and ``damped_init``."""
from __future__ import annotations

import math
import re

import torch
from torch import nn


_NORM_WEIGHT = re.compile(r"(^|\.)norm\d*\.weight$")  # <conv>.norm, and Swin's LayerNorms (norm1, norm2, norm{i})


def _starts_at_one(name: str, leaf: str) -> bool:
    """Norm weights (``<conv>.norm.weight``, FrozenBN or GN, and the Swin
    LayerNorms' ``norm``/``norm1``/``norm2``/``norm{i}``), ``running_var`` and
    the cosine classifier's learnable ``scale`` start at one, as JAX's
    ``materialize_variables`` fills them."""
    return leaf in ("running_var", "scale") or bool(_NORM_WEIGHT.search(name))


def _starts_at_zero(name: str) -> bool:
    """A deformable block's offset conv starts at zero, so the block starts
    as a plain bottleneck (JAX's ``offset_conv`` initialisers)."""
    return ".conv2_offset." in f".{name}"


@torch.no_grad()
def he_init(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """The ``"he"`` rule, on detectron2 names: conv weights N(0, sqrt(2 /
    fan_out)) with fan_out = out x kh x kw (detectron2's ``c2_msra_fill``),
    linear weights N(0, sqrt(1 / fan_in)); ones for norm weights,
    ``running_var`` and ``scale``; zeros for biases, ``running_mean`` and
    anything else. Draws come from ``generator`` (on the model's device) in
    ``state_dict`` order."""
    for name, t in model.state_dict().items():
        leaf = name.rsplit(".", 1)[-1]
        if _starts_at_one(name, leaf):
            t.fill_(1.0)
        elif _starts_at_zero(name):
            t.zero_()
        elif leaf == "weight" and t.dim() == 4:
            std = math.sqrt(2.0 / (t.shape[0] * t.shape[2] * t.shape[3]))
            t.copy_(torch.randn(t.shape, generator=generator, device=t.device, dtype=t.dtype) * std)
        elif leaf == "weight" and t.dim() == 2:
            std = math.sqrt(1.0 / t.shape[1])
            t.copy_(torch.randn(t.shape, generator=generator, device=t.device, dtype=t.dtype) * std)
        else:
            t.zero_()
    return model


@torch.no_grad()
def damped_init(model: nn.Module, seed: int = 0) -> nn.Module:
    """N(0, 0.01) for every learned weight; ones for norm weights,
    ``running_var`` and ``scale``; zeros for biases and ``running_mean``. The
    draws come from a ``torch.Generator`` on the model's device, in
    ``state_dict`` order, so a seed gives the same weights on every run on
    that device."""
    tensors = model.state_dict()
    device = next(iter(tensors.values())).device
    gen = torch.Generator(device=device).manual_seed(seed)
    for name, t in tensors.items():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("bias", "running_mean") or _starts_at_zero(name):
            t.zero_()
        elif _starts_at_one(name, leaf):
            t.fill_(1.0)
        else:
            t.copy_(torch.randn(t.shape, generator=gen, device=device, dtype=t.dtype) * 0.01)
    return model
