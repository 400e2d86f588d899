"""Gradient decouple and affine layers: the port of
``lvc_tpu/modeling/meta_arch/gdl.py`` (lvc/modeling/meta_arch/gdl.py:6-38).

``decouple_layer`` is the cascade's ``scale_gradient``
(``x * s + (x * (1 - s)).detach()``, JAX's expression): the forward passes
``x`` through, the gradient is ``scale`` times the upstream one.
"""
from __future__ import annotations

import torch
from torch import nn

from lvc_tpu_torch.modeling.roi_heads.cascade_rcnn import scale_gradient as decouple_layer  # noqa: F401


class AffineLayer(nn.Module):
    """Channelwise learnable scale and bias over the last axis (``AffineLayer``,
    gdl.py:19): ``weight`` starts at ones, ``bias`` at zeros."""

    def __init__(self, features: int, use_bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = x * self.weight
        return out + self.bias if self.bias is not None else out
