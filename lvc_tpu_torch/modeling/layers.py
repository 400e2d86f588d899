"""Neural-net building blocks (PyTorch, NCHW tensors in channels_last memory).

Counterpart of ``lvc_tpu/modeling/layers.py`` (FrozenBatchNorm:59,
get_norm:131, Conv2d:257, max_pool_torch:438). Module and buffer names follow
detectron2's ``state_dict`` (``conv1.weight``, ``conv1.norm.running_var``), so
the weight bridge in ``lvc_tpu_torch/checkpoint/convert.py`` is a rename.

Parameters stay float32, as in the JAX package. A convolution runs in the
dtype of its input: the model casts the image to ``MODEL.DTYPE`` once and
every conv casts its weight to match, which is what flax's
``nn.Conv(dtype=...)`` does.

There is no space-to-depth stem here: that is a TPU layout trick. The stem
runs the plain 7x7/s2/p3 conv, whose output equals the JAX s2d stem's.
There is no fused 1x1-GEMM branch either: it is opt-in and off by default
in the JAX package (``layers.py:319-335``).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


class FrozenBatchNorm(nn.Module):
    """BatchNorm with constant affine and statistics (detectron2
    FrozenBatchNorm2d). The affine is folded in float32 and applied in the
    activation dtype, as the JAX module does."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.num_features = num_features
        self.eps = eps
        self.register_buffer("weight", torch.ones(num_features))
        self.register_buffer("bias", torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale = self.weight * torch.rsqrt(self.running_var + self.eps)
        shift = self.bias - self.running_mean * scale
        shape = (1, -1, 1, 1)
        return x * scale.to(x.dtype).view(shape) + shift.to(x.dtype).view(shape)


def get_norm(norm: str, num_features: int) -> Optional[nn.Module]:
    """Norm factory by detectron2 name. Only the frozen norm of the serving
    path is ported."""
    if not norm:
        return None
    if norm == "FrozenBN":
        return FrozenBatchNorm(num_features)
    raise NotImplementedError(
        f"norm {norm!r} is not ported yet (ROADMAP.md queue 1, item 6: training)"
    )


class Conv2d(nn.Conv2d):
    """``act(norm(conv(x)) + residual)``, the detectron2 Conv2d wrapper with
    the bottleneck tail's residual add."""

    def __init__(self, *args, norm: str = "", activation=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.norm = get_norm(norm, self.out_channels)
        self.activation = activation

    def forward(
        self, x: torch.Tensor, residual: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        x = F.conv2d(
            x, self.weight.to(x.dtype), bias, self.stride, self.padding,
            self.dilation, self.groups,
        )
        if self.norm is not None:
            x = self.norm(x)
        if residual is not None:
            x = x + residual
        if self.activation is not None:
            x = self.activation(x)
        return x


def max_pool_torch(x: torch.Tensor, kernel: int, stride: int, padding: int) -> torch.Tensor:
    """Max-pool with symmetric padding by -inf."""
    return F.max_pool2d(x, kernel_size=kernel, stride=stride, padding=padding)
