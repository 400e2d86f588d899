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

``Conv2d`` has the JAX package's opt-in fused branch (``layers.py:315-372``):
with ``LVC_TPU_FUSED_RESIDUAL=1`` in the environment, a bf16 1x1 conv given a
residual (the bottleneck ``conv3``, the FPN laterals of the ``sum`` top-down
path) runs as one GEMM with its affine, residual and ReLU in the epilogue
(``lvc_tpu_torch/ops/fused_matmul.py``: the Hopper kernel on the card, its
plain version on the CPU). Its parameters and buffers are the unfused
branch's, so the weight bridge carries the same weights whichever runs.
"""
from __future__ import annotations

import contextlib
import os
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


FUSED_RESIDUAL_ENV = "LVC_TPU_FUSED_RESIDUAL"


@contextlib.contextmanager
def fused_residual(on: bool):
    """``LVC_TPU_FUSED_RESIDUAL`` set to 1 (or 0) inside the block and as it
    was after: runs a model with the fused branch on or off."""
    saved = os.environ.get(FUSED_RESIDUAL_ENV)
    os.environ[FUSED_RESIDUAL_ENV] = "1" if on else "0"
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop(FUSED_RESIDUAL_ENV, None)
        else:
            os.environ[FUSED_RESIDUAL_ENV] = saved


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

    def folded(self):
        """The float32 ``(scale, shift)`` this norm applies as ``x * scale +
        shift``."""
        scale = self.weight * torch.rsqrt(self.running_var + self.eps)
        return scale, self.bias - self.running_mean * scale

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale, shift = self.folded()
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
        if residual is not None and self._fuses(x):
            return self._fused(x, residual)
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

    def _fuses(self, x: torch.Tensor) -> bool:
        """The JAX package's gate (``layers.py:317-335``), read at call time
        as JAX reads it at trace time. Its "backend is TPU" condition is the
        wrapper's own dispatch by device."""
        fold_bn = self.bias is None and isinstance(self.norm, FrozenBatchNorm)
        bias_only = self.bias is not None and self.norm is None
        return (
            os.environ.get(FUSED_RESIDUAL_ENV, "0") == "1"
            and self.kernel_size == (1, 1)
            and self.stride == (1, 1)
            and self.padding == (0, 0)
            and self.dilation == (1, 1)
            and self.groups == 1
            and (fold_bn or bias_only)
            and x.dtype == torch.bfloat16
        )

    def _fused(self, x: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
        from lvc_tpu_torch.ops.fused_matmul import conv1x1_affine_residual

        if self.norm is not None:
            scale, shift = self.norm.folded()
        else:
            scale, shift = torch.ones_like(self.bias), self.bias
        # (N, K, 1, 1) -> (N, K) with K contiguous; its transpose is the
        # (K, N) of the JAX layout and a view of the kernel's B operand
        w = self.weight.to(x.dtype).view(self.out_channels, self.in_channels).t()
        relu = self.activation is F.relu
        y = conv1x1_affine_residual(
            x.permute(0, 2, 3, 1), w, scale, shift,
            residual.to(x.dtype).permute(0, 2, 3, 1), relu=relu,
            # autograd recording (training, AMP): the Function's backward
            trainable=torch.is_grad_enabled(),
        ).permute(0, 3, 1, 2)
        if self.activation is not None and not relu:
            y = self.activation(y)
        return y


def max_pool_torch(x: torch.Tensor, kernel: int, stride: int, padding: int) -> torch.Tensor:
    """Max-pool with symmetric padding by -inf."""
    return F.max_pool2d(x, kernel_size=kernel, stride=stride, padding=padding)
