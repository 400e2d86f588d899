"""Neural-net building blocks (PyTorch, NCHW tensors in channels_last memory).

Counterpart of ``lvc_tpu/modeling/layers.py`` (compute_dtype_scope:40,
FrozenBatchNorm:59, SyncBatchNorm:91, GroupNorm:127, get_norm:131,
Conv2d:257, ASPP:401, max_pool_torch:438). Module and buffer names follow
detectron2's ``state_dict`` (``conv1.weight``, ``conv1.norm.running_var``), so
the weight bridge in ``lvc_tpu_torch/checkpoint/convert.py`` is a rename.

Parameters stay float32, as in the JAX package. ``Conv2d`` (and the box
head's linears) run in the model's compute dtype, which the model's forward
sets (``compute_dtype_scope``, JAX's ``get_compute_dtype``): the input and
the weight are cast to it, which is what flax's ``nn.Conv(dtype=...)`` does.
Outside a model's forward they run in their input's dtype. The cast matters
after ``SyncBatchNorm``, whose float32 affine promotes a bf16 activation to
float32 as JAX's does; every other layer hands on the compute dtype.

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

# the dtype the convolutions and the heads' linears run in (None: their
# input's), and whether the forward sees its parameters rounded to bf16, as
# the JAX package's AMP step casts its params; set by the model's forward
# and the AMP train step
_COMPUTE_DTYPE: Optional[torch.dtype] = None
_BF16_PARAMS = False


@contextlib.contextmanager
def compute_dtype_scope(dtype: Optional[torch.dtype], bf16_params: Optional[bool] = None):
    """``compute_dtype(x)`` is ``dtype`` inside the block (JAX's
    ``compute_dtype_scope``); with ``bf16_params`` set, so is
    ``bf16_params()``."""
    global _COMPUTE_DTYPE, _BF16_PARAMS
    saved = _COMPUTE_DTYPE, _BF16_PARAMS
    _COMPUTE_DTYPE = dtype
    if bf16_params is not None:
        _BF16_PARAMS = bf16_params
    try:
        yield
    finally:
        _COMPUTE_DTYPE, _BF16_PARAMS = saved


def recompute_in_scope():
    """``context_fn`` of ``torch.utils.checkpoint``: the backward's recompute
    runs in the forward's compute dtype and parameter rounding."""
    return contextlib.nullcontext(), compute_dtype_scope(_COMPUTE_DTYPE, _BF16_PARAMS)


def compute_dtype(x: torch.Tensor) -> torch.dtype:
    """The dtype a convolution or a head's linear runs ``x`` in."""
    return _COMPUTE_DTYPE or x.dtype


def bf16_params() -> bool:
    """True inside the AMP train step's forward."""
    return _BF16_PARAMS


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


class SyncBatchNorm(nn.Module):
    """The JAX package's ``SyncBatchNorm`` (``layers.py:91-124``), which its
    ``get_norm`` builds for ``BN``, ``SyncBN`` and ``naiveSyncBN``: a
    trainable affine (``weight``, ``bias``) and float32 running statistics.

    ``forward(x)`` is the form every detector call site uses: ``x * scale +
    (bias - running_mean * scale)`` with ``scale = weight *
    rsqrt(running_var + eps)`` in float32 and no cast of ``x``, so a bf16
    activation comes out float32 (flax promotes it). XLA's rsqrt is its own
    approximation, a float32 ulp from torch's for about a third of the
    variances, so the two packages' outputs differ by a few ulps of
    ``|x * scale| + |shift|``. Inside the AMP train step the affine is
    first rounded to bf16, as JAX's AMP step casts its params; bf16 serving
    keeps it float32, as JAX's does. The statistics never change in a
    detector's step.

    ``forward(x, train=True)`` normalises with the batch's biased moments,
    ``mean(x)`` and ``mean(x^2) - mean^2`` over every dimension but the
    channels (averaged over ``process_group`` when it is set, as JAX's
    ``pmean`` over ``axis_name``), and moves the running statistics by
    ``momentum * running + (1 - momentum) * batch``. ``update_bn_stats`` and
    modules that ask for it use this form; no detector does. It is not
    ``torch.nn.SyncBatchNorm``: no unbiased variance, momentum on the old
    value, no clamp."""

    def __init__(self, num_features: int, eps: float = 1e-5, momentum: float = 0.9, process_group=None):
        super().__init__()
        self.num_features = num_features
        self.eps = eps
        self.momentum = momentum
        self.process_group = process_group
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        weight, bias = self.weight, self.bias
        if bf16_params():
            weight, bias = weight.to(torch.bfloat16), bias.to(torch.bfloat16)
        if train:
            mean, var = self._batch_moments(x)
        else:
            mean, var = self.running_mean, self.running_var
        scale = weight * torch.rsqrt(var + self.eps)
        shape = (1, -1) + (1,) * (x.dim() - 2)
        # one pass and one rounding, as XLA contracts the affine into an FMA
        return torch.addcmul((bias - mean * scale).view(shape), x, scale.view(shape))

    def _batch_moments(self, x: torch.Tensor):
        dims = (0,) + tuple(range(2, x.dim()))
        mean, mean2 = x.mean(dims), (x * x).mean(dims)
        if self.process_group is not None:
            from torch.distributed.nn.functional import all_reduce

            # pmean: the sum over the group divided by its size (a 0-dim tensor: CUDA would multiply by the
            # reciprocal of a Python scalar)
            world = torch.tensor(float(torch.distributed.get_world_size(self.process_group)), device=x.device)
            moments = all_reduce(torch.stack([mean, mean2]), group=self.process_group) / world
            mean, mean2 = moments[0], moments[1]
        var = mean2 - mean * mean
        with torch.no_grad():
            m = self.momentum
            self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1 - m) * var)
        return mean, var


class GroupNorm(nn.Module):
    """flax's ``nn.GroupNorm(num_groups=32)``, what the JAX package's
    ``get_norm("GN")`` builds: epsilon 1e-6 (torch's default is 1e-5), the
    variance as ``E[x^2] - E[x]^2`` clipped at 0, the statistics and the
    affine in float32, the result in the input's dtype. The affine is
    ``weight``/``bias`` (flax's ``scale``/``bias``); the weight bridge maps
    them."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-6):
        super().__init__()
        if num_channels % num_groups:
            raise ValueError(f"{num_groups} groups do not divide {num_channels} channels")
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c = x.shape[:2]
        xf = x.float()
        g = xf.reshape(n, self.num_groups, -1)
        mean = g.mean(-1)
        var = ((g * g).mean(-1) - mean * mean).clamp_min(0.0)
        shape = (n, c) + (1,) * (x.dim() - 2)
        mean = mean.repeat_interleave(c // self.num_groups, 1).view(shape)
        var = var.repeat_interleave(c // self.num_groups, 1).view(shape)
        # a bf16 forward (AMP) sees its parameters in bf16, as JAX's AMP step
        # casts them; the arithmetic stays float32 either way
        weight = self.weight.to(x.dtype).float().view((1, c) + (1,) * (x.dim() - 2))
        bias = self.bias.to(x.dtype).float().view(weight.shape)
        return ((xf - mean) * (torch.rsqrt(var + self.eps) * weight) + bias).to(x.dtype)


def get_norm(norm: str, num_features: int) -> Optional[nn.Module]:
    """Norm factory by detectron2 name (``layers.py:131``): ``FrozenBN``,
    ``GN`` (32 groups), and ``BN``, ``SyncBN`` and ``naiveSyncBN``, which
    all build ``SyncBatchNorm`` with no process group, as JAX's does."""
    if not norm:
        return None
    if norm == "FrozenBN":
        return FrozenBatchNorm(num_features)
    if norm == "GN":
        return GroupNorm(32, num_features)
    if norm in ("BN", "SyncBN", "naiveSyncBN"):
        return SyncBatchNorm(num_features)
    raise ValueError(f"Unknown norm: {norm}")


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
        x = x.to(compute_dtype(x))
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
        wrapper's own dispatch by device. Only FrozenBN folds: a
        ``SyncBatchNorm`` conv never fuses, as in JAX."""
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


class ASPP(nn.Module):
    """Atrous Spatial Pyramid Pooling (detectron2/layers/aspp.py:12): a 1x1
    conv, three dilated 3x3 convs and a global-mean branch (a 1x1 conv
    broadcast back over the map, as JAX does instead of resizing), each with
    ReLU, concatenated and fused by a 1x1 projection with ReLU; dropout after
    it in training. Names are flax's (``conv1x1``, ``conv3x3_{i}``,
    ``pool_conv``, ``project``), so ``from_flax`` carries JAX's weights. No
    model builds it, in either package."""

    def __init__(self, in_channels: int, features: int, dilations=(6, 12, 18), norm: str = "",
                 dropout: float = 0.0):
        super().__init__()
        bias = norm == ""
        self.conv1x1 = Conv2d(in_channels, features, 1, bias=bias, norm=norm, activation=F.relu)
        for i, d in enumerate(dilations):
            conv = Conv2d(in_channels, features, 3, padding=d, dilation=d, bias=bias, norm=norm,
                          activation=F.relu)
            self.add_module(f"conv3x3_{i}", conv)
        self.num_dilations = len(dilations)
        self.pool_conv = Conv2d(in_channels, features, 1, activation=F.relu)
        self.project = Conv2d(features * (len(dilations) + 2), features, 1, bias=bias, norm=norm,
                              activation=F.relu)
        self.dropout = dropout

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        branches = [self.conv1x1(x)]
        branches += [getattr(self, f"conv3x3_{i}")(x) for i in range(self.num_dilations)]
        pooled = self.pool_conv(x.mean(dim=(2, 3), keepdim=True))
        branches.append(pooled.expand_as(branches[0]))
        y = self.project(torch.cat(branches, dim=1))
        if self.dropout > 0 and self.training:
            y = F.dropout(y, self.dropout)
        return y


def max_pool_torch(x: torch.Tensor, kernel: int, stride: int, padding: int) -> torch.Tensor:
    """Max-pool with symmetric padding by -inf."""
    return F.max_pool2d(x, kernel_size=kernel, stride=stride, padding=padding)
