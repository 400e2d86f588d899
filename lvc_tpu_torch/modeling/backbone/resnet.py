"""ResNet backbone (PyTorch).

Counterpart of ``lvc_tpu/modeling/backbone/resnet.py`` (BasicStem:24,
BottleneckBlock:52, BottleneckBlockCLIP:116, DeformBottleneckBlock:159,
ResNet:208, RESNET_STAGE_STRIDES:307, resnet_out_channels:310,
build_resnet:319): same topology, stride placement (STRIDE_IN_1X1) and
FrozenBN default, with detectron2's module names (``stem.conv1``,
``res{2..5}.{i}.conv{1..3}``, ``shortcut``, and a deformable block's
``conv2_offset``). Only the bottleneck depths 50/101/152 exist. ``remat``
(``MODEL.BACKBONE.REMAT``, default True) recomputes each block in the
backward pass instead of keeping its activations, in training only
(``resnet.py:229-232,294-295``).

``MODEL.RESNETS.D`` builds every block as ``BottleneckBlockCLIP`` (ResNet-D:
every conv at stride 1, a stride-s average pool after ``conv2`` and before
the shortcut's 1x1); it takes precedence over ``DEFORM_ON_PER_STAGE`` and
ignores ``STRIDE_IN_1X1`` and ``DROPOUT``, and the stem stays the
``BasicStem`` (``resnet.py:279-292``). ``DEFORM_ON_PER_STAGE`` makes a
stage's blocks ``DeformBottleneckBlock`` (``DEFORM_MODULATED``: DCNv2);
``DEFORM_NUM_GROUPS`` and ``DEFORM_INTERVAL`` are not read, as in JAX. Every
block's ``conv3`` takes its residual through ``Conv2d``, so
``LVC_TPU_FUSED_RESIDUAL=1`` fuses it as JAX's rule does.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from lvc_tpu_torch.modeling.layers import Conv2d, max_pool_torch, recompute_in_scope
from lvc_tpu_torch.ops.deform_conv import DeformConv


class BasicStem(nn.Module):
    """7x7/s2/p3 conv + FrozenBN + ReLU, then a 3x3/s2/p1 max-pool. The plain
    conv replaces the JAX package's space-to-depth form, whose output is the
    same."""

    def __init__(self, in_channels: int = 3, out_channels: int = 64, norm: str = "FrozenBN"):
        super().__init__()
        self.conv1 = Conv2d(
            in_channels, out_channels, kernel_size=7, stride=2, padding=3,
            bias=False, norm=norm, activation=F.relu,
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return max_pool_torch(self.conv1(x), kernel=3, stride=2, padding=1)


class BottleneckBlock(nn.Module):
    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        bottleneck_channels: int,
        stride: int = 1,
        num_groups: int = 1,
        norm: str = "FrozenBN",
        stride_in_1x1: bool = True,
        dilation: int = 1,
        has_shortcut: bool = False,
    ):
        super().__init__()
        stride_1x1, stride_3x3 = (stride, 1) if stride_in_1x1 else (1, stride)
        self.shortcut = (
            Conv2d(in_channels, out_channels, kernel_size=1, stride=stride, bias=False, norm=norm)
            if has_shortcut
            else None
        )
        self.conv1 = Conv2d(
            in_channels, bottleneck_channels, kernel_size=1, stride=stride_1x1,
            bias=False, norm=norm, activation=F.relu,
        )
        self.conv2 = Conv2d(
            bottleneck_channels, bottleneck_channels, kernel_size=3,
            stride=stride_3x3, padding=dilation, dilation=dilation,
            groups=num_groups, bias=False, norm=norm, activation=F.relu,
        )
        self.conv3 = Conv2d(
            bottleneck_channels, out_channels, kernel_size=1, bias=False,
            norm=norm, activation=F.relu,
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x if self.shortcut is None else self.shortcut(x)
        out = self.conv2(self.conv1(x))
        return self.conv3(out, residual=shortcut)


class BottleneckBlockCLIP(nn.Module):
    """ResNet-D bottleneck: all convs at stride 1; with stride > 1 the main
    path average-pools after ``conv2`` and the shortcut before its 1x1."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        bottleneck_channels: int,
        stride: int = 1,
        num_groups: int = 1,
        norm: str = "FrozenBN",
        dilation: int = 1,
        has_shortcut: bool = False,
    ):
        super().__init__()
        self.stride = stride
        self.shortcut = (
            Conv2d(in_channels, out_channels, kernel_size=1, bias=False, norm=norm) if has_shortcut else None
        )
        self.conv1 = Conv2d(in_channels, bottleneck_channels, kernel_size=1, bias=False, norm=norm,
                            activation=F.relu)
        self.conv2 = Conv2d(
            bottleneck_channels, bottleneck_channels, kernel_size=3, padding=dilation, dilation=dilation,
            groups=num_groups, bias=False, norm=norm, activation=F.relu,
        )
        self.conv3 = Conv2d(bottleneck_channels, out_channels, kernel_size=1, bias=False, norm=norm,
                            activation=F.relu)

    def _pool(self, x: torch.Tensor) -> torch.Tensor:
        return F.avg_pool2d(x, self.stride, self.stride) if self.stride > 1 else x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self._pool(self.conv2(self.conv1(x)))
        shortcut = x if self.shortcut is None else self.shortcut(self._pool(x))
        return self.conv3(out, residual=shortcut)


class DeformBottleneckBlock(nn.Module):
    """Bottleneck whose 3x3 is deformable: ``conv2_offset`` (zero-initialised,
    so the block starts as a plain bottleneck) predicts the offsets (and,
    modulated, the DCNv2 mask), ``conv2`` samples and applies its norm, then
    ReLU."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        bottleneck_channels: int,
        stride: int = 1,
        num_groups: int = 1,
        norm: str = "FrozenBN",
        stride_in_1x1: bool = True,
        dilation: int = 1,
        has_shortcut: bool = False,
        deform_modulated: bool = False,
    ):
        super().__init__()
        stride_1x1, stride_3x3 = (stride, 1) if stride_in_1x1 else (1, stride)
        self.modulated = deform_modulated
        self.shortcut = (
            Conv2d(in_channels, out_channels, kernel_size=1, stride=stride, bias=False, norm=norm)
            if has_shortcut
            else None
        )
        self.conv1 = Conv2d(in_channels, bottleneck_channels, kernel_size=1, stride=stride_1x1, bias=False,
                            norm=norm, activation=F.relu)
        self.conv2_offset = Conv2d(
            bottleneck_channels, 27 if deform_modulated else 18, kernel_size=3, stride=stride_3x3,
            padding=dilation, dilation=dilation,
        )
        nn.init.zeros_(self.conv2_offset.weight)
        nn.init.zeros_(self.conv2_offset.bias)
        self.conv2 = DeformConv(bottleneck_channels, bottleneck_channels, 3, stride=stride_3x3, padding=dilation,
                                dilation=dilation, norm=norm)
        self.conv3 = Conv2d(bottleneck_channels, out_channels, kernel_size=1, bias=False, norm=norm,
                            activation=F.relu)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x if self.shortcut is None else self.shortcut(x)
        out = self.conv1(x)
        off = self.conv2_offset(out)
        mask = None
        if self.modulated:
            off, mask = off[:, :18], 2.0 * torch.sigmoid(off[:, 18:])
        out = F.relu(self.conv2(out, off, mask))
        return self.conv3(out, residual=shortcut)


class ResNet(nn.Module):
    """Returns a dict of stage outputs restricted to ``out_features``."""

    @staticmethod
    def stage_blocks(depth: int) -> List[int]:
        if depth not in (50, 101, 152):
            raise NotImplementedError(
                f"ResNet depth {depth}: only the bottleneck depths 50/101/152 exist"
            )
        return {50: [3, 4, 6, 3], 101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}[depth]

    def __init__(
        self,
        depth: int = 50,
        num_groups: int = 1,
        width_per_group: int = 64,
        stem_out_channels: int = 64,
        res2_out_channels: int = 256,
        stride_in_1x1: bool = True,
        res5_dilation: int = 1,
        norm: str = "FrozenBN",
        out_features: Sequence[str] = ("res4",),
        remat: bool = False,
        clip_block: bool = False,
        deform_on_per_stage: Sequence[bool] = (False, False, False, False),
        deform_modulated: bool = False,
    ):
        super().__init__()
        self.out_features = tuple(out_features)
        self.remat = remat
        self.stem = BasicStem(3, stem_out_channels, norm)
        out_channels = res2_out_channels
        bottleneck_channels = num_groups * width_per_group
        in_channels = stem_out_channels
        max_stage = max(
            [int(f[len("res"):]) for f in self.out_features if f.startswith("res")],
            default=5,
        )
        self.stage_names = []
        for idx, stage_idx in enumerate(range(2, max_stage + 1)):
            dilation = res5_dilation if stage_idx == 5 else 1
            first_stride = 1 if idx == 0 or (stage_idx == 5 and dilation == 2) else 2
            blocks = []
            for b in range(self.stage_blocks(depth)[idx]):
                common = dict(stride=first_stride if b == 0 else 1, num_groups=num_groups, norm=norm,
                              dilation=dilation, has_shortcut=(b == 0))
                if clip_block:
                    block = BottleneckBlockCLIP(in_channels, out_channels, bottleneck_channels, **common)
                elif deform_on_per_stage[idx]:
                    block = DeformBottleneckBlock(in_channels, out_channels, bottleneck_channels,
                                                  stride_in_1x1=stride_in_1x1, deform_modulated=deform_modulated,
                                                  **common)
                else:
                    block = BottleneckBlock(in_channels, out_channels, bottleneck_channels,
                                            stride_in_1x1=stride_in_1x1, **common)
                blocks.append(block)
                in_channels = out_channels
            name = f"res{stage_idx}"
            self.add_module(name, nn.Sequential(*blocks))
            self.stage_names.append(name)
            out_channels *= 2
            bottleneck_channels *= 2

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = self.stem(x)
        out: Dict[str, torch.Tensor] = {}
        if "stem" in self.out_features:
            out["stem"] = x
        remat = self.remat and self.training and torch.is_grad_enabled()
        for name in self.stage_names:
            for block in getattr(self, name):
                x = checkpoint(block, x, use_reentrant=False, context_fn=recompute_in_scope) if remat else block(x)
            if name in self.out_features:
                out[name] = x
        return out


RESNET_STAGE_STRIDES = {"stem": 4, "res2": 4, "res3": 8, "res4": 16, "res5": 32}


def resnet_out_channels(cfg) -> Dict[str, int]:
    """Each stage's output channels (``resnet_out_channels``, resnet.py:310)."""
    res2 = cfg.MODEL.RESNETS.RES2_OUT_CHANNELS
    return {f"res{i}": res2 * 2 ** (i - 2) for i in range(2, 6)}


def build_resnet(cfg) -> ResNet:
    """Config-driven constructor (``build_resnet``, resnet.py:319)."""
    r = cfg.MODEL.RESNETS
    return ResNet(
        depth=r.DEPTH,
        num_groups=r.NUM_GROUPS,
        width_per_group=r.WIDTH_PER_GROUP,
        stem_out_channels=r.STEM_OUT_CHANNELS,
        res2_out_channels=r.RES2_OUT_CHANNELS,
        stride_in_1x1=r.STRIDE_IN_1X1,
        res5_dilation=r.RES5_DILATION,
        norm=r.NORM,
        out_features=tuple(r.OUT_FEATURES),
        remat=cfg.MODEL.BACKBONE.REMAT,
        clip_block=r.D,
        deform_on_per_stage=tuple(r.DEFORM_ON_PER_STAGE),
        deform_modulated=r.DEFORM_MODULATED,
    )
