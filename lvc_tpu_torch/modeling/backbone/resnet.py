"""ResNet backbone (PyTorch).

Counterpart of ``lvc_tpu/modeling/backbone/resnet.py`` (BasicStem:24,
BottleneckBlock:52, ResNet:208, build_resnet:319): same topology, stride
placement (STRIDE_IN_1X1) and FrozenBN default, with detectron2's module
names (``stem.conv1``, ``res{2..5}.{i}.conv{1..3}``, ``shortcut``). Only the
bottleneck depths 50/101/152 exist; the deformable and CLIP blocks are not
ported yet. ``remat`` (``MODEL.BACKBONE.REMAT``, default True) recomputes each
bottleneck block in the backward pass instead of keeping its activations, in
training only (``resnet.py:229-232,294-295``).
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from lvc_tpu_torch.modeling.layers import Conv2d, max_pool_torch


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
                blocks.append(
                    BottleneckBlock(
                        in_channels, out_channels, bottleneck_channels,
                        stride=first_stride if b == 0 else 1,
                        num_groups=num_groups, norm=norm,
                        stride_in_1x1=stride_in_1x1, dilation=dilation,
                        has_shortcut=(b == 0),
                    )
                )
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
                x = checkpoint(block, x, use_reentrant=False) if remat else block(x)
            if name in self.out_features:
                out[name] = x
        return out


def build_resnet(cfg) -> ResNet:
    """Config-driven constructor (``build_resnet``, resnet.py:319)."""
    r = cfg.MODEL.RESNETS
    if r.D or any(r.DEFORM_ON_PER_STAGE):
        raise NotImplementedError(
            "CLIP/ResNet-D and deformable blocks are not ported yet "
            "(ROADMAP.md queue 1, item 10)"
        )
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
    )
