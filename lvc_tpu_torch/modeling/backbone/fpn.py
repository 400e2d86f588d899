"""Feature Pyramid Network (PyTorch).

Counterpart of ``lvc_tpu/modeling/backbone/fpn.py`` (FPN:25, fpn_strides:95):
1x1 lateral and 3x3 output convs named by stage stride (``fpn_lateral2``,
``fpn_output2``), nearest 2x top-down upsampling, and the p6
``LastLevelMaxPool`` taken as ``p5[:, :, ::2, ::2]``.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from lvc_tpu_torch.modeling.backbone.resnet import ResNet, build_resnet, resnet_out_channels
from lvc_tpu_torch.modeling.layers import Conv2d


class FPN(nn.Module):
    def __init__(
        self,
        bottom_up: ResNet,
        in_channels: Dict[str, int],
        in_features: Sequence[str] = ("res2", "res3", "res4", "res5"),
        out_channels: int = 256,
        norm: str = "",
        fuse_type: str = "sum",
    ):
        super().__init__()
        if fuse_type not in ("sum", "avg"):
            raise ValueError(f"FPN fuse_type {fuse_type!r}")
        self.bottom_up = bottom_up
        self.in_features = tuple(in_features)
        self.fuse_type = fuse_type
        self.stage_ids = [int(f[len("res"):]) for f in self.in_features]
        for f, sid in zip(self.in_features, self.stage_ids):
            self.add_module(
                f"fpn_lateral{sid}",
                Conv2d(in_channels[f], out_channels, kernel_size=1, bias=(norm == ""), norm=norm),
            )
            self.add_module(
                f"fpn_output{sid}",
                Conv2d(out_channels, out_channels, kernel_size=3, padding=1,
                       bias=(norm == ""), norm=norm),
            )

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        bottom_up = self.bottom_up(x)
        results = {}
        prev = None
        for f, sid in reversed(list(zip(self.in_features, self.stage_ids))):
            lateral = getattr(self, f"fpn_lateral{sid}")
            if prev is None:
                cur = lateral(bottom_up[f])
            elif self.fuse_type == "sum":
                cur = lateral(bottom_up[f], residual=F.interpolate(prev, scale_factor=2, mode="nearest"))
            else:
                cur = (lateral(bottom_up[f]) + F.interpolate(prev, scale_factor=2, mode="nearest")) / 2.0
            prev = cur
            results[f"p{sid}"] = getattr(self, f"fpn_output{sid}")(cur)
        top = max(self.stage_ids)
        results[f"p{top + 1}"] = results[f"p{top}"][:, :, ::2, ::2]
        return results


def fpn_strides(in_features: Sequence[str]) -> Dict[str, int]:
    """Stride of every FPN output, p6 (the max-pool top block) included."""
    stage_ids = [int(f[len("res"):]) for f in in_features]
    strides = {f"p{s}": 2 ** s for s in stage_ids}
    strides[f"p{max(stage_ids) + 1}"] = 2 ** (max(stage_ids) + 1)
    return strides


def build_resnet_fpn_backbone(cfg) -> FPN:
    return FPN(
        bottom_up=build_resnet(cfg),
        in_channels=resnet_out_channels(cfg),
        in_features=tuple(cfg.MODEL.FPN.IN_FEATURES),
        out_channels=cfg.MODEL.FPN.OUT_CHANNELS,
        norm=cfg.MODEL.FPN.NORM,
        fuse_type=cfg.MODEL.FPN.FUSE_TYPE,
    )
