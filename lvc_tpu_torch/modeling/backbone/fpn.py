"""Feature Pyramid Network (PyTorch).

Counterpart of ``lvc_tpu/modeling/backbone/fpn.py`` (FPN:25, fpn_strides:95):
1x1 lateral and 3x3 output convs named by stage stride (``fpn_lateral2``,
``fpn_output2``), nearest 2x top-down upsampling, and a top block
(``top_block``, ``fpn.py:73-91``): ``"maxpool"``, the p6
``LastLevelMaxPool`` taken as ``p5[:, :, ::2, ::2]``; ``"p6p7"``,
RetinaNet's ``LastLevelP6P7`` (two stride-2 3x3 convs, p7 from ``relu(p6)``,
the source ``res5`` or with ``p6p7_from_res5=False`` the top FPN output),
under detectron2's names ``top_block.p6`` and ``top_block.p7``; ``""``, none.
``build_swin_fpn_backbone`` (``lvc_tpu/modeling/backbone/swin.py:183-207``)
puts the FPN on a Swin Transformer: always ``res2``..``res5``, whatever
``FPN.IN_FEATURES`` says, with ``embed_dim * 2**i`` input channels.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from lvc_tpu_torch.modeling.backbone.resnet import ResNet, build_resnet, resnet_out_channels
from lvc_tpu_torch.modeling.backbone.swin import build_swin, swin_out_channels
from lvc_tpu_torch.modeling.layers import Conv2d


class LastLevelP6P7(nn.Module):
    """p6 = conv(src), p7 = conv(relu(p6)): 3x3, stride 2, with bias."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.p6 = Conv2d(in_channels, out_channels, kernel_size=3, stride=2, padding=1)
        self.p7 = Conv2d(out_channels, out_channels, kernel_size=3, stride=2, padding=1)

    def forward(self, x: torch.Tensor):
        p6 = self.p6(x)
        return p6, self.p7(F.relu(p6))


class FPN(nn.Module):
    def __init__(
        self,
        bottom_up: ResNet,
        in_channels: Dict[str, int],
        in_features: Sequence[str] = ("res2", "res3", "res4", "res5"),
        out_channels: int = 256,
        norm: str = "",
        fuse_type: str = "sum",
        top_block: str = "maxpool",
        p6p7_from_res5: bool = True,
    ):
        super().__init__()
        if fuse_type not in ("sum", "avg"):
            raise ValueError(f"FPN fuse_type {fuse_type!r}")
        if top_block not in ("maxpool", "p6p7", ""):
            raise ValueError(f"FPN top_block {top_block!r}")
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
        self.top_block_kind = top_block
        self.p6p7_from_res5 = p6p7_from_res5
        if top_block == "p6p7":
            top = f"res{max(self.stage_ids)}"
            self.top_block = LastLevelP6P7(in_channels[top] if p6p7_from_res5 else out_channels, out_channels)

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
        if self.top_block_kind == "maxpool":
            results[f"p{top + 1}"] = results[f"p{top}"][:, :, ::2, ::2]
        elif self.top_block_kind == "p6p7":
            src = bottom_up[f"res{top}"] if self.p6p7_from_res5 else results[f"p{top}"]
            results[f"p{top + 1}"], results[f"p{top + 2}"] = self.top_block(src)
        return results


def fpn_strides(in_features: Sequence[str], top_block: str = "maxpool") -> Dict[str, int]:
    """Stride of every FPN output, the top block's (p6, or p6 and p7)
    included."""
    stage_ids = [int(f[len("res"):]) for f in in_features]
    top = max(stage_ids)
    extra = {"maxpool": 1, "p6p7": 2, "": 0}[top_block]
    return {f"p{s}": 2 ** s for s in stage_ids + list(range(top + 1, top + 1 + extra))}


def build_resnet_fpn_backbone(cfg) -> FPN:
    return FPN(
        bottom_up=build_resnet(cfg),
        in_channels=resnet_out_channels(cfg),
        in_features=tuple(cfg.MODEL.FPN.IN_FEATURES),
        out_channels=cfg.MODEL.FPN.OUT_CHANNELS,
        norm=cfg.MODEL.FPN.NORM,
        fuse_type=cfg.MODEL.FPN.FUSE_TYPE,
    )


def build_swin_fpn_backbone(cfg) -> FPN:
    return FPN(
        bottom_up=build_swin(cfg),
        in_channels=swin_out_channels(cfg),
        in_features=("res2", "res3", "res4", "res5"),
        out_channels=cfg.MODEL.FPN.OUT_CHANNELS,
        norm=cfg.MODEL.FPN.NORM,
        fuse_type=cfg.MODEL.FPN.FUSE_TYPE,
    )
