"""Box feature head (counterpart of ``lvc_tpu/modeling/roi_heads/box_head.py:17``):
N convs then M fcs with ReLU. Inference only, so dropout is not ported."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from lvc_tpu_torch.modeling.layers import Conv2d


class FastRCNNConvFCHead(nn.Module):
    def __init__(
        self,
        in_channels: int,
        resolution: int,
        num_conv: int = 0,
        conv_dim: int = 256,
        num_fc: int = 2,
        fc_dim: int = 1024,
        norm: str = "",
    ):
        super().__init__()
        self.num_conv = num_conv
        self.num_fc = num_fc
        c = in_channels
        for k in range(num_conv):
            self.add_module(
                f"conv{k + 1}",
                Conv2d(c, conv_dim, kernel_size=3, padding=1, bias=(norm == ""),
                       norm=norm, activation=F.relu),
            )
            c = conv_dim
        d = c * resolution * resolution
        for k in range(num_fc):
            self.add_module(f"fc{k + 1}", nn.Linear(d, fc_dim))
            d = fc_dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (N, P, P, C) pooled features -> (N, fc_dim)."""
        x = x.permute(0, 3, 1, 2)
        for k in range(self.num_conv):
            x = getattr(self, f"conv{k + 1}")(x)
        if self.num_fc:
            # flatten in (C, H, W) order, as detectron2 and the JAX head do
            x = x.reshape(x.shape[0], -1)
            for k in range(self.num_fc):
                fc = getattr(self, f"fc{k + 1}")
                x = F.relu(F.linear(x, fc.weight.to(x.dtype), fc.bias.to(x.dtype)))
        return x
