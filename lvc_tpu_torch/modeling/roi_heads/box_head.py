"""Box feature head (counterpart of ``lvc_tpu/modeling/roi_heads/box_head.py:17``):
N convs then M fcs with ReLU, and dropout after each fc's ReLU in training
(``ROI_BOX_HEAD.DROPOUT``, default 0). The fcs run in the compute dtype
(``layers.compute_dtype``), as JAX's ``nn.Dense(dtype=...)``: after a
``SyncBN`` conv their input is float32."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from lvc_tpu_torch.modeling.layers import Conv2d, compute_dtype


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
        dropout: float = 0.0,
    ):
        super().__init__()
        self.num_conv = num_conv
        self.num_fc = num_fc
        self.dropout = dropout
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
            x = x.to(compute_dtype(x))
            for k in range(self.num_fc):
                fc = getattr(self, f"fc{k + 1}")
                x = F.relu(F.linear(x, fc.weight.to(x.dtype), fc.bias.to(x.dtype)))
                if self.dropout > 0:
                    x = F.dropout(x, self.dropout, training=self.training)
        return x
