"""Semantic segmentation (counterpart of
``lvc_tpu/modeling/meta_arch/semantic_seg.py``: upsample_2x:21,
SemSegFPNHead:27, losses:76, SemanticSegmentor:87).

``SemSegFPNHead``: each FPN level runs ``max(1, log2(stride) -
log2(common_stride))`` blocks of 3x3 conv + norm + ReLU, each followed by a
bilinear 2x upsample while the level's stride is above ``common_stride``;
the branches are summed, a 1x1 ``predictor`` gives the class logits, and
they are upsampled in float32 by ``common_stride`` to the canvas. The
upsamples are ``F.interpolate(mode="bilinear", align_corners=False)``, which
is ``jax.image.resize(..., "bilinear")`` for these integer factors. Module
names are detectron2's: ``sem_seg_head.p2.0``, ``sem_seg_head.p5.{0,2,4}``
(the ``Upsample`` modules between them hold no parameters) and
``sem_seg_head.predictor``; GN is the port's ``GroupNorm`` (flax's epsilon
1e-6). The logits are NCHW ``(B, num_classes, H, W)``, float32, on the
canvas; JAX returns them NHWC.

The loss is the pixel cross-entropy over the non-ignored pixels (the
ignore value doubles as the padding mask), through ``global_ratio``, times
``loss_weight``. ``SemanticSegmentor`` is the backbone and this head; in
training mode with ``sem_seg`` (B, H, W) in the batch it returns
``{"loss_sem_seg"}``, else the logits. The loader emits no ``sem_seg``, as
JAX's does not: a training batch brings its own.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from lvc_tpu_torch.modeling.layers import Conv2d
from lvc_tpu_torch.modeling.meta_arch.rcnn import GeneralizedRCNN
from lvc_tpu_torch.modeling.sampling import global_ratio
from lvc_tpu_torch.utils.tracing import span


class SemSegFPNHead(nn.Module):
    def __init__(
        self,
        in_features: Sequence[str],
        strides: Dict[str, int],
        in_channels: int,
        num_classes: int = 54,
        convs_dim: int = 128,
        common_stride: int = 4,
        norm: str = "GN",
        ignore_value: int = 255,
        loss_weight: float = 1.0,
    ):
        super().__init__()
        self.in_features = tuple(in_features)
        self.common_stride = common_stride
        self.num_classes = num_classes
        self.ignore_value = ignore_value
        self.loss_weight = loss_weight
        for f in self.in_features:
            stride = strides[f]
            layers = []
            for k in range(max(1, int(math.log2(stride) - math.log2(common_stride)))):
                layers.append(Conv2d(in_channels if k == 0 else convs_dim, convs_dim, kernel_size=3, padding=1,
                                     bias=not norm, norm=norm, activation=F.relu))
                if stride != common_stride:
                    layers.append(nn.Upsample(scale_factor=2, mode="bilinear", align_corners=False))
                    stride //= 2
            self.add_module(f, nn.Sequential(*layers))
        self.predictor = Conv2d(convs_dim, num_classes, kernel_size=1)
        self.init_weights()

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator = None) -> "SemSegFPNHead":
        """JAX's module initialisation: the 3x3 convs N(0, sqrt(2 /
        fan_out)) (msra), the predictor N(0, 0.01), biases zero."""
        for m in self.modules():
            if isinstance(m, Conv2d):
                w = m.weight
                std = 0.01 if m is self.predictor else math.sqrt(2.0 / (w.shape[0] * w.shape[2] * w.shape[3]))
                w.copy_(torch.randn(w.shape, generator=generator, device=w.device) * std)
                if m.bias is not None:
                    m.bias.zero_()
        return self

    def forward(self, features: Dict[str, torch.Tensor]) -> torch.Tensor:
        summed = None
        for f in self.in_features:
            x = getattr(self, f)(features[f])
            summed = x if summed is None else summed + x
        logits = self.predictor(summed).float()
        H, W = logits.shape[2:]
        s = self.common_stride
        return F.interpolate(logits, size=(H * s, W * s), mode="bilinear", align_corners=False)

    def losses(self, logits: torch.Tensor, targets: torch.Tensor) -> Dict[str, torch.Tensor]:
        """``targets``: (B, H, W) integer labels, ``ignore_value`` for void
        and padding."""
        targets = targets.long()
        valid = targets != self.ignore_value
        logp = F.log_softmax(logits, dim=1)
        ce = -torch.gather(logp, 1, targets.clamp(0, self.num_classes - 1)[:, None])[:, 0]
        zero = torch.zeros((), device=ce.device)
        return {"loss_sem_seg": global_ratio(torch.where(valid, ce, zero).sum(), valid.sum()) * self.loss_weight}


class SemanticSegmentor(GeneralizedRCNN):
    """backbone -> ``SemSegFPNHead``."""

    def __init__(self, backbone, sem_seg_head: SemSegFPNHead, **kwargs):
        super().__init__(backbone, None, None, **kwargs)
        self.sem_seg_head = sem_seg_head

    def forward(self, batch: Dict, generator=None):
        if self.training and "sem_seg" in batch:
            with span("backbone"):
                features = self.backbone(self.model_images(batch))
            with span("sem_seg_head"):
                logits = self.sem_seg_head(features)
                return self.sem_seg_head.losses(logits, self._as_tensor(batch["sem_seg"]))
        with torch.no_grad():
            return self.sem_seg_head(self.backbone(self.model_images(batch)))
