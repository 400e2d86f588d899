"""RPNComp: the bare-backbone descriptor extractor (the port of
``lvc_tpu/modeling/meta_arch/rpn_comp.py``; lvc/modeling/meta_arch/
rpn_comp.py:15-72).

The normalized image through the backbone; its ``res5`` map pooled per
image by ``MODEL.RPNCOMP.POOLER``: ``avg`` or ``max`` over space gives
(B, C), ``identity`` returns the map itself as (B, H, W, C), JAX's layout.
It is inference only.
"""
from __future__ import annotations

from typing import Dict

import torch

from lvc_tpu_torch.modeling.meta_arch.rcnn import GeneralizedRCNN


class RPNComp(GeneralizedRCNN):
    """backbone -> ``out_feature`` -> global pool."""

    def __init__(self, backbone, pooler: str = "avg", out_feature: str = "res5", **kwargs):
        super().__init__(backbone, None, None, **kwargs)
        if pooler not in ("avg", "max", "identity"):
            raise ValueError(f"MODEL.RPNCOMP.POOLER {pooler!r}")
        self.pooler = pooler
        self.out_feature = out_feature

    def forward(self, batch: Dict, generator=None) -> torch.Tensor:
        if self.training:
            raise RuntimeError("RPNComp is inference only (rpn_comp.py:51)")
        with torch.no_grad():
            x = self.backbone(self.model_images(batch))[self.out_feature]  # (B, C, H, W)
        if self.pooler == "avg":
            return x.mean(dim=(2, 3))
        if self.pooler == "max":
            return x.amax(dim=(2, 3))
        return x.permute(0, 2, 3, 1)
