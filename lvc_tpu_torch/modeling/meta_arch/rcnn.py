"""Generalized R-CNN (counterpart of ``lvc_tpu/modeling/meta_arch/rcnn.py``:
model_images:25, GeneralizedRCNN:55-131).

The model takes the JAX package's batch dict, ``image`` (B, H, W, 3) raw
pixels in cfg INPUT.FORMAT order and ``image_size`` (B, 2) true (h, w) inside
the padded canvas. In eval mode it returns padded ``Detections`` (under
``no_grad``). In training mode with gt in the batch (``gt_boxes`` (B, G, 4),
``gt_classes`` (B, G), ``gt_valid`` (B, G), optional ``gt_ignores`` (B, G)) it
returns the JAX loss dict: ``loss_rpn_cls``, ``loss_rpn_loc``, ``loss_cls``,
``loss_box_reg``. It runs on the device its parameters live on; the batch is
moved there.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn
from torch.profiler import record_function

from lvc_tpu_torch.modeling.backbone.fpn import FPN
from lvc_tpu_torch.modeling.proposal_generator.rpn import RPN
from lvc_tpu_torch.modeling.roi_heads.fast_rcnn import Detections
from lvc_tpu_torch.modeling.roi_heads.roi_heads import StandardROIHeads


class GeneralizedRCNN(nn.Module):
    """backbone -> RPN -> ROI heads."""

    def __init__(
        self,
        backbone: FPN,
        proposal_generator: RPN,
        roi_heads: StandardROIHeads,
        pixel_mean: Sequence[float] = (103.53, 116.28, 123.675),
        pixel_std: Sequence[float] = (1.0, 1.0, 1.0),
        compute_dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.backbone = backbone
        self.proposal_generator = proposal_generator
        self.roi_heads = roi_heads
        self.register_buffer("pixel_mean", torch.tensor(pixel_mean, dtype=torch.float32), False)
        self.register_buffer("pixel_std", torch.tensor(pixel_std, dtype=torch.float32), False)
        self.compute_dtype = compute_dtype

    @property
    def device(self) -> torch.device:
        return self.pixel_mean.device

    def _as_tensor(self, x) -> torch.Tensor:
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(x)
        return x.to(self.device)

    def model_images(self, batch: Dict) -> torch.Tensor:
        """Normalized image as NCHW in channels_last memory, in the compute
        dtype. Pad pixels are 0 in normalized space (detectron2 ImageList
        pads after normalizing), as ``model_images`` does in JAX."""
        images = self._as_tensor(batch["image"])
        if not images.is_floating_point():
            images = images.float()
        # a bf16 image (the AMP step's) is normalized in bf16, as in JAX
        x = (images - self.pixel_mean.to(images.dtype)) / self.pixel_std.to(images.dtype)
        if "image_size" in batch:
            sizes = self._as_tensor(batch["image_size"])
            H, W = images.shape[1:3]
            rows = torch.arange(H, device=self.device)[None, :, None, None]
            cols = torch.arange(W, device=self.device)[None, None, :, None]
            inside = (rows < sizes[:, 0, None, None, None]) & (cols < sizes[:, 1, None, None, None])
            x = torch.where(inside, x, torch.zeros((), device=self.device))
        # (B, H, W, 3) memory read as NCHW is already channels_last
        return x.to(self.compute_dtype).permute(0, 3, 1, 2)

    @torch.no_grad()
    def backbone_features(self, batch: Dict) -> Dict[str, torch.Tensor]:
        return self.backbone(self.model_images(batch))

    @torch.no_grad()
    def proposals(self, batch: Dict):
        """Backbone + RPN: (proposals, objectness, valid), for probing."""
        features = self.backbone(self.model_images(batch))
        return self.proposal_generator(features, self._as_tensor(batch["image_size"]))[:3]

    def forward(self, batch: Dict, generator: Optional[torch.Generator] = None):
        """Detections, or the loss dict in training mode with gt in the batch.
        ``generator`` draws the RPN's and ROI heads' sampling priorities."""
        if self.training and "gt_boxes" in batch:
            return self._losses(batch, generator)
        with torch.no_grad():
            features = self.backbone(self.model_images(batch))
            image_sizes = self._as_tensor(batch["image_size"])
            proposals, _, prop_valid, _ = self.proposal_generator(features, image_sizes)
            return self.roi_heads(features, proposals, prop_valid, image_sizes)

    def _losses(self, batch: Dict, generator) -> Dict[str, torch.Tensor]:
        """The stages run in profiler ranges ``backbone``, ``rpn`` and
        ``roi_heads`` (a profiler reads each range's device time)."""
        with record_function("backbone"):
            features = self.backbone(self.model_images(batch))
        image_sizes = self._as_tensor(batch["image_size"])
        gt = {
            "boxes": self._as_tensor(batch["gt_boxes"]).float(),
            "classes": self._as_tensor(batch["gt_classes"]),
            "valid": self._as_tensor(batch["gt_valid"]).bool(),
        }
        if "gt_ignores" in batch:
            gt["ignores"] = self._as_tensor(batch["gt_ignores"]).bool()
        with record_function("rpn"):
            proposals, _, prop_valid, rpn_losses = self.proposal_generator(
                features, image_sizes, gt["boxes"], gt["valid"], gt.get("ignores"), generator
            )
        with record_function("roi_heads"):
            losses = dict(self.roi_heads(features, proposals, prop_valid, image_sizes, gt, generator))
        losses.update(rpn_losses)
        return losses
