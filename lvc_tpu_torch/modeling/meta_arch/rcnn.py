"""Generalized R-CNN (counterpart of ``lvc_tpu/modeling/meta_arch/rcnn.py``:
model_images:25, GeneralizedRCNN:55-131 (its gt masks and keypoints
:119-122), GeneralizedRCNN_Context:134-210, GeneralizedRCNNRegOnly:213,
ProposalNetwork:279).

The model takes the JAX package's batch dict, ``image`` (B, H, W, 3) raw
pixels in cfg INPUT.FORMAT order and ``image_size`` (B, 2) true (h, w) inside
the padded canvas. In eval mode it returns padded ``Detections`` (under
``no_grad``). In training mode with gt in the batch (``gt_boxes`` (B, G, 4),
``gt_classes`` (B, G), ``gt_valid`` (B, G), optional ``gt_ignores`` (B, G),
and for a mask or keypoint model ``gt_masks`` (B, G, Hm, Wm) and
``gt_keypoints`` (B, G, K, 3), which only ``GeneralizedRCNN`` passes on, as
in JAX) it returns the JAX loss dict: ``loss_rpn_cls``, ``loss_rpn_loc``,
``loss_cls``, ``loss_box_reg`` (and ``loss_mask``, ``loss_keypoint``). It runs on the device its parameters live on; the batch is
moved there. With the ``RBG`` proposal generator the proposals are jittered
gt boxes (plus ``proposal_boxes``/``proposal_logits``/``proposal_valid`` when
the batch holds them, which the loader's batches do not, as in JAX).
Without a proposal generator (``PROPOSAL_GENERATOR.NAME
"PrecomputedProposals"``) the proposals are the batch's ``proposal_boxes``
(B, R, 4), ``proposal_logits`` (B, R) and ``proposal_valid`` (B, R), in
training and in eval mode.
``GeneralizedRCNN_Context`` adds an image-level multi-label head (the loss
``loss_context``; in eval mode the dict ``{"detections", "image_scores"}``).
``GeneralizedRCNNRegOnly`` trains the same way and in eval mode regresses the
batch's gt slots as candidates (``RegOnlyOutput``); ``ProposalNetwork`` returns
the RPN's proposals as a dict.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from lvc_tpu_torch.modeling.backbone.fpn import FPN
from lvc_tpu_torch.modeling.layers import Conv2d, compute_dtype_scope
from lvc_tpu_torch.modeling.proposal_generator.rbg import RBG
from lvc_tpu_torch.modeling.proposal_generator.rpn import RPN
from lvc_tpu_torch.modeling.roi_heads.fast_rcnn import Detections
from lvc_tpu_torch.modeling.roi_heads.roi_heads import StandardROIHeads
from lvc_tpu_torch.modeling.sampling import Generators, global_ratio
from lvc_tpu_torch.utils.tracing import span


_PROPOSAL_KEYS = ("proposal_boxes", "proposal_logits", "proposal_valid")


class GeneralizedRCNN(nn.Module):
    """backbone -> RPN (or RBG) -> ROI heads."""

    train_ignores = True  # the gt ignore regions reach the ROI heads in training
    train_tasks = True  # so do the batch's gt masks and keypoints
    # every trainable parameter gets a gradient in every step (``build_model``
    # sets it on a model whose mask or keypoint head a batch without their gt leaves out)
    unused_parameters = False

    def __init__(
        self,
        backbone: FPN,
        proposal_generator: Optional[nn.Module],
        roi_heads: Optional[StandardROIHeads],
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

    def __call__(self, *args, **kwargs):
        # the convolutions and the heads' linears run in the compute dtype,
        # which JAX reads from its global at trace time
        with compute_dtype_scope(self.compute_dtype):
            return super().__call__(*args, **kwargs)

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
        with compute_dtype_scope(self.compute_dtype):
            return self.backbone(self.model_images(batch))

    @torch.no_grad()
    def proposals(self, batch: Dict):
        """Backbone + RPN: (proposals, objectness, valid), for probing."""
        with compute_dtype_scope(self.compute_dtype):
            features = self.backbone(self.model_images(batch))
            return self.proposal_generator(features, self._as_tensor(batch["image_size"]))[:3]

    def forward(self, batch: Dict, generator: Generators = None):
        """Detections, or the loss dict in training mode with gt in the batch.
        ``generator`` draws the RPN's and ROI heads' sampling priorities: a
        list of one generator per image (``sampling.per_image_generators``),
        or one that every image draws from in turn."""
        if self.training and "gt_boxes" in batch:
            return self._losses(batch, generator)
        with torch.no_grad():
            with span("backbone"):
                features = self.backbone(self.model_images(batch))
            image_sizes = self._as_tensor(batch["image_size"])
            with span("rpn"):
                proposals, _, prop_valid, _ = self._propose(batch, features, image_sizes)
            with span("roi_heads"):
                return self.roi_heads(features, proposals, prop_valid, image_sizes)

    def _gt(self, batch: Dict, ignores: bool = True, tasks: bool = False) -> Dict[str, torch.Tensor]:
        """The ROI heads' gt dict; with ``tasks`` also the batch's
        ``gt_masks`` and ``gt_keypoints`` (``masks``, ``keypoints``)."""
        gt = {
            "boxes": self._as_tensor(batch["gt_boxes"]).float(),
            "classes": self._as_tensor(batch["gt_classes"]),
            "valid": self._as_tensor(batch["gt_valid"]).bool(),
        }
        if ignores and "gt_ignores" in batch:
            gt["ignores"] = self._as_tensor(batch["gt_ignores"]).bool()
        for key, name in (("gt_masks", "masks"), ("gt_keypoints", "keypoints")):
            if tasks and key in batch:
                gt[name] = self._as_tensor(batch[key])
        return gt

    def _propose(self, batch: Dict, features, image_sizes, gt=None, generator=None):
        """The proposal generator's (proposals, objectness, valid, losses).
        RBG also takes the batch's precomputed proposals, the RPN the gt
        ignore regions."""
        gt = gt or {}
        if self.proposal_generator is None:  # PrecomputedProposals
            boxes, logits, valid = (self._as_tensor(batch[k]) for k in _PROPOSAL_KEYS)
            return boxes.float(), logits.float(), valid.bool(), {}
        if isinstance(self.proposal_generator, RBG):
            given = {k: self._as_tensor(batch[k]) for k in _PROPOSAL_KEYS if k in batch}
            return self.proposal_generator(
                features, image_sizes, gt.get("boxes"), gt.get("valid"), generator, **given
            )
        return self.proposal_generator(
            features, image_sizes, gt.get("boxes"), gt.get("valid"), gt.get("ignores"), generator
        )

    def _losses(self, batch: Dict, generator) -> Dict[str, torch.Tensor]:
        """The stages run in the spans ``backbone``, ``rpn`` and
        ``roi_heads`` (``utils/tracing.py``), as the eval forward's do."""
        with span("backbone"):
            features = self.backbone(self.model_images(batch))
        image_sizes = self._as_tensor(batch["image_size"])
        gt = self._gt(batch, ignores=self.train_ignores, tasks=self.train_tasks)
        with span("rpn"):
            proposals, _, prop_valid, rpn_losses = self._propose(batch, features, image_sizes, gt, generator)
        with span("roi_heads"):
            losses = dict(self.roi_heads(features, proposals, prop_valid, image_sizes, gt, generator))
        losses.update(rpn_losses)
        return losses


class GeneralizedRCNN_Context(GeneralizedRCNN):
    """``GeneralizedRCNN`` plus an image-level multi-label head (the reference
    rcnn.py:491-756): the raw ``context_in_feature`` map max-pooled over
    space, ReLU, then ``cont_cls`` (no bias), in float32 as flax promotes it.
    ``cont_conv`` is computed and its output discarded, as the reference
    does (rcnn.py:596-598), so its weights stay in the checkpoint. Training
    adds ``loss_context``, the stable BCE against the gt presence mask,
    normalised by ``global_ratio`` (its sum over the data-parallel group by
    the group's element count); with ``images_only`` it is the only loss.
    The RPN gets no ignore regions here, as in JAX. Eval mode returns
    ``{"detections", "image_scores"}`` (sigmoid of the logits, (B, K)), or
    ``{"image_scores"}`` alone with ``images_only``. ``cont_conv`` (and,
    with ``images_only``, the RPN, the ROI heads and the FPN levels below
    the context feature) gets no gradient; it stays trainable, so the
    optimizer steps it with a zero one (its weight decay), as optax does,
    and data-parallel training looks for the unused parameters."""

    unused_parameters = True

    def __init__(self, backbone, proposal_generator, roi_heads, num_classes: int, in_channels: int,
                 context_channels: int = 256, context_in_feature: str = "p5", images_only: bool = False,
                 **kwargs):
        super().__init__(backbone, proposal_generator, roi_heads, **kwargs)
        self.context_in_feature = context_in_feature
        self.images_only = images_only
        self.cont_conv = Conv2d(in_channels, context_channels, kernel_size=1)
        self.cont_cls = nn.Linear(in_channels, num_classes, bias=False)

    def context_logits(self, features: Dict[str, torch.Tensor]) -> torch.Tensor:
        feat = features[self.context_in_feature]
        self.cont_conv(feat)  # discarded, as in the reference
        x = torch.relu(feat.amax(dim=(2, 3))).float()
        return F.linear(x, self.cont_cls.weight)

    def forward(self, batch: Dict, generator: Generators = None):
        if self.training and "gt_boxes" in batch:
            return self._context_losses(batch, generator)
        with torch.no_grad():
            features = self.backbone(self.model_images(batch))
            image_scores = torch.sigmoid(self.context_logits(features))
            if self.images_only:
                return {"image_scores": image_scores}
            image_sizes = self._as_tensor(batch["image_size"])
            proposals, _, prop_valid, _ = self._propose(batch, features, image_sizes)
            dets = self.roi_heads(features, proposals, prop_valid, image_sizes)
        return {"detections": dets, "image_scores": image_scores}

    def _context_losses(self, batch: Dict, generator) -> Dict[str, torch.Tensor]:
        with span("backbone"):
            features = self.backbone(self.model_images(batch))
        gt = self._gt(batch)
        logits = self.context_logits(features)
        classes = torch.arange(logits.shape[1], device=logits.device)
        present = (gt["classes"][..., None] == classes) & gt["valid"][..., None]
        mask = present.any(dim=1).float()
        bce = torch.relu(logits) - logits * mask + torch.log1p(torch.exp(-logits.abs()))
        losses = {"loss_context": global_ratio(bce.sum(), float(bce.numel()))}
        if self.images_only:
            return losses
        image_sizes = self._as_tensor(batch["image_size"])
        with span("rpn"):
            proposals, _, prop_valid, rpn_losses = self._propose(
                batch, features, image_sizes, {"boxes": gt["boxes"], "valid": gt["valid"]}, generator
            )
        with span("roi_heads"):
            losses.update(self.roi_heads(features, proposals, prop_valid, image_sizes, gt, generator))
        losses.update(rpn_losses)
        return losses


class GeneralizedRCNNRegOnly(GeneralizedRCNN):
    """The box corrector's meta-architecture: trains like
    ``GeneralizedRCNN`` (the gt ignore flags do not reach the heads, as in
    JAX); in eval mode the batch's gt slots are the candidates, and the
    output is ``RegOnlyOutput`` aligned to them."""

    train_ignores = False
    train_tasks = False

    def forward(self, batch: Dict, generator: Generators = None):
        if self.training and "gt_boxes" in batch:
            return self._losses(batch, generator)
        with torch.no_grad():
            features = self.backbone(self.model_images(batch))
            gt = self._gt(batch, ignores=False)
            return self.roi_heads(
                features, gt["boxes"], gt["valid"], self._as_tensor(batch["image_size"]), gt,
                candidates_as_proposals=True,
            )


class ProposalNetwork(GeneralizedRCNN):
    """Backbone + RPN, for proposal extraction: in eval mode the dict of
    ``proposal_boxes`` (B, K, 4), ``objectness_logits`` (B, K) and
    ``proposal_valid`` (B, K); in training the RPN losses."""

    def __init__(self, backbone: FPN, proposal_generator: RPN, **kwargs):
        super().__init__(backbone, proposal_generator, None, **kwargs)

    def forward(self, batch: Dict, generator: Generators = None):
        if self.training and "gt_boxes" in batch:
            features = self.backbone(self.model_images(batch))
            gt = self._gt(batch, ignores=False)
            return self._propose(batch, features, self._as_tensor(batch["image_size"]), gt, generator)[3]
        with torch.no_grad():
            features = self.backbone(self.model_images(batch))
            boxes, logits, valid, _ = self._propose(batch, features, self._as_tensor(batch["image_size"]))
        return {"proposal_boxes": boxes, "objectness_logits": logits, "proposal_valid": valid}
