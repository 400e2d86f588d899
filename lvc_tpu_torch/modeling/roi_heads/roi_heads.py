"""ROI heads (counterpart of ``lvc_tpu/modeling/roi_heads/roi_heads.py``:
SampledProposals:39, StandardROIHeads:47, label_and_sample_proposals:158-215,
pool:218-314, _mask_loss:316, _keypoint_loss:351, __call__:371-474).

In training mode with gt, the heads append the gt boxes to the proposals,
match and sample them, pool the sampled boxes and return the Fast R-CNN
losses; otherwise they return fixed-shape detections.

With ``mask_on`` (``MODEL.MASK_ON``) or ``keypoint_on`` the heads also hold
``mask_head`` or ``keypoint_head``, each pooling at its own resolution (14)
with the box pooler's implementation, sampling ratio and grid cap, as JAX
pools them (the ``ROI_MASK_HEAD``/``ROI_KEYPOINT_HEAD`` ``NAME``, ``NORM``
and ``POOLER_SAMPLING_RATIO`` keys are read by neither package). Training
adds ``loss_mask`` (when the gt holds ``masks``, (B, G, Hm, Wm) bitmasks at
any uniform scale of the canvas) and ``loss_keypoint`` (when it holds
``keypoints``, (B, G, K, 3) image coordinates and visibility). As in JAX,
they pool all B x S sampled slots and mask the non-foreground ones in the
loss, where detectron2 pools the foreground alone. Inference adds the
detections' ``masks`` (B, D, 2P, 2P) and ``keypoints`` (B, D, K, 3), from
the detection boxes of every slot, valid or not.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Sequence

import torch
from torch import nn

from lvc_tpu_torch.modeling.box_regression import Box2BoxTransform
from lvc_tpu_torch.modeling.matcher import Matcher
from lvc_tpu_torch.modeling.roi_heads.box_head import FastRCNNConvFCHead
from lvc_tpu_torch.modeling.roi_heads.fast_rcnn import (
    CosineSimOutputLayers,
    Detections,
    FastRCNNOutputLayers,
    fast_rcnn_inference,
    fast_rcnn_losses,
)
from lvc_tpu_torch.modeling.roi_heads.fast_rcnn_debug import fast_rcnn_inference_debug
from lvc_tpu_torch.modeling.roi_heads.keypoint_head import (
    KRCNNConvDeconvUpsampleHead,
    keypoint_rcnn_inference,
    keypoint_rcnn_loss,
)
from lvc_tpu_torch.modeling.roi_heads.mask_head import (
    MaskRCNNConvUpsampleHead,
    crop_gt_masks,
    mask_rcnn_inference,
    mask_rcnn_loss,
)
from lvc_tpu_torch.modeling.sampling import Generators, image_generator, subsample_labels
from lvc_tpu_torch.ops import roi_align
from lvc_tpu_torch.structures import boxes as box_ops
from lvc_tpu_torch.utils.tracing import count, span

_POOLER_IMPLS = ("auto", "pallas", "pallas_fast", "pallas_band", "pallas_train",
                 "pallas_train_flat", "exact")


class SampledProposals(NamedTuple):
    boxes: torch.Tensor  # (B, S, 4)
    gt_boxes: torch.Tensor  # (B, S, 4) matched gt (garbage for background rows)
    gt_classes: torch.Tensor  # (B, S) in [0, K] (K = background); -1 = ignore
    valid: torch.Tensor  # (B, S)
    gt_idx: torch.Tensor  # (B, S) matched gt row


class StandardROIHeads(nn.Module):
    """Pooler -> conv/fc head -> output layer, with train-time sampling."""

    def __init__(
        self,
        in_features: Sequence[str],
        strides: Dict[str, int],
        in_channels: int,
        num_classes: int = 80,
        pooler_resolution: int = 7,
        pooler_sampling_ratio: int = 0,
        pooler_max_grid: int = 2,
        num_conv: int = 0,
        conv_dim: int = 256,
        num_fc: int = 2,
        fc_dim: int = 1024,
        head_norm: str = "",
        cls_agnostic_bbox_reg: bool = False,
        bbox_reg_weights=(10.0, 10.0, 5.0, 5.0),
        score_thresh_test: float = 0.05,
        nms_thresh_test: float = 0.5,
        detections_per_image: int = 100,
        pre_nms_candidates: int = 2048,
        pooler_impl: str = "auto",
        canonical_box_size: int = 224,
        canonical_level: int = 4,
        iou_thresholds: Sequence[float] = (0.5,),
        iou_labels: Sequence[int] = (0, 1),
        batch_size_per_image: int = 512,
        positive_fraction: float = 0.25,
        proposal_append_gt: bool = True,
        dropout: float = 0.0,
        smooth_l1_beta: float = 0.0,
        box_reg_loss_type: str = "smooth_l1",
        reg_off: bool = False,
        debug: bool = False,
        mask_on: bool = False,
        mask_num_conv: int = 4,
        mask_conv_dim: int = 256,
        mask_pooler_resolution: int = 14,
        cls_agnostic_mask: bool = False,
        keypoint_on: bool = False,
        num_keypoints: int = 17,
        keypoint_num_conv: int = 8,
        keypoint_conv_dim: int = 512,
        keypoint_pooler_resolution: int = 14,
        **head_options,
    ):
        """``head_options`` go to ``_build_box_heads`` (the cascade heads'
        stage options, the C4 head's res5 options). ``debug`` (``cfg.DEBUG``)
        makes inference return ``DetectionsDebug``. The ``mask_*`` and
        ``keypoint_*`` options build the mask and keypoint heads."""
        super().__init__()
        if pooler_impl == "tiled":
            raise NotImplementedError(
                "POOLER_IMPL 'tiled' (an XLA slice-gather form) is not ported; "
                "use exact or a pallas* pool"
            )
        if pooler_impl not in _POOLER_IMPLS:
            raise ValueError(f"unknown POOLER_IMPL {pooler_impl!r}")
        self.in_features = tuple(in_features)
        self.strides = tuple(strides[f] for f in self.in_features)
        self.num_classes = num_classes
        self.pooler_impl = pooler_impl
        self.pooler_resolution = pooler_resolution
        self.pooler_sampling_ratio = pooler_sampling_ratio
        self.pooler_max_grid = pooler_max_grid
        self.canonical_box_size = canonical_box_size
        self.canonical_level = canonical_level
        self.head_args = (in_channels, pooler_resolution, num_conv, conv_dim, num_fc, fc_dim, head_norm, dropout)
        self.head_dim = fc_dim if num_fc else conv_dim * pooler_resolution ** 2
        self.box2box = Box2BoxTransform(bbox_reg_weights)
        self.proposal_matcher = Matcher(iou_thresholds, iou_labels, allow_low_quality_matches=False)
        self._build_box_heads(cls_agnostic_bbox_reg, **head_options)
        self.pos_threshold = iou_thresholds[0]
        self.batch_size_per_image = batch_size_per_image
        self.positive_fraction = positive_fraction
        self.proposal_append_gt = proposal_append_gt
        self.smooth_l1_beta = smooth_l1_beta
        self.box_reg_loss_type = box_reg_loss_type
        self.reg_off = reg_off
        self.debug = debug
        self.score_thresh = score_thresh_test
        self.nms_thresh = nms_thresh_test
        self.detections_per_image = detections_per_image
        self.pre_nms_candidates = pre_nms_candidates
        self.mask_on, self.keypoint_on = mask_on, keypoint_on
        self.mask_pooler_resolution = mask_pooler_resolution
        self.keypoint_pooler_resolution = keypoint_pooler_resolution
        if mask_on:
            self.mask_head = MaskRCNNConvUpsampleHead(
                in_channels, num_classes, mask_num_conv, mask_conv_dim, cls_agnostic_mask
            )
        if keypoint_on:
            self.keypoint_head = KRCNNConvDeconvUpsampleHead(
                in_channels, num_keypoints, keypoint_num_conv, keypoint_conv_dim
            )

    def _build_box_heads(self, cls_agnostic_bbox_reg: bool, output_layer: str = "FastRCNNOutputLayers",
                         cosine_scale: float = 20.0) -> None:
        """``box_head`` and ``box_predictor``: ``CosineSimOutputLayers`` when
        ``output_layer`` names it, else ``FastRCNNOutputLayers``, as JAX
        chooses. Subclasses build their own heads here from their own
        options."""
        self.box_head = FastRCNNConvFCHead(*self.head_args)
        self._build_predictor(cls_agnostic_bbox_reg, output_layer, cosine_scale)

    def _build_predictor(self, cls_agnostic_bbox_reg: bool, output_layer: str, cosine_scale: float) -> None:
        if output_layer == "CosineSimOutputLayers":
            self.box_predictor = CosineSimOutputLayers(
                self.head_dim, self.num_classes, cosine_scale, cls_agnostic_bbox_reg
            )
        else:
            self.box_predictor = FastRCNNOutputLayers(self.head_dim, self.num_classes, cls_agnostic_bbox_reg)

    # ------------------------------------------------------------- sampling
    def label_and_sample_proposals(
        self,
        proposals: torch.Tensor,  # (B, P, 4)
        proposal_valid: torch.Tensor,  # (B, P)
        gt_boxes: torch.Tensor,  # (B, G, 4)
        gt_classes: torch.Tensor,  # (B, G)
        gt_valid: torch.Tensor,  # (B, G)
        gt_ignores: Optional[torch.Tensor] = None,  # (B, G)
        generator: Generators = None,
    ) -> SampledProposals:
        """Append gt, match (ignore gt never matches; a proposal over an
        ignore region above the fg threshold, or in an invalid slot, is never
        sampled), label fg with the gt class, bg with K and ignore with -1,
        then sample per image."""
        if self.proposal_append_gt:
            proposals = torch.cat([proposals, gt_boxes.to(proposals.dtype)], dim=1)
            proposal_valid = torch.cat([proposal_valid, gt_valid], dim=1)
        iou = box_ops.pairwise_iou(gt_boxes, proposals)  # (B, G, P)
        real = gt_valid if gt_ignores is None else gt_valid & ~gt_ignores
        matched_idx, labels = self.proposal_matcher(iou, real)
        minus = torch.full_like(labels, -1)
        if gt_ignores is not None:
            zero = torch.zeros((), device=iou.device)
            max_ig = torch.where((gt_valid & gt_ignores)[..., None], iou, zero).amax(1)
            labels = torch.where(max_ig > self.pos_threshold, minus, labels)
        labels = torch.where(proposal_valid, labels, minus)
        cls = torch.where(
            labels == 1,
            torch.gather(gt_classes.long(), 1, matched_idx),
            torch.where(labels == 0, self.num_classes, -1),
        )

        out = []
        for b in range(proposals.shape[0]):
            idxs, _, slot_valid = subsample_labels(
                labels[b], self.batch_size_per_image, self.positive_fraction, image_generator(generator, b)
            )
            gt_idx = matched_idx[b][idxs]
            out.append((
                proposals[b][idxs], gt_boxes[b][gt_idx],
                torch.where(slot_valid, cls[b][idxs], -1), slot_valid, gt_idx,
            ))
        return SampledProposals(*(torch.stack(t) for t in zip(*out)))

    # --------------------------------------------------------------- pooling
    def pool(self, features: Dict[str, torch.Tensor], boxes: torch.Tensor,
             output_size: Optional[int] = None) -> torch.Tensor:
        """features: per-level (B, C, H, W) in channels_last memory; boxes
        (B, R, 4) -> (B, R, P, P, C) in the feature dtype, P the
        ``output_size`` (default ``pooler_resolution``).

        In eval mode: pallas_fast / pallas_band -> the band kernel (K1); auto
        / pallas on CUDA -> the paired kernel (K2), as "auto -> pallas on the
        accelerator" in JAX; auto off CUDA and exact -> the torch point
        gather. In training mode: auto -> pallas_train on CUDA and exact off
        it; every other pallas* -> pallas_train. pallas_train and
        pallas_train_flat (either mode) -> the differentiable paired pool
        (K2 forward, K3 backward)."""
        # NCHW channels_last -> a contiguous (B, H, W, C) view, no copy
        feats = [features[f].permute(0, 2, 3, 1) for f in self.in_features]
        impl = self.pooler_impl
        on_cuda = feats[0].is_cuda
        if self.training:
            if impl == "auto":
                impl = "pallas_train" if on_cuda else "exact"
            elif impl.startswith("pallas") and not impl.startswith("pallas_train"):
                impl = "pallas_train"
        elif impl == "auto":
            impl = "pallas" if on_cuda else "exact"
        max_grid = self.pooler_max_grid
        if impl.startswith("pallas"):
            # the kernels' band and pair layouts assume a sampling grid <= 2
            max_grid = min(max_grid, 2)
        kwargs = dict(
            output_size=output_size or self.pooler_resolution,
            sampling_ratio=self.pooler_sampling_ratio,
            max_grid=max_grid,
            min_level=int(math.log2(self.strides[0])),
            canonical_box_size=self.canonical_box_size,
            canonical_level=self.canonical_level,
        )
        if impl == "pallas_fast":
            return roi_align.pool_band(feats, boxes, self.strides, patch=True, **kwargs)
        if impl == "pallas_band":
            return roi_align.pool_band(feats, boxes, self.strides, patch=False, **kwargs)
        if impl == "pallas":
            return roi_align.pool_paired(feats, boxes, self.strides, **kwargs)
        if impl in ("pallas_train", "pallas_train_flat"):
            return roi_align.pool_paired_train(feats, boxes, self.strides, **kwargs)
        return roi_align.batched_multilevel_roi_align(feats, boxes, self.strides, **kwargs)

    # --------------------------------------------------------------- forward
    def forward(
        self,
        features: Dict[str, torch.Tensor],
        proposals: torch.Tensor,  # (B, R, 4)
        proposal_valid: torch.Tensor,  # (B, R)
        image_sizes: torch.Tensor,  # (B, 2)
        gt: Optional[Dict[str, torch.Tensor]] = None,
        generator: Generators = None,
    ):
        """Detections, or in training mode with ``gt`` (boxes, classes, valid,
        optional ignores, masks and keypoints) the dict of ``loss_cls`` and
        ``loss_box_reg`` (and ``loss_mask``, ``loss_keypoint``)."""
        if self.training and gt is not None:
            return self._losses(features, proposals, proposal_valid, gt, generator)
        probs, boxes = self._predict(features, proposals)
        infer = fast_rcnn_inference_debug if self.debug else fast_rcnn_inference
        dets = infer(
            boxes, probs, image_sizes, proposal_valid, self.score_thresh,
            self.nms_thresh, self.detections_per_image, self.pre_nms_candidates,
        )
        return self._task_outputs(features, dets)

    def _task_outputs(self, features, dets):
        """The detections with the mask and keypoint heads' outputs on their
        boxes."""
        B, D = dets.classes.shape
        if self.mask_on:
            with span("roi_heads.mask"):
                count("mask.slots", B * D)
                count("mask.fg_slots", lambda: dets.valid.sum())
                pooled = self.pool(features, dets.boxes, self.mask_pooler_resolution)
                logits = self.mask_head(pooled.reshape(B * D, *pooled.shape[2:]))
                masks = mask_rcnn_inference(logits, dets.classes.reshape(B * D))
                dets = dets._replace(masks=masks.reshape(B, D, *masks.shape[1:]))
        if self.keypoint_on:
            pooled = self.pool(features, dets.boxes, self.keypoint_pooler_resolution)
            logits = self.keypoint_head(pooled.reshape(B * D, *pooled.shape[2:]))
            kps = keypoint_rcnn_inference(logits, dets.boxes.reshape(B * D, 4))
            dets = dets._replace(keypoints=kps.reshape(B, D, *kps.shape[1:]))
        return dets

    def _box_features(self, features, boxes: torch.Tensor) -> torch.Tensor:
        """(B, R, 4) boxes -> the (B * R, D) features the predictor takes."""
        pooled = self.pool(features, boxes)  # (B, R, P, P, C)
        return self.box_head(pooled.reshape(-1, *pooled.shape[2:]))

    def _predict(self, features, boxes: torch.Tensor):
        """Softmax probabilities (B, R, K+1) and per-class decoded boxes."""
        B, R = boxes.shape[:2]
        scores, deltas = self.box_predictor(self._box_features(features, boxes))
        probs = torch.softmax(scores, dim=-1).reshape(B, R, -1)
        return probs, self.box2box.apply_deltas(deltas.reshape(B, R, -1), boxes)

    def _sample_and_predict(self, features, proposals, proposal_valid, gt, generator):
        """The sampled slots, their head features and the predictor's
        (scores, deltas)."""
        sampled = self.label_and_sample_proposals(
            proposals, proposal_valid, gt["boxes"], gt["classes"], gt["valid"],
            gt.get("ignores"), generator,
        )
        x = self._box_features(features, sampled.boxes)
        return (sampled, x) + tuple(self.box_predictor(x))

    def _fast_rcnn_losses(self, sampled: SampledProposals, scores, deltas):
        B, S = sampled.gt_classes.shape
        return fast_rcnn_losses(
            scores, deltas, sampled.boxes.reshape(B * S, 4), sampled.gt_boxes.reshape(B * S, 4),
            sampled.gt_classes.reshape(B * S), sampled.valid.reshape(B * S), self.box2box,
            self.smooth_l1_beta, self.box_reg_loss_type,
        )

    def _losses(self, features, proposals, proposal_valid, gt, generator):
        sampled, _, scores, deltas = self._sample_and_predict(features, proposals, proposal_valid, gt, generator)
        if self.reg_off:
            # REG_OFF (roi_heads.py:397-400): the regression branch is off
            deltas = deltas * 0.0
        losses = self._fast_rcnn_losses(sampled, scores, deltas)
        fg = sampled.valid & (sampled.gt_classes >= 0) & (sampled.gt_classes < self.num_classes)
        if self.mask_on and "masks" in gt:
            losses["loss_mask"] = self._mask_loss(features, sampled, gt["masks"], fg)
        if self.keypoint_on and "keypoints" in gt:
            losses["loss_keypoint"] = self._keypoint_loss(features, sampled, gt["keypoints"], fg)
        return losses

    def _mask_loss(self, features, sampled: SampledProposals, gt_masks: torch.Tensor, fg: torch.Tensor):
        """BCE of every sampled slot's mask against its matched gt bitmask
        cropped to the box; the bitmasks' scale of the canvas is read from
        their height. In the span ``roi_heads.mask``, with the counters
        ``mask.slots`` (slots pooled) and ``mask.fg_slots`` (foreground
        among them: a host read, made only while a profiler records)."""
        B, S = sampled.gt_classes.shape
        G = gt_masks.shape[1]
        M = 2 * self.mask_pooler_resolution  # the head upsamples 2x
        canvas_h = features[self.in_features[0]].shape[2] * self.strides[0]
        scale = gt_masks.shape[2] / canvas_h
        with span("roi_heads.mask"):
            count("mask.slots", B * S)
            count("mask.fg_slots", lambda: fg.sum())
            pooled = self.pool(features, sampled.boxes, self.mask_pooler_resolution)
            logits = self.mask_head(pooled.reshape(B * S, *pooled.shape[2:]))
            image = torch.arange(B, device=fg.device)[:, None] * G
            crops = crop_gt_masks(
                gt_masks.reshape(B * G, *gt_masks.shape[2:]), sampled.boxes.reshape(B * S, 4) * scale,
                (sampled.gt_idx + image).reshape(B * S), M,
            )
            return mask_rcnn_loss(logits, crops, sampled.gt_classes.reshape(B * S), fg.reshape(B * S))

    def _keypoint_loss(self, features, sampled: SampledProposals, gt_keypoints: torch.Tensor, fg: torch.Tensor):
        """Heatmap CE of every sampled slot against its matched gt's
        keypoints."""
        B, S = sampled.gt_classes.shape
        K = gt_keypoints.shape[2]
        pooled = self.pool(features, sampled.boxes, self.keypoint_pooler_resolution)
        logits = self.keypoint_head(pooled.reshape(B * S, *pooled.shape[2:]))
        kps = torch.gather(gt_keypoints.float(), 1, sampled.gt_idx[..., None, None].expand(-1, -1, K, 3))
        return keypoint_rcnn_loss(logits, kps.reshape(B * S, K, 3), sampled.boxes.reshape(B * S, 4), fg.reshape(B * S))
