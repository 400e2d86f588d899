"""The extra ROI heads (counterpart of
``lvc_tpu/modeling/roi_heads/extra_heads.py``: Res5ROIHeads:30,
ParallelStandardROIHeads:103, CascadeStandardROIHeads:151,
StandardROIHeadsCascadeBBox:200).

- ``Res5ROIHeads``: the C4 head. It pools res4 (one level), runs a res5
  stage of three bottleneck blocks, mean-pools and predicts.
- ``ParallelStandardROIHeads``: twin ``StandardROIHeads``, base and novel,
  under ``roi_heads.{base,novel}``, the keys that
  ``tools/ckpt_surgery.py --method combine_parallel`` writes. The gt is split
  by seen id and remapped through ``SPLIT_IDS``; the merged detections have
  both heads' slots, in the joint class space.
- ``CascadeStandardROIHeads``: ``StandardROIHeads`` whose inference refines
  its boxes once: every candidate above the score threshold (no NMS, at most
  ``refine_candidates``) is pooled again and scored by the same head.
- ``StandardROIHeadsCascadeBBox``: ``StandardROIHeads`` plus a
  class-agnostic regressor branch trained on foreground slots whose gt is
  larger than ``bbox_min_area``.

Where JAX's class reads neither ``REG_OFF`` nor ``DEBUG``, neither does the
port's.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
from torch import nn

from lvc_tpu_torch.modeling.backbone.resnet import BottleneckBlock
from lvc_tpu_torch.modeling.proposal_generator.rpn import smooth_l1
from lvc_tpu_torch.modeling.roi_heads.fast_rcnn import BoxOnlyLayers, Detections, fast_rcnn_inference
from lvc_tpu_torch.modeling.roi_heads.roi_heads import StandardROIHeads
from lvc_tpu_torch.modeling.sampling import Generators, global_ratio


class Res5ROIHeads(StandardROIHeads):
    """Pool res4 at ``pooler_resolution`` (14), run ``res5.{0,1,2}`` (stride
    2 and a shortcut in the first block), mean-pool to
    ``RES2_OUT_CHANNELS * 8`` and predict. It has no ``box_head``."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.reg_off = self.debug = False

    def _build_box_heads(self, cls_agnostic_bbox_reg: bool, num_groups: int = 1, width_per_group: int = 64,
                         res2_out_channels: int = 256, stride_in_1x1: bool = True, resnet_norm: str = "FrozenBN",
                         output_layer: str = "FastRCNNOutputLayers", cosine_scale: float = 20.0) -> None:
        in_channels = self.head_args[0]
        out_channels = res2_out_channels * 8
        bottleneck = num_groups * width_per_group * 8
        self.res5 = nn.Sequential(*[
            BottleneckBlock(
                in_channels if b == 0 else out_channels, out_channels, bottleneck,
                stride=2 if b == 0 else 1, num_groups=num_groups, norm=resnet_norm,
                stride_in_1x1=stride_in_1x1, has_shortcut=(b == 0),
            )
            for b in range(3)
        ])
        self.head_dim = out_channels
        self._build_predictor(cls_agnostic_bbox_reg, output_layer, cosine_scale)

    def _box_features(self, features, boxes: torch.Tensor) -> torch.Tensor:
        pooled = self.pool(features, boxes)  # (B, R, P, P, C)
        x = pooled.reshape(-1, *pooled.shape[2:]).permute(0, 3, 1, 2)  # NCHW, channels_last memory
        return self.res5(x).mean(dim=(2, 3))


class ParallelStandardROIHeads(nn.Module):
    """Twin heads in ``roi_heads`` (a ``ModuleDict`` of ``base`` and
    ``novel``). Each draws its samples from the generators it is given, the
    base head first."""

    def __init__(self, base: StandardROIHeads, novel: StandardROIHeads, seen_ids: Sequence[int],
                 unseen_ids: Sequence[int], split_ids: Sequence[int]):
        super().__init__()
        self.roi_heads = nn.ModuleDict({"base": base, "novel": novel})
        for name, ids in (("seen", seen_ids), ("unseen", unseen_ids), ("split", split_ids)):
            self.register_buffer(name, torch.tensor(list(ids), dtype=torch.int64), persistent=False)

    def forward(
        self,
        features: Dict[str, torch.Tensor],
        proposals: torch.Tensor,
        proposal_valid: torch.Tensor,
        image_sizes: torch.Tensor,
        gt: Optional[Dict[str, torch.Tensor]] = None,
        generator: Generators = None,
    ):
        """The ``base_*`` and ``novel_*`` losses in training mode with ``gt``;
        otherwise ``Detections`` with both heads' slots, base first."""
        base, novel = self.roi_heads["base"], self.roi_heads["novel"]
        if self.training and gt is not None:
            cls = gt["classes"].long()
            is_seen = torch.isin(cls, self.seen)
            remapped = self.split[cls.clamp(0, self.split.shape[0] - 1)]
            losses = {}
            for prefix, head, keep in (("base", base, is_seen), ("novel", novel, ~is_seen)):
                twin_gt = dict(gt, classes=remapped, valid=gt["valid"] & keep)
                out = head(features, proposals, proposal_valid, image_sizes, twin_gt, generator)
                losses.update({f"{prefix}_{k}": v for k, v in out.items()})
            return losses
        dets_b = base(features, proposals, proposal_valid, image_sizes)
        dets_n = novel(features, proposals, proposal_valid, image_sizes)
        return Detections(
            boxes=torch.cat([dets_b.boxes, dets_n.boxes], 1),
            scores=torch.cat([dets_b.scores, dets_n.scores], 1),
            classes=torch.cat([self.seen[dets_b.classes], self.unseen[dets_n.classes]], 1),
            valid=torch.cat([dets_b.valid, dets_n.valid], 1),
            proposal_idx=torch.cat([dets_b.proposal_idx, dets_n.proposal_idx], 1),
        )


class CascadeStandardROIHeads(StandardROIHeads):
    """Training as ``StandardROIHeads``. Inference: pass 1 keeps every
    candidate above the score threshold (NMS threshold 1.5 suppresses
    nothing; the ``refine_candidates`` best, as JAX's fixed budget), whose
    decoded boxes the same head pools and scores again; pass 2 is the
    standard inference on them."""

    def __init__(self, *args, refine_candidates: int = 512, **kwargs):
        super().__init__(*args, **kwargs)
        self.refine_candidates = refine_candidates

    def forward(self, features, proposals, proposal_valid, image_sizes, gt=None, generator: Generators = None):
        if self.training and gt is not None:
            return self._losses(features, proposals, proposal_valid, gt, generator)
        probs, boxes = self._predict(features, proposals)
        init = fast_rcnn_inference(
            boxes, probs, image_sizes, proposal_valid, self.score_thresh, 1.5,
            self.refine_candidates, self.pre_nms_candidates,
        )
        probs, boxes = self._predict(features, init.boxes)
        return fast_rcnn_inference(
            boxes, probs, image_sizes, init.valid, self.score_thresh, self.nms_thresh,
            self.detections_per_image, self.pre_nms_candidates,
        )


class StandardROIHeadsCascadeBBox(StandardROIHeads):
    """``bbox_branch`` (``BoxOnlyLayers``) on the box head's features; its
    loss ``loss_box_reg_branch`` is the L1 (smooth-L1 at ``SMOOTH_L1_BETA``)
    of the class-agnostic deltas over foreground slots whose gt area exceeds
    ``bbox_min_area``, divided by all valid slots. Inference is the
    standard head's."""

    def __init__(self, *args, bbox_min_area: float = 200.0 ** 2, **kwargs):
        super().__init__(*args, **kwargs)
        self.bbox_min_area = bbox_min_area
        self.bbox_branch = BoxOnlyLayers(self.head_dim)

    def _losses(self, features, proposals, proposal_valid, gt, generator):
        sampled, x, scores, deltas = self._sample_and_predict(features, proposals, proposal_valid, gt, generator)
        losses = self._fast_rcnn_losses(sampled, scores, deltas)
        gt_b = sampled.gt_boxes.reshape(-1, 4)
        cls = sampled.gt_classes.reshape(-1)
        area = (gt_b[:, 2] - gt_b[:, 0]) * (gt_b[:, 3] - gt_b[:, 1])
        fg = sampled.valid.reshape(-1) & (cls >= 0) & (cls < self.num_classes) & (area > self.bbox_min_area)
        gt_deltas = self.box2box.get_deltas(sampled.boxes.reshape(-1, 4), gt_b)
        reg = smooth_l1(self.bbox_branch(x), gt_deltas, self.smooth_l1_beta).sum(-1)
        zero = torch.zeros((), device=reg.device)
        losses["loss_box_reg_branch"] = global_ratio(torch.where(fg, reg, zero).sum(), sampled.valid.sum())
        return losses
