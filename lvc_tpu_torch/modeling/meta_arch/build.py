"""Model construction from config (counterpart of
``lvc_tpu/modeling/meta_arch/build.py``: _build_generalized_rcnn:195,
build_model:366). Only ``GeneralizedRCNN`` with a ResNet-FPN backbone, the
RPN and ``StandardROIHeads`` is ported.
"""
from __future__ import annotations

import torch

from lvc_tpu_torch.modeling.backbone.fpn import build_resnet_fpn_backbone, fpn_strides
from lvc_tpu_torch.modeling.meta_arch.rcnn import GeneralizedRCNN
from lvc_tpu_torch.modeling.proposal_generator.rpn import RPN
from lvc_tpu_torch.modeling.roi_heads.roi_heads import StandardROIHeads

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_device(device=None) -> torch.device:
    """``cuda`` unless the caller asks for another device. There is no
    silent fallback: asking for CUDA without a GPU raises."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "lvc_tpu_torch runs on CUDA by default and no GPU was found; "
            "pass device='cpu' to run on the CPU"
        )
    return device


def _unported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP.md {item})")


def build_model(cfg, device=None) -> GeneralizedRCNN:
    """cfg -> ``GeneralizedRCNN`` on ``device`` (default ``cuda``), with
    parameters in float32 and activations in ``MODEL.DTYPE``. Weights come
    from ``checkpoint.convert.from_flax`` or ``utils.init.damped_init``."""
    device = resolve_device(device)
    m = cfg.MODEL
    if m.META_ARCHITECTURE != "GeneralizedRCNN":
        _unported(f"META_ARCHITECTURE {m.META_ARCHITECTURE!r}", "queue 1, items 9-10")
    if m.BACKBONE.NAME != "build_resnet_fpn_backbone":
        _unported(f"backbone {m.BACKBONE.NAME!r}", "queue 1, item 10")
    if m.PROPOSAL_GENERATOR.NAME != "RPN":
        _unported(f"proposal generator {m.PROPOSAL_GENERATOR.NAME!r}", "queue 1, item 9")
    if m.ROI_HEADS.NAME != "StandardROIHeads":
        _unported(f"ROI heads {m.ROI_HEADS.NAME!r}", "queue 1, item 9")
    if m.ROI_HEADS.OUTPUT_LAYER != "FastRCNNOutputLayers":
        _unported(f"output layer {m.ROI_HEADS.OUTPUT_LAYER!r}", "queue 1, item 5")
    if m.MASK_ON or m.KEYPOINT_ON:
        _unported("mask and keypoint heads", "queue 1, item 10")
    if m.DTYPE not in _DTYPES:
        raise ValueError(f"MODEL.DTYPE {m.DTYPE!r}")

    backbone = build_resnet_fpn_backbone(cfg)
    strides = fpn_strides(m.FPN.IN_FEATURES)
    rpn = RPN(
        in_features=tuple(m.RPN.IN_FEATURES),
        strides=strides,
        in_channels=m.FPN.OUT_CHANNELS,
        anchor_sizes=tuple(tuple(s) for s in m.ANCHOR_GENERATOR.SIZES),
        anchor_aspect_ratios=tuple(tuple(a) for a in m.ANCHOR_GENERATOR.ASPECT_RATIOS),
        anchor_offset=m.ANCHOR_GENERATOR.OFFSET,
        bbox_reg_weights=tuple(m.RPN.BBOX_REG_WEIGHTS),
        pre_nms_topk_test=m.RPN.PRE_NMS_TOPK_TEST,
        post_nms_topk_test=m.RPN.POST_NMS_TOPK_TEST,
        nms_thresh=m.RPN.NMS_THRESH,
        min_box_size=float(m.PROPOSAL_GENERATOR.MIN_SIZE),
    )
    h = m.ROI_BOX_HEAD
    roi_heads = StandardROIHeads(
        in_features=tuple(m.ROI_HEADS.IN_FEATURES),
        strides=strides,
        in_channels=m.FPN.OUT_CHANNELS,
        num_classes=m.ROI_HEADS.NUM_CLASSES,
        pooler_resolution=h.POOLER_RESOLUTION,
        pooler_sampling_ratio=h.POOLER_SAMPLING_RATIO,
        pooler_max_grid=h.POOLER_MAX_GRID,
        num_conv=h.NUM_CONV,
        conv_dim=h.CONV_DIM,
        num_fc=h.NUM_FC,
        fc_dim=h.FC_DIM,
        head_norm=h.NORM,
        cls_agnostic_bbox_reg=h.CLS_AGNOSTIC_BBOX_REG,
        bbox_reg_weights=tuple(h.BBOX_REG_WEIGHTS),
        score_thresh_test=m.ROI_HEADS.SCORE_THRESH_TEST,
        nms_thresh_test=m.ROI_HEADS.NMS_THRESH_TEST,
        detections_per_image=cfg.TEST.DETECTIONS_PER_IMAGE,
        pooler_impl=m.ROI_HEADS.POOLER_IMPL,
    )
    model = GeneralizedRCNN(
        backbone, rpn, roi_heads,
        pixel_mean=tuple(m.PIXEL_MEAN), pixel_std=tuple(m.PIXEL_STD),
        compute_dtype=_DTYPES[m.DTYPE],
    )
    return model.to(device=device, memory_format=torch.channels_last).eval()
