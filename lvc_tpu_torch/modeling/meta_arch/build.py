"""Model construction from config (counterpart of
``lvc_tpu/modeling/meta_arch/build.py``: build_roi_heads:63-85,
build_rpn:34, _roi_heads_kwargs:125, build_proposal_generator:170-191,
_build_generalized_rcnn:195, _build_generalized_rcnn_reg_only:208-221,
_build_generalized_rcnn_context:224-241, _build_rpn_comp:244-254,
_build_proposal_network:352-361, build_model:366). Ported: the ResNet-FPN
backbone and the plain ResNet (``build_resnet_backbone``, the C4 models:
res4 features, and RPNComp's res5); ``GeneralizedRCNN``,
``GeneralizedRCNNRegOnly``, ``GeneralizedRCNN_Context``, ``RPNComp`` and
``ProposalNetwork``; the RPN (or ``RPN_Ignore``) and ``RBG`` proposal
generators, and ``PrecomputedProposals`` (no generator: the batch carries
the proposals); every ROI head JAX's ``build_roi_heads`` builds:
``StandardROIHeads`` (with ``FastRCNNOutputLayers`` or
``CosineSimOutputLayers``, and the debug inference under ``cfg.DEBUG``),
``CascadeROIHeads``, ``CascadeUBBRROIHeads``, ``UBBRROIHeads``,
``Res5ROIHeads``, ``StandardROIHeadsCascadeBBox``, ``CascadeStandardROIHeads``
and ``ParallelStandardROIHeads``, with their training keys; the mask and
keypoint heads (``MODEL.MASK_ON``, ``MODEL.KEYPOINT_ON``,
``ROI_MASK_HEAD.{NUM_CONV, CONV_DIM, POOLER_RESOLUTION, CLS_AGNOSTIC_MASK}``
(not ``NORM``, which JAX does not read),
``ROI_KEYPOINT_HEAD.{NUM_KEYPOINTS, NUM_CONV, CONV_DIM, POOLER_RESOLUTION}``,
``lvc_tpu/modeling/meta_arch/build.py:156-165``) in the heads that JAX
builds them in and with what they do there; and the dense meta-architectures
(``:257-352``): ``SemanticSegmentor`` and ``PanopticFPN`` with the
``SemSegFPNHead`` of ``MODEL.SEM_SEG_HEAD`` (PanopticFPN's RPN and ROI heads
as ``GeneralizedRCNN``'s), and ``RetinaNet`` on its own FPN:
``FPN.IN_FEATURES`` or res3-res5 with the ``p6p7`` top block, strides
``2**level``, and the anchor sizes of ``ANCHOR_GENERATOR.SIZES`` unless their
count is not the number of levels, when each level gets the three octaves
``stride * 4 * 2**(o / 3)`` (JAX's rule, ``:318-326``: Base-RCNN-FPN's five
one-size entries give 3 anchors a location, the RetinaNet yaml's 9). The
RPN and the ROI heads take the channel count of the backbone's output
feature. The backbones are ``build_resnet_fpn_backbone``,
``build_resnet_backbone`` and ``build_swin_transformer_fpn_backbone``
(Swin-T/S/B under an FPN of res2-res5); another name raises ``ValueError``,
as JAX's ``build_backbone`` does (``:31``).
"""
from __future__ import annotations

import torch

from lvc_tpu_torch.modeling.backbone.fpn import FPN, build_resnet_fpn_backbone, build_swin_fpn_backbone, fpn_strides
from lvc_tpu_torch.modeling.backbone.resnet import RESNET_STAGE_STRIDES, build_resnet, resnet_out_channels
from lvc_tpu_torch.modeling.meta_arch.rcnn import (
    GeneralizedRCNN,
    GeneralizedRCNN_Context,
    GeneralizedRCNNRegOnly,
    ProposalNetwork,
)
from lvc_tpu_torch.modeling.meta_arch.panoptic_fpn import PanopticFPN
from lvc_tpu_torch.modeling.meta_arch.retinanet import RetinaNet
from lvc_tpu_torch.modeling.meta_arch.rpn_comp import RPNComp
from lvc_tpu_torch.modeling.meta_arch.semantic_seg import SemanticSegmentor, SemSegFPNHead
from lvc_tpu_torch.modeling.proposal_generator.rbg import RBG
from lvc_tpu_torch.modeling.proposal_generator.rpn import RPN
from lvc_tpu_torch.modeling.roi_heads.cascade_rcnn import (
    CascadeROIHeads,
    CascadeUBBRROIHeads,
    UBBRROIHeads,
)
from lvc_tpu_torch.modeling.roi_heads.extra_heads import (
    CascadeStandardROIHeads,
    ParallelStandardROIHeads,
    Res5ROIHeads,
    StandardROIHeadsCascadeBBox,
)
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


_META_ARCHS = {
    "GeneralizedRCNN": GeneralizedRCNN,
    "GeneralizedRCNNRegOnly": GeneralizedRCNNRegOnly,
    "GeneralizedRCNN_Context": GeneralizedRCNN_Context,
    "ProposalNetwork": ProposalNetwork,
    "RPNComp": RPNComp,
    "RetinaNet": RetinaNet,
    "SemanticSegmentor": SemanticSegmentor,
    "PanopticFPN": PanopticFPN,
}
_ROI_HEADS = {  # the heads built from the common options alone
    "StandardROIHeads": StandardROIHeads,
    "UBBRROIHeads": UBBRROIHeads,
    "StandardROIHeadsCascadeBBox": StandardROIHeadsCascadeBBox,
    "CascadeStandardROIHeads": CascadeStandardROIHeads,
}


def build_backbone(cfg):
    """(backbone, the stride of each output feature, the channels of each)."""
    m = cfg.MODEL
    if m.BACKBONE.NAME == "build_resnet_backbone":
        return build_resnet(cfg), dict(RESNET_STAGE_STRIDES), resnet_out_channels(cfg)
    if m.BACKBONE.NAME == "build_swin_transformer_fpn_backbone":
        strides = fpn_strides(("res2", "res3", "res4", "res5"))
        return build_swin_fpn_backbone(cfg), strides, {f: m.FPN.OUT_CHANNELS for f in strides}
    if m.BACKBONE.NAME != "build_resnet_fpn_backbone":
        raise ValueError(f"Unknown backbone: {m.BACKBONE.NAME}")
    strides = fpn_strides(m.FPN.IN_FEATURES)
    return build_resnet_fpn_backbone(cfg), strides, {f: m.FPN.OUT_CHANNELS for f in strides}


def build_rpn(cfg, strides, in_channels: int) -> RPN:
    m = cfg.MODEL
    return RPN(
        in_features=tuple(m.RPN.IN_FEATURES),
        strides=strides,
        in_channels=in_channels,
        anchor_sizes=tuple(tuple(s) for s in m.ANCHOR_GENERATOR.SIZES),
        anchor_aspect_ratios=tuple(tuple(a) for a in m.ANCHOR_GENERATOR.ASPECT_RATIOS),
        anchor_offset=m.ANCHOR_GENERATOR.OFFSET,
        bbox_reg_weights=tuple(m.RPN.BBOX_REG_WEIGHTS),
        pre_nms_topk_test=m.RPN.PRE_NMS_TOPK_TEST,
        post_nms_topk_test=m.RPN.POST_NMS_TOPK_TEST,
        nms_thresh=m.RPN.NMS_THRESH,
        min_box_size=float(m.PROPOSAL_GENERATOR.MIN_SIZE),
        iou_thresholds=tuple(m.RPN.IOU_THRESHOLDS),
        iou_labels=tuple(m.RPN.IOU_LABELS),
        batch_size_per_image=m.RPN.BATCH_SIZE_PER_IMAGE,
        positive_fraction=m.RPN.POSITIVE_FRACTION,
        smooth_l1_beta=m.RPN.SMOOTH_L1_BETA,
        loss_weight=m.RPN.LOSS_WEIGHT,
        pre_nms_topk_train=m.RPN.PRE_NMS_TOPK_TRAIN,
        post_nms_topk_train=m.RPN.POST_NMS_TOPK_TRAIN,
        ignore_regions=m.PROPOSAL_GENERATOR.NAME == "RPN_Ignore",
    )


def build_proposal_generator(cfg, strides, in_channels: int):
    m = cfg.MODEL
    if m.PROPOSAL_GENERATOR.NAME == "RBG":
        return RBG(
            alpha=m.RBG.ALPHA,
            beta=m.RBG.BETA,
            t=m.RBG.T,
            batch_size_per_image=m.ROI_HEADS.BATCH_SIZE_PER_IMAGE,
            positive_fraction=m.ROI_HEADS.POSITIVE_FRACTION,
        )
    if m.PROPOSAL_GENERATOR.NAME == "PrecomputedProposals":
        return None
    if m.PROPOSAL_GENERATOR.NAME not in ("RPN", "RPN_Ignore"):
        raise ValueError(f"unknown proposal generator {m.PROPOSAL_GENERATOR.NAME!r}")
    return build_rpn(cfg, strides, in_channels)


def build_roi_heads(cfg, strides, in_channels: int):
    m = cfg.MODEL
    h = m.ROI_BOX_HEAD
    common = dict(
        in_features=tuple(m.ROI_HEADS.IN_FEATURES),
        strides=strides,
        in_channels=in_channels,
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
        iou_thresholds=tuple(m.ROI_HEADS.IOU_THRESHOLDS),
        iou_labels=tuple(m.ROI_HEADS.IOU_LABELS),
        batch_size_per_image=m.ROI_HEADS.BATCH_SIZE_PER_IMAGE,
        positive_fraction=m.ROI_HEADS.POSITIVE_FRACTION,
        proposal_append_gt=m.ROI_HEADS.PROPOSAL_APPEND_GT,
        dropout=h.DROPOUT,
        smooth_l1_beta=h.SMOOTH_L1_BETA,
        box_reg_loss_type=h.BBOX_REG_LOSS_TYPE,
        reg_off=m.ROI_HEADS.REG_OFF,
        debug=cfg.DEBUG,
    )
    name = m.ROI_HEADS.NAME
    if name == "CascadeROIHeads":
        ious = tuple(m.ROI_BOX_CASCADE_HEAD.IOUS)
        return CascadeROIHeads(
            cascade_ious=ious,
            cascade_bbox_reg_weights=tuple(tuple(w) for w in m.ROI_BOX_CASCADE_HEAD.BBOX_REG_WEIGHTS)[:len(ious)],
            ubbr_lambda=m.UBBR.LAMBDA,
            output_layer=m.ROI_HEADS.OUTPUT_LAYER,
            **common,
        )
    if name == "CascadeUBBRROIHeads":
        return CascadeUBBRROIHeads(cascade_steps=m.UBBR.CASCADE_STEPS, ubbr_lambda=m.UBBR.LAMBDA, **common)
    common.update(output_layer=m.ROI_HEADS.OUTPUT_LAYER, cosine_scale=m.ROI_HEADS.COSINE_SCALE)
    if name == "Res5ROIHeads":
        r = m.RESNETS
        return Res5ROIHeads(
            num_groups=r.NUM_GROUPS, width_per_group=r.WIDTH_PER_GROUP, res2_out_channels=r.RES2_OUT_CHANNELS,
            stride_in_1x1=r.STRIDE_IN_1X1, resnet_norm=r.NORM, **common,
        )
    # the heads JAX gives the mask and keypoint heads (neither the cascade heads nor the C4 head build them)
    mask, kp = m.ROI_MASK_HEAD, m.ROI_KEYPOINT_HEAD
    common.update(
        mask_on=m.MASK_ON, mask_num_conv=mask.NUM_CONV, mask_conv_dim=mask.CONV_DIM,
        mask_pooler_resolution=mask.POOLER_RESOLUTION, cls_agnostic_mask=mask.CLS_AGNOSTIC_MASK,
        keypoint_on=m.KEYPOINT_ON, num_keypoints=kp.NUM_KEYPOINTS, keypoint_num_conv=kp.NUM_CONV,
        keypoint_conv_dim=kp.CONV_DIM, keypoint_pooler_resolution=kp.POOLER_RESOLUTION,
    )
    if name == "ParallelStandardROIHeads":
        seen, unseen = cfg.DATASETS.SEEN_IDS, cfg.DATASETS.UNSEEN_IDS
        return ParallelStandardROIHeads(
            StandardROIHeads(**dict(common, num_classes=len(seen))),
            StandardROIHeads(**dict(common, num_classes=len(unseen))),
            seen, unseen, cfg.DATASETS.SPLIT_IDS,
        )
    if name not in _ROI_HEADS:
        raise ValueError(f"unknown ROI heads {name!r}")
    return _ROI_HEADS[name](**common)


def build_sem_seg_head(cfg, strides, channels) -> SemSegFPNHead:
    h = cfg.MODEL.SEM_SEG_HEAD
    in_features = tuple(h.IN_FEATURES)
    return SemSegFPNHead(
        in_features, {f: strides[f] for f in in_features}, channels[in_features[0]], num_classes=h.NUM_CLASSES,
        convs_dim=h.CONVS_DIM, common_stride=h.COMMON_STRIDE, norm=h.NORM, ignore_value=h.IGNORE_VALUE,
        loss_weight=h.LOSS_WEIGHT,
    )


def build_retinanet(cfg, **kwargs) -> RetinaNet:
    m = cfg.MODEL
    r = m.RETINANET
    backbone = FPN(build_resnet(cfg), resnet_out_channels(cfg), tuple(m.FPN.IN_FEATURES) or ("res3", "res4", "res5"),
                   out_channels=m.FPN.OUT_CHANNELS, norm=m.FPN.NORM, fuse_type=m.FPN.FUSE_TYPE, top_block="p6p7")
    in_features = tuple(r.IN_FEATURES)
    strides = {f: 2 ** int(f[1:]) for f in in_features}
    sizes = [list(s) for s in m.ANCHOR_GENERATOR.SIZES]
    if len(sizes) != len(in_features):
        sizes = [[strides[f] * 4 * 2 ** (o / 3.0) for o in range(3)] for f in in_features]
    return RetinaNet(
        backbone, in_features, strides, m.FPN.OUT_CHANNELS, num_classes=r.NUM_CLASSES,
        anchor_sizes=tuple(tuple(s) for s in sizes),
        anchor_aspect_ratios=tuple(tuple(a) for a in m.ANCHOR_GENERATOR.ASPECT_RATIOS),
        anchor_offset=m.ANCHOR_GENERATOR.OFFSET, num_convs=r.NUM_CONVS, prior_prob=r.PRIOR_PROB,
        iou_thresholds=tuple(r.IOU_THRESHOLDS), iou_labels=tuple(r.IOU_LABELS),
        focal_loss_alpha=r.FOCAL_LOSS_ALPHA, focal_loss_gamma=r.FOCAL_LOSS_GAMMA,
        smooth_l1_beta=r.SMOOTH_L1_LOSS_BETA, bbox_reg_weights=tuple(r.BBOX_REG_WEIGHTS),
        score_thresh_test=r.SCORE_THRESH_TEST, topk_candidates_test=r.TOPK_CANDIDATES_TEST,
        nms_thresh_test=r.NMS_THRESH_TEST, detections_per_image=cfg.TEST.DETECTIONS_PER_IMAGE, **kwargs,
    )


def build_model(cfg, device=None) -> GeneralizedRCNN:
    """cfg -> the meta-architecture on ``device`` (default ``cuda``), with
    parameters in float32 and activations in ``MODEL.DTYPE``, in eval mode
    (``model.train()`` for the losses). Weights come from
    ``checkpoint.convert.from_flax`` or ``utils.init.damped_init``."""
    device = resolve_device(device)
    m = cfg.MODEL
    if m.META_ARCHITECTURE not in _META_ARCHS:
        raise ValueError(f"unknown META_ARCHITECTURE {m.META_ARCHITECTURE!r}")
    if m.DTYPE not in _DTYPES:
        raise ValueError(f"MODEL.DTYPE {m.DTYPE!r}")

    kwargs = dict(pixel_mean=tuple(m.PIXEL_MEAN), pixel_std=tuple(m.PIXEL_STD), compute_dtype=_DTYPES[m.DTYPE])
    if m.META_ARCHITECTURE == "RetinaNet":
        return build_retinanet(cfg, **kwargs).to(device=device, memory_format=torch.channels_last).eval()
    backbone, strides, channels = build_backbone(cfg)
    rpn_channels = channels[m.RPN.IN_FEATURES[0]]
    if m.META_ARCHITECTURE == "SemanticSegmentor":
        model = SemanticSegmentor(backbone, build_sem_seg_head(cfg, strides, channels), **kwargs)
    elif m.META_ARCHITECTURE == "PanopticFPN":
        model = PanopticFPN(
            backbone, build_rpn(cfg, strides, rpn_channels),
            build_roi_heads(cfg, strides, channels[m.ROI_HEADS.IN_FEATURES[0]]),
            build_sem_seg_head(cfg, strides, channels), m.PANOPTIC_FPN.INSTANCE_LOSS_WEIGHT, **kwargs,
        )
    elif m.META_ARCHITECTURE == "ProposalNetwork":
        model = ProposalNetwork(backbone, build_rpn(cfg, strides, rpn_channels), **kwargs)
    elif m.META_ARCHITECTURE == "RPNComp":
        model = RPNComp(backbone, pooler=m.RPNCOMP.POOLER or "identity", **kwargs)
    elif m.META_ARCHITECTURE == "GeneralizedRCNN_Context":
        feature = m.ROI_HEADS.IN_FEATURES[-1]
        model = GeneralizedRCNN_Context(
            backbone, build_proposal_generator(cfg, strides, rpn_channels),
            build_roi_heads(cfg, strides, channels[m.ROI_HEADS.IN_FEATURES[0]]),
            num_classes=m.ROI_HEADS.NUM_CLASSES, in_channels=channels[feature],
            context_channels=m.FPN.OUT_CHANNELS, context_in_feature=feature, images_only=m.IMAGES_ONLY, **kwargs,
        )
    else:
        model = _META_ARCHS[m.META_ARCHITECTURE](
            backbone, build_proposal_generator(cfg, strides, rpn_channels),
            build_roi_heads(cfg, strides, channels[m.ROI_HEADS.IN_FEATURES[0]]), **kwargs
        )
    if m.MASK_ON or m.KEYPOINT_ON:
        # the loader's batches carry no gt masks or keypoints (as in JAX), and a batch without them
        # leaves its head without a gradient
        model.unused_parameters = True
    return model.to(device=device, memory_format=torch.channels_last).eval()
