"""The weight-decay group and the trainability of every parameter, on every
model kind the port builds, against the JAX package's ``_wd_group_masks``
and ``trainability_mask`` (``lvc_tpu/solver/build.py:98-149``), with the
three decays set to three different values and one optimizer step from
zero gradients held to optax's (``tests/test_torch_swin.py``'s
``check_wd_groups``; the Swin-FPN, ResNet-D and GN DCN models are held in
tests/test_torch_swin.py and tests/test_torch_backbone_variants.py).

JAX puts a parameter in the norm group only when its path holds
``GroupNorm`` (or a BatchNorm); a ``bias`` outside them in the bias group.
The narrow models are those of the other tests: R-50 with res2 64 wide
(128 with width 32 where GroupNorm needs 32 groups), FPN 64 wide, the
freeze flags where a kind uses them.
"""
import pytest

import chip_smoke
from test_torch_swin import check_wd_groups

NARROW = ["MODEL.RESNETS.RES2_OUT_CHANNELS", 64, "MODEL.RESNETS.WIDTH_PER_GROUP", 16, "MODEL.FPN.OUT_CHANNELS", 64,
          "MODEL.ROI_BOX_HEAD.FC_DIM", 64]
GN = ["MODEL.RESNETS.NORM", "GN", "MODEL.RESNETS.RES2_OUT_CHANNELS", 128, "MODEL.RESNETS.WIDTH_PER_GROUP", 32,
      "MODEL.FPN.NORM", "GN", "MODEL.FPN.OUT_CHANNELS", 64, "MODEL.ROI_BOX_HEAD.NORM", "GN",
      "MODEL.ROI_BOX_HEAD.NUM_CONV", 2, "MODEL.ROI_BOX_HEAD.CONV_DIM", 64, "MODEL.ROI_BOX_HEAD.FC_DIM", 64]
KINDS = {
    "rcnn_frozen_heads": NARROW + ["MODEL.BACKBONE.FREEZE_AT", 3, "MODEL.ROI_HEADS.FREEZE_FEAT", True,
                                   "MODEL.PROPOSAL_GENERATOR.FREEZE", True],
    "rcnn_gn": GN + ["MODEL.BACKBONE.FREEZE_AT", 0],
    "cascade": NARROW + ["MODEL.ROI_HEADS.NAME", "CascadeROIHeads", "MODEL.ROI_HEADS.FREEZE_BBOX_PRED", True],
    "mask_keypoint": NARROW + ["MODEL.MASK_ON", True, "MODEL.KEYPOINT_ON", True, "MODEL.ROI_MASK_HEAD.NUM_CONV", 2,
                               "MODEL.ROI_MASK_HEAD.CONV_DIM", 32, "MODEL.ROI_KEYPOINT_HEAD.NUM_CONV", 2,
                               "MODEL.ROI_KEYPOINT_HEAD.CONV_DIM", 32],
    "cosine": NARROW + ["MODEL.ROI_HEADS.OUTPUT_LAYER", "CosineSimOutputLayers", "MODEL.ROI_HEADS.COSINE_SCALE", -1.0,
                        "MODEL.BACKBONE.FREEZE", True],
    "retinanet": chip_smoke.dense_opts("retinanet", narrow=True),
    "panoptic": chip_smoke.dense_opts("panoptic", narrow=True),
}


@pytest.mark.parametrize("kind", list(KINDS))
def test_weight_decay_groups_match_jax(kind):
    groups = check_wd_groups(KINDS[kind])
    if kind in ("rcnn_gn", "panoptic"):
        assert "norm" in groups.values()


def test_c4_weight_decay_groups_match_jax():
    """The bare defaults: the C4 detector (res4 features, Res5ROIHeads)."""
    check_wd_groups(["MODEL.RESNETS.RES2_OUT_CHANNELS", 16, "MODEL.RESNETS.WIDTH_PER_GROUP", 4,
                     "MODEL.RESNETS.STEM_OUT_CHANNELS", 16, "MODEL.BACKBONE.NAME", "build_resnet_backbone"],
                    size=(128, 128), base=None)
