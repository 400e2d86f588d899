"""A narrow R-50-FPN detector (RES2_OUT_CHANNELS 64, WIDTH_PER_GROUP 16, FPN
64 wide, 5 classes) on one set of JAX weights, for the port's tests: the
configs of both packages and the flax variables, He-initialised from seed 0
and scaled as in ``test_torch_rcnn.py`` so that FPN features are O(10), RPN
logits well spread and class scores in (0.05, 0.5) (no near-ties for the two
frameworks' ~1e-6 convolution differences to flip)."""
import functools

import jax
import numpy as np

from lvc_tpu.config import get_cfg as jax_get_cfg
from lvc_tpu.modeling.meta_arch.build import build_model as jax_build_model
from lvc_tpu.utils.init import materialize_variables


def narrow_cfg(cfg, impl="auto"):
    cfg.merge_from_file("configs/Base-RCNN-FPN.yaml")
    cfg.MODEL.RESNETS.DEPTH = 50
    cfg.MODEL.RESNETS.RES2_OUT_CHANNELS = 64
    cfg.MODEL.RESNETS.WIDTH_PER_GROUP = 16
    cfg.MODEL.FPN.OUT_CHANNELS = 64
    cfg.MODEL.ROI_HEADS.NUM_CLASSES = 5
    cfg.MODEL.ROI_BOX_HEAD.FC_DIM = 128
    cfg.MODEL.RPN.PRE_NMS_TOPK_TEST = 200
    cfg.MODEL.RPN.POST_NMS_TOPK_TEST = 100
    cfg.MODEL.ROI_HEADS.POOLER_IMPL = impl
    cfg.TEST.DETECTIONS_PER_IMAGE = 30
    return cfg


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def narrow_variables(height=128, width=192):
    """The flax variables of the narrow detector (numpy leaves)."""
    model = jax_build_model(narrow_cfg(jax_get_cfg(), "exact"))
    batch = {
        "image": jax.numpy.zeros((1, height, width, 3), np.float32),
        "image_size": jax.numpy.asarray([[height, width]], np.int32),
    }
    shapes = jax.eval_shape(
        functools.partial(model.init, train=False), {"params": jax.random.PRNGKey(0)}, batch
    )
    var = materialize_variables(shapes, seed=0, conv_init="he")
    for block in var["params"]["backbone"]["bottom_up"].values():
        for path, leaf in _leaves(block):
            if path[-1] == "kernel":
                leaf *= 0.7
    rpn = var["params"]["proposal_generator"]["rpn_head"]
    rpn["conv"]["conv"]["kernel"] *= 0.1
    rpn["objectness_logits"]["conv"]["kernel"] *= 0.1
    rpn["anchor_deltas"]["conv"]["kernel"] *= 0.01
    head = var["params"]["roi_heads"]["box_predictor"]
    head["cls_score"]["kernel"] *= 0.03
    head["bbox_pred"]["kernel"] *= 0.3
    return var


def port_narrow_model(impl="auto", seed=0):
    """The port's narrow detector on the CPU with ``chip_smoke.calibrated_init``'s
    weights (He-normal scaled as ``narrow_variables``), without JAX, for
    tests that hold the port against itself."""
    import chip_smoke
    from lvc_tpu_torch.config import get_cfg
    from lvc_tpu_torch.modeling.meta_arch.build import build_model

    model = build_model(narrow_cfg(get_cfg(), impl), device="cpu")
    chip_smoke.calibrated_init(model, seed)
    return model
