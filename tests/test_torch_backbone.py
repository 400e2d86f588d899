"""The port's stem, ResNet and FPN against the JAX package at float32.

A narrow R-50 (RES2_OUT_CHANNELS 64, WIDTH_PER_GROUP 16, FPN 64 wide) with
JAX weights carried over by ``from_flax``. The JAX stem is the space-to-depth
form; the port's is the plain 7x7/s2/p3 conv, and the outputs must agree. The
weights are scaled so activations stay O(1-10); rtol and atol are 1e-4 (two
frameworks' convolution sums in different orders).
"""
import functools

import numpy as np
import pytest

import jax
import torch

from lvc_tpu.modeling.backbone.resnet import BasicStem
from lvc_tpu.modeling.meta_arch.rcnn import model_images
from lvc_tpu.config import get_cfg as jax_get_cfg
from lvc_tpu.modeling.meta_arch.build import build_model as jax_build_model
from lvc_tpu.utils.init import materialize_variables

from lvc_tpu_torch.checkpoint.convert import from_flax
from lvc_tpu_torch.config import get_cfg
from lvc_tpu_torch.modeling.meta_arch.build import build_model


def _cfg(cfg):
    cfg.merge_from_file("configs/Base-RCNN-FPN.yaml")
    cfg.MODEL.RESNETS.RES2_OUT_CHANNELS = 64
    cfg.MODEL.RESNETS.WIDTH_PER_GROUP = 16
    cfg.MODEL.FPN.OUT_CHANNELS = 64
    cfg.MODEL.ROI_BOX_HEAD.FC_DIM = 64
    cfg.MODEL.ROI_HEADS.POOLER_IMPL = "exact"
    return cfg


@pytest.fixture(scope="module")
def models():
    rng = np.random.RandomState(0)
    batch = {
        "image": (rng.rand(2, 96, 128, 3) * 255).astype(np.float32),
        "image_size": np.array([[96, 128], [80, 100]], np.int32),
    }
    jmodel = jax_build_model(_cfg(jax_get_cfg()))
    jbatch = {k: jax.numpy.asarray(v) for k, v in batch.items()}
    shapes = jax.eval_shape(
        functools.partial(jmodel.init, train=False), {"params": jax.random.PRNGKey(0)}, jbatch
    )
    variables = materialize_variables(shapes, seed=1, conv_init="he")
    variables = jax.tree_util.tree_map(lambda v: v * 0.6 if v.ndim == 4 else v, variables)
    tmodel = build_model(_cfg(get_cfg()), device="cpu")
    tmodel.load_state_dict(from_flax(variables))
    return jmodel, variables, jbatch, tmodel, batch


def test_stem_matches_jax_s2d_stem(models):
    jmodel, variables, jbatch, tmodel, batch = models
    # the JAX BasicStem with the model's stem weights, on the JAX model's own
    # normalized, pad-masked image
    x = jmodel.apply(variables, jbatch, method=lambda m, b: model_images(m, b))
    stem_vars = {
        "params": variables["params"]["backbone"]["bottom_up"]["stem"],
        "batch_stats": variables["batch_stats"]["backbone"]["bottom_up"]["stem"],
    }
    want = BasicStem(64).apply(stem_vars, x)  # space-to-depth conv (even H, W)
    with torch.no_grad():
        got = tmodel.backbone.bottom_up.stem(tmodel.model_images(batch))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_fpn_outputs_match_jax(models):
    jmodel, variables, jbatch, tmodel, batch = models
    want = jmodel.apply(variables, jbatch, method=lambda m, b: m.backbone_features(b))
    got = tmodel.backbone_features(batch)
    assert sorted(got) == sorted(want) == ["p2", "p3", "p4", "p5", "p6"]
    for k in want:
        np.testing.assert_allclose(
            got[k].permute(0, 2, 3, 1).numpy(), np.asarray(want[k]), rtol=1e-4, atol=1e-4
        )
        assert got[k].is_contiguous(memory_format=torch.channels_last) or k == "p6"
