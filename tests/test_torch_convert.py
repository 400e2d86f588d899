"""The weight bridge: ``from_flax`` then ``to_flax`` round-trips the JAX
package's variables tree exactly, the port's state_dict loads with every key
used, and ``to_flax`` agrees with ``lvc_tpu.checkpoint.convert.torch_to_flax``
on the same state_dict."""
import functools

import numpy as np
import pytest

import jax
import torch

from lvc_tpu.checkpoint.convert import torch_to_flax
from lvc_tpu.config import get_cfg as jax_get_cfg
from lvc_tpu.modeling.meta_arch.build import build_model as jax_build_model
from lvc_tpu.utils.init import materialize_variables

from lvc_tpu_torch.checkpoint.convert import from_flax, to_flax
from lvc_tpu_torch.config import get_cfg
from lvc_tpu_torch.modeling.meta_arch.build import build_model
from lvc_tpu_torch.utils.init import damped_init


def _cfg(cfg):
    cfg.merge_from_file("configs/Base-RCNN-FPN.yaml")
    cfg.MODEL.RESNETS.RES2_OUT_CHANNELS = 64
    cfg.MODEL.RESNETS.WIDTH_PER_GROUP = 16
    cfg.MODEL.FPN.OUT_CHANNELS = 64
    cfg.MODEL.ROI_BOX_HEAD.FC_DIM = 64
    cfg.MODEL.ROI_HEADS.NUM_CLASSES = 7
    return cfg


@pytest.fixture(scope="module")
def jax_variables():
    model = jax_build_model(_cfg(jax_get_cfg()))
    batch = {"image": jax.numpy.zeros((1, 64, 64, 3)), "image_size": jax.numpy.asarray([[64, 64]], np.int32)}
    shapes = jax.eval_shape(
        functools.partial(model.init, train=False), {"params": jax.random.PRNGKey(0)}, batch
    )
    return materialize_variables(shapes, seed=3, conv_init="he")


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _assert_trees_equal(a, b):
    fa, fb = dict(_flat(a)), dict(_flat(b))
    assert sorted(fa) == sorted(fb)
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg="/".join(k))


def test_round_trip_and_load(jax_variables):
    sd = from_flax(jax_variables)
    _assert_trees_equal(to_flax(sd), jax_variables)
    model = build_model(_cfg(get_cfg()), device="cpu")
    missing, unexpected = model.load_state_dict(sd, strict=True)
    assert not missing and not unexpected
    # layout: conv HWIO -> OIHW, dense (in, out) -> (out, in)
    k = jax_variables["params"]["backbone"]["bottom_up"]["stem"]["conv1"]["conv"]["kernel"]
    np.testing.assert_array_equal(sd["backbone.bottom_up.stem.conv1.weight"].numpy(), k.transpose(3, 2, 0, 1))
    fc = jax_variables["params"]["roi_heads"]["box_head"]["fc1"]["kernel"]
    np.testing.assert_array_equal(sd["roi_heads.box_head.fc1.weight"].numpy(), fc.T)


def test_to_flax_agrees_with_torch_to_flax():
    model = damped_init(build_model(_cfg(get_cfg()), device="cpu"), seed=1)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    _assert_trees_equal(to_flax(model.state_dict()), torch_to_flax(sd))


def test_damped_init_rule():
    model = damped_init(build_model(_cfg(get_cfg()), device="cpu"), seed=0)
    sd = model.state_dict()
    assert torch.equal(sd["backbone.bottom_up.res2.0.conv1.norm.weight"], torch.ones(16))
    assert torch.equal(sd["backbone.bottom_up.res2.0.conv1.norm.running_var"], torch.ones(16))
    assert torch.equal(sd["backbone.bottom_up.res2.0.conv1.norm.running_mean"], torch.zeros(16))
    assert torch.equal(sd["backbone.fpn_lateral2.bias"], torch.zeros(64))
    w = sd["roi_heads.box_head.fc1.weight"]
    assert abs(float(w.std()) - 0.01) < 1e-3 and abs(float(w.mean())) < 1e-3
    again = damped_init(build_model(_cfg(get_cfg()), device="cpu"), seed=0).state_dict()
    assert all(torch.equal(sd[k], again[k]) for k in sd)
