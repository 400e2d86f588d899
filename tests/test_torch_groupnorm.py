"""The port's GroupNorm and ``"he"`` init against the JAX package on the CPU.

- ``GroupNorm`` against flax's ``nn.GroupNorm(num_groups=32)`` (what the JAX
  ``get_norm("GN")`` builds: epsilon 1e-6, variance as E[x^2] - E[x]^2) on
  seeded inputs with a mean far from 0, float32, rtol and atol 1e-5; in bf16
  (the AMP forward, flax's parameters cast to bf16 as JAX's AMP step casts
  them) within 1 bf16 ulp of the output.
- A narrow R-50-FPN with ``RESNETS.NORM "GN"`` (RES2_OUT_CHANNELS 128,
  WIDTH_PER_GROUP 32: GN needs channels divisible by 32) against the JAX
  backbone from weights carried by ``from_flax``: every FPN output within
  rtol 1e-4 and an atol of 1e-4 of its standard deviation (two frameworks'
  convolution sums in other orders, through 53 GNs and 16 residual blocks:
  measured up to 6.3e-5 of it, where the GN alone is 1e-6 from float64), and
  ``to_flax`` gives the JAX tree back.
- ``he_init`` draws each tensor as ``materialize_variables(conv_init="he")``
  does (the same law, other random numbers: std within 10% on the large
  tensors, constants exact).
"""
import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lvc_tpu.config import get_cfg as jax_get_cfg
from lvc_tpu.modeling.meta_arch.build import build_model as jax_build_model
from lvc_tpu.utils.init import materialize_variables
from lvc_tpu_torch.checkpoint.convert import from_flax, to_flax
from lvc_tpu_torch.config import get_cfg
from lvc_tpu_torch.modeling.layers import GroupNorm, SyncBatchNorm, get_norm
from lvc_tpu_torch.modeling.meta_arch.build import build_model
from lvc_tpu_torch.utils.init import he_init


@pytest.mark.parametrize("shape", [(2, 64, 9, 11), (1, 256, 7, 5), (3, 32, 4, 4)])
def test_group_norm_matches_flax(shape):
    rng = np.random.RandomState(0)
    x = (rng.randn(*shape) * 3.0 + 5.0).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, shape[1]).astype(np.float32)
    bias = rng.randn(shape[1]).astype(np.float32)
    want = fnn.GroupNorm(num_groups=32).apply(
        {"params": {"scale": scale, "bias": bias}}, jnp.asarray(x.transpose(0, 2, 3, 1)))
    gn = GroupNorm(32, shape[1])
    with torch.no_grad():
        gn.weight.copy_(torch.from_numpy(scale))
        gn.bias.copy_(torch.from_numpy(bias))
        got = gn(torch.from_numpy(x).contiguous(memory_format=torch.channels_last))
    assert gn.eps == 1e-6 and got.dtype == torch.float32
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_group_norm_in_bf16_matches_flax_with_bf16_parameters():
    rng = np.random.RandomState(1)
    x = (rng.randn(2, 64, 6, 8) * 2.0 + 1.0).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 64).astype(np.float32)
    bias = rng.randn(64).astype(np.float32)
    xb = jnp.asarray(x.transpose(0, 2, 3, 1)).astype(jnp.bfloat16)
    want = fnn.GroupNorm(num_groups=32).apply(
        {"params": {"scale": jnp.asarray(scale, jnp.bfloat16), "bias": jnp.asarray(bias, jnp.bfloat16)}}, xb)
    assert want.dtype == jnp.bfloat16
    gn = GroupNorm(32, 64)
    with torch.no_grad():
        gn.weight.copy_(torch.from_numpy(scale))
        gn.bias.copy_(torch.from_numpy(bias))
        got = gn(torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    w = np.asarray(want.astype(jnp.float32))
    g = got.float().permute(0, 2, 3, 1).numpy()
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(w), 1e-30))) - 7)
    assert np.all(np.abs(g - w) <= ulp)


def test_get_norm_builds_gn_and_refuses_batch_norm():
    gn = get_norm("GN", 64)
    assert isinstance(gn, GroupNorm) and gn.num_groups == 32
    # BN and SyncBN are the JAX package's SyncBatchNorm (tests/test_torch_batchnorm.py), never GN
    for name in ("BN", "SyncBN"):
        bn = get_norm(name, 64)
        assert isinstance(bn, SyncBatchNorm) and not isinstance(bn, GroupNorm) and bn.num_features == 64


def _cfg(cfg):
    cfg.merge_from_file("configs/Base-RCNN-FPN.yaml")
    cfg.MODEL.RESNETS.NORM = "GN"
    cfg.MODEL.RESNETS.RES2_OUT_CHANNELS = 128
    cfg.MODEL.RESNETS.WIDTH_PER_GROUP = 32
    cfg.MODEL.FPN.OUT_CHANNELS = 64
    cfg.MODEL.ROI_BOX_HEAD.FC_DIM = 64
    cfg.MODEL.ROI_HEADS.NUM_CLASSES = 2
    cfg.MODEL.ROI_HEADS.POOLER_IMPL = "exact"
    return cfg


@pytest.fixture(scope="module")
def gn_models():
    rng = np.random.RandomState(0)
    batch = {
        "image": (rng.rand(2, 96, 128, 3) * 255).astype(np.float32),
        "image_size": np.array([[96, 128], [80, 100]], np.int32),
    }
    jmodel = jax_build_model(_cfg(jax_get_cfg()))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    shapes = jax.eval_shape(
        functools.partial(jmodel.init, train=False), {"params": jax.random.PRNGKey(0)}, jbatch
    )
    variables = materialize_variables(shapes, seed=1, conv_init="he")
    # GN weights and biases away from their constants, so the bridge is
    # tested; each block's last GN scaled by 0.3, so the residual trunk stays
    # O(1-10) through the 16 blocks, as in a trained network
    rs = np.random.RandomState(2)

    def gn(path, v):
        key = jax.tree_util.keystr(path)
        if "GroupNorm_0" not in key:
            return v
        v = v * rs.uniform(0.5, 1.5, v.shape).astype(v.dtype) + rs.randn(*v.shape).astype(v.dtype) * 0.1
        return v * 0.3 if "conv3" in key else v

    variables = jax.tree_util.tree_map_with_path(gn, variables)
    tmodel = build_model(_cfg(get_cfg()), device="cpu")
    tmodel.load_state_dict(from_flax(variables))
    return jmodel, variables, jbatch, tmodel, batch


def test_gn_backbone_matches_jax(gn_models):
    jmodel, variables, jbatch, tmodel, batch = gn_models
    assert not any(isinstance(m, torch.nn.BatchNorm2d) for m in tmodel.modules())
    assert sum(isinstance(m, GroupNorm) for m in tmodel.backbone.modules()) == 53
    want = jmodel.apply(variables, jbatch, method=lambda m, b: m.backbone_features(b))
    got = tmodel.backbone_features(batch)
    assert sorted(got) == sorted(want) == ["p2", "p3", "p4", "p5", "p6"]
    for k in want:
        w = np.asarray(want[k])
        np.testing.assert_allclose(got[k].permute(0, 2, 3, 1).numpy(), w, rtol=1e-4, atol=1e-4 * w.std())


def test_gn_weights_round_trip(gn_models):
    _, variables, _, tmodel, _ = gn_models
    back = to_flax(tmodel.state_dict())
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    flat_want = dict(jax.tree_util.tree_leaves_with_path(variables))
    assert flat_back.keys() == flat_want.keys()
    for k, v in flat_want.items():
        np.testing.assert_array_equal(flat_back[k], np.asarray(v))


def test_he_init_follows_the_jax_rule(gn_models):
    _, variables, _, _, _ = gn_models
    tmodel = build_model(_cfg(get_cfg()), device="cpu")
    he_init(tmodel, torch.Generator().manual_seed(0))
    want = from_flax(materialize_variables(
        jax.eval_shape(lambda: variables), seed=0, conv_init="he"))
    got = tmodel.state_dict()
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        if w.numel() < 4096 or w.std() == 0:
            if w.dim() < 2 or w.std() == 0:
                torch.testing.assert_close(g, w, rtol=0, atol=0)
            continue
        assert abs(float(g.std()) / float(w.std()) - 1) < 0.1, k
        assert abs(float(g.mean())) < 0.1 * float(w.std()), k
