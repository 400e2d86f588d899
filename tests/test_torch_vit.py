"""The port's DINO ViT (``lvc_tpu_torch/modeling/backbone/vit.py``) against
the JAX package's, with the same weights carried over by ``vit_from_flax``.

Full width (dim 384, 6 heads, patch 8, 224 crops, N = 785) at depth 2 and
batch 2 keeps the CPU cost low. The JAX flash path runs the library Pallas
TPU kernel in interpret mode. Tolerances: float32 1e-4 abs and rel; bf16
against JAX under ``compute_dtype_scope("bfloat16")`` with flash, descriptor
cosine >= 0.999 (bf16 rounds at other places in the two frameworks).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from lvc_tpu.modeling.backbone import vit as jvit
from lvc_tpu.modeling.layers import compute_dtype_scope
from lvc_tpu_torch.checkpoint.convert import vit_from_flax, vit_to_flax
from lvc_tpu_torch.modeling.backbone.vit import (
    VisionTransformer,
    dino_vits16,
    load_dino_state_dict,
    random_init,
)

DEPTH = 2


def _jax_vit(attn_impl):
    return jvit.VisionTransformer(patch_size=8, embed_dim=384, depth=DEPTH, num_heads=6, attn_impl=attn_impl)


def _port_vit(dtype=torch.float32):
    return VisionTransformer(8, 384, DEPTH, 6, compute_dtype=dtype)


@pytest.fixture(scope="module")
def weights():
    """JAX variables (numpy) with spread LayerNorm and biases, and the port's
    state dict made from them."""
    variables = _jax_vit("einsum").init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 224, 224, 3)))
    rng = np.random.RandomState(0)
    variables = jax.tree_util.tree_map(
        lambda v: np.asarray(v) + rng.randn(*np.shape(v)).astype(np.float32) * 0.02, variables
    )
    return variables, vit_from_flax(variables)


def _images(n, size, seed):
    return np.random.RandomState(seed).randn(n, size, size, 3).astype(np.float32)


def _port(sd, x, dtype=torch.float32):
    model = _port_vit(dtype)
    model.load_state_dict(sd)
    with torch.no_grad():
        return model(torch.from_numpy(x)).float().numpy()


def _jax(variables, x, attn_impl):
    # jitted: eager interpret-mode calls can deadlock against the next
    # eagerly dispatched op
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(jax.jit(_jax_vit(attn_impl).apply)(variables, jnp.asarray(x)).astype(jnp.float32))


@pytest.mark.parametrize("attn_impl", ["einsum", "flash"])
def test_vit_matches_jax_f32(weights, attn_impl):
    variables, sd = weights
    x = _images(2, 224, seed=1)
    got = _port(sd, x)
    want = _jax(variables, x, attn_impl)
    assert got.shape == want.shape == (2, 384)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_vit_matches_jax_bf16_flash(weights):
    variables, sd = weights
    x = _images(2, 224, seed=2)
    got = _port(sd, x, torch.bfloat16)
    with compute_dtype_scope("bfloat16"):
        want = _jax(variables, x, "flash")
    cos = (got * want).sum(-1) / np.linalg.norm(got, axis=-1) / np.linalg.norm(want, axis=-1)
    assert (cos >= 0.999).all(), cos


@pytest.mark.parametrize("size", [96, 320])
def test_pos_embed_interpolation_matches_jax(weights, size):
    """Crops other than 224 resize the patch position grid (jax.image.resize
    bicubic = torch's antialiased bicubic)."""
    variables, sd = weights
    x = _images(1, size, seed=3)
    np.testing.assert_allclose(_port(sd, x), _jax(variables, x, "einsum"), rtol=1e-4, atol=1e-4)


def test_vit_from_flax_inverts_convert_dino_torch_params():
    """``vit_from_flax(convert_dino_torch_params(sd))`` is the DINO state dict
    without ``head.*``, and ``vit_to_flax`` is its inverse; the DINO layout
    loads into the port's module as it is."""
    model = random_init(dino_vits16(), seed=3)
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    sd["head.weight"] = torch.randn(16, 384)
    back = vit_from_flax(jvit.convert_dino_torch_params(sd))
    assert set(back) == set(sd) - {"head.weight"}
    for k, v in back.items():
        assert torch.equal(v, sd[k]), k
    flax_tree = jvit.convert_dino_torch_params(sd)
    again = vit_to_flax(back)
    flat = jax.tree_util.tree_leaves_with_path(flax_tree["params"])
    assert len(flat) == len(jax.tree_util.tree_leaves(again["params"]))
    for path, v in flat:
        node = again["params"]
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node, v)
    fresh = load_dino_state_dict(dino_vits16(), sd)
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, sd[k]), k
