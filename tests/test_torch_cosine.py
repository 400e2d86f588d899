"""``CosineSimOutputLayers`` and the fine-tune weights' bridge against the JAX
package on the CPU.

- The output layer alone (``lvc_tpu/modeling/roi_heads/fast_rcnn.py:57``)
  with the fixed scale 20 and the learnable one (``scale`` -1), class-specific
  and class-agnostic regression, from the same seeded flax parameters
  carried over by ``from_flax``: scores, deltas, and the gradients of a
  seeded linear function of both with respect to the input and every
  parameter, within rel 1e-5 of each array's largest magnitude (float32 sums
  in other orders). Under ``torch.autocast`` in bf16 the outputs stay
  float32 and equal to the float32 outputs (JAX casts the input to float32
  before the cosine and the regressor alike).
- ``StandardROIHeads`` with the cosine layer in training mode, on seeded
  features, proposals and gt with exhaustive sampling (BATCH_SIZE_PER_IMAGE
  >= proposals + gt, POSITIVE_FRACTION 0.999, so both generators pick the
  same sets): ``loss_cls`` and ``loss_box_reg`` within rel 1e-5, the
  gradients of their sum with respect to the features and every head
  parameter within rel L2 1e-4 (the pool's backward sums in another order).
- ``from_flax``/``to_flax`` map ``cls_score_weight`` (in, K+1) and ``scale``
  to ``cls_score.weight`` (K+1, in), no bias, and ``scale``, both ways, and
  agree with ``torch_to_flax``; ``build_model`` builds the cosine head from
  ``OUTPUT_LAYER`` and ``COSINE_SCALE``; ``he_init`` and ``damped_init``
  start the learnable scale at 1, as JAX's ``materialize_variables`` does.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lvc_tpu.checkpoint.convert import torch_to_flax
from lvc_tpu.modeling.roi_heads.fast_rcnn import CosineSimOutputLayers as JaxCosine
from lvc_tpu.modeling.roi_heads.roi_heads import StandardROIHeads as JaxHeads
from lvc_tpu_torch.checkpoint.convert import from_flax, to_flax
from lvc_tpu_torch.config import get_cfg
from lvc_tpu_torch.modeling.meta_arch.build import build_model
from lvc_tpu_torch.modeling.roi_heads.fast_rcnn import CosineSimOutputLayers
from lvc_tpu_torch.modeling.roi_heads.roi_heads import StandardROIHeads
from lvc_tpu_torch.utils.init import damped_init, he_init

K, D, N = 6, 40, 13


def _close(got, want, rel=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(np.abs(want).max(), 1e-30))


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _seeded(shapes, seed):
    rng = np.random.RandomState(seed)
    return {k: rng.normal(0, 0.5, s).astype(np.float32) for k, s in shapes.items()}


@pytest.mark.parametrize("scale", [20.0, -1.0])
@pytest.mark.parametrize("agnostic", [False, True])
def test_cosine_layer_matches_flax(scale, agnostic):
    reg = 4 if agnostic else 4 * K
    shapes = {"cls_score_weight": (D, K + 1), "kernel": (D, reg), "bias": (reg,)}
    p = _seeded(shapes, seed=1)
    params = {"cls_score_weight": p["cls_score_weight"], "bbox_pred": {"kernel": p["kernel"], "bias": p["bias"]}}
    if scale == -1:
        params["scale"] = np.array([17.5], np.float32)
    rng = np.random.RandomState(2)
    x = rng.normal(0, 1, (N, 2, 4, 5)).astype(np.float32)  # flattened to D inside, as in both packages
    gs, gd = rng.normal(0, 1, (N, K + 1)).astype(np.float32), rng.normal(0, 1, (N, reg)).astype(np.float32)

    jmod = JaxCosine(num_classes=K, scale=scale, cls_agnostic_bbox_reg=agnostic)

    def f(params, x):
        s, d = jmod.apply({"params": params}, x)
        return jnp.sum(s * gs) + jnp.sum(d * gd), (s, d)

    (_, (j_s, j_d)), (j_gp, j_gx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))

    layer = CosineSimOutputLayers(D, K, scale, agnostic)
    sd = from_flax({"params": {"box_predictor": params}})
    missing, unexpected = layer.load_state_dict({k.split(".", 1)[1]: v for k, v in sd.items()}, strict=True)
    assert not missing and not unexpected and layer.cls_score.bias is None
    xt = torch.from_numpy(x).requires_grad_(True)
    s, d = layer(xt)
    ((s * torch.from_numpy(gs)).sum() + (d * torch.from_numpy(gd)).sum()).backward()
    _close(s.detach(), j_s)
    _close(d.detach(), j_d)
    _close(xt.grad, j_gx)
    grads = to_flax({f"box_predictor.{k}": v.grad for k, v in layer.named_parameters()})["params"]["box_predictor"]
    _close(grads["cls_score_weight"], j_gp["cls_score_weight"])
    _close(grads["bbox_pred"]["kernel"], j_gp["bbox_pred"]["kernel"])
    _close(grads["bbox_pred"]["bias"], j_gp["bbox_pred"]["bias"])
    if scale == -1:
        _close(grads["scale"], j_gp["scale"])
    else:
        assert "scale" not in grads and not isinstance(layer.scale, torch.nn.Parameter)


def test_cosine_layer_runs_float32_under_autocast():
    layer = CosineSimOutputLayers(D, K, -1.0)
    torch.nn.init.normal_(layer.cls_score.weight)
    x = torch.from_numpy(np.random.RandomState(3).normal(0, 1, (N, D)).astype(np.float32)).bfloat16()
    want = layer(x.float())
    with torch.autocast("cpu", dtype=torch.bfloat16):
        got = layer(x)
        assert torch.nn.functional.linear(x.float(), layer.bbox_pred.weight).dtype == torch.bfloat16
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def _heads_inputs(seed=4):
    rng = np.random.RandomState(seed)
    B, C, H, W = 2, 16, 64, 96
    feats = {"p2": rng.normal(0, 1, (B, H // 4, W // 4, C)).astype(np.float32),
             "p3": rng.normal(0, 1, (B, H // 8, W // 8, C)).astype(np.float32)}
    xy = rng.uniform(0, 60, (B, 12, 2))
    wh = rng.uniform(8, 40, (B, 12, 2))
    proposals = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    gt_boxes = proposals[:, [0, 3, 7], :] + rng.uniform(-3, 3, (B, 3, 4)).astype(np.float32)
    gt = {"boxes": gt_boxes, "classes": np.array([[0, 3, 5], [2, 2, 1]], np.int32),
          "valid": np.array([[True, True, True], [True, True, False]])}
    return feats, proposals, np.ones((B, 12), bool), np.array([[H, W], [H, W]], np.int32), gt


@pytest.mark.parametrize("scale", [20.0, -1.0])
def test_standard_heads_losses_with_cosine_match_jax(scale):
    feats, proposals, valid, sizes, gt = _heads_inputs()
    opts = dict(num_classes=K, batch_size_per_image=64, positive_fraction=0.999, fc_dim=32,
                pooler_impl="exact", output_layer="CosineSimOutputLayers", cosine_scale=scale)
    jheads = JaxHeads(in_features=("p2", "p3"), strides={"p2": 4, "p3": 8}, **opts)
    jgt = {k: jnp.asarray(v) for k, v in gt.items()}
    args = (jnp.asarray(proposals), jnp.asarray(valid), jnp.asarray(sizes))
    key = jax.random.PRNGKey(0)
    variables = jheads.init({"params": key, "sampling": key}, feats, *args, jgt, train=True)
    params = jax.tree_util.tree_map(lambda v: np.asarray(v) * 1.0, variables["params"])
    if scale == -1:
        params["box_predictor"]["scale"] = np.array([9.0], np.float32)

    def f(params, feats):
        losses, _ = jheads.apply({"params": params}, feats, *args, jgt, train=True, rngs={"sampling": key})
        return losses["loss_cls"] + losses["loss_box_reg"], losses

    (_, j_losses), (j_gp, j_gf) = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in feats.items()})

    heads = StandardROIHeads(("p2", "p3"), {"p2": 4, "p3": 8}, 16, **opts)
    heads.load_state_dict(from_flax({"params": params}), strict=True)
    heads.train()
    tf = {k: torch.from_numpy(v).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
          .requires_grad_(True) for k, v in feats.items()}
    tgt = {k: torch.from_numpy(v) for k, v in gt.items()}
    losses = heads(tf, torch.from_numpy(proposals), torch.from_numpy(valid), torch.from_numpy(sizes), tgt,
                   torch.Generator().manual_seed(0))
    (losses["loss_cls"] + losses["loss_box_reg"]).backward()
    for k in ("loss_cls", "loss_box_reg"):
        assert float(losses[k].detach()) == pytest.approx(float(j_losses[k]), rel=1e-5), k
    assert float(j_losses["loss_box_reg"]) > 0
    for k in feats:
        assert _rel_l2(tf[k].grad.permute(0, 2, 3, 1), j_gf[k]) < 1e-4, k
    got = to_flax({n: p.grad for n, p in heads.named_parameters()})["params"]
    got = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    want = dict(jax.tree_util.tree_flatten_with_path(j_gp)[0])
    assert set(got) == set(want)
    for path, w in want.items():
        assert _rel_l2(got[path], w) < 1e-4, path


def test_weight_bridge_and_build():
    cfg = get_cfg()
    cfg.merge_from_file("configs/Base-RCNN-FPN.yaml")
    cfg.MODEL.RESNETS.RES2_OUT_CHANNELS = 64
    cfg.MODEL.RESNETS.WIDTH_PER_GROUP = 16
    cfg.MODEL.FPN.OUT_CHANNELS = 64
    cfg.MODEL.ROI_BOX_HEAD.FC_DIM = 32
    cfg.MODEL.ROI_HEADS.NUM_CLASSES = K
    cfg.MODEL.ROI_HEADS.OUTPUT_LAYER = "CosineSimOutputLayers"
    cfg.MODEL.ROI_HEADS.COSINE_SCALE = -1.0
    model = build_model(cfg, device="cpu")
    pred = model.roi_heads.box_predictor
    assert isinstance(pred, CosineSimOutputLayers) and pred.cls_score.bias is None
    assert tuple(pred.cls_score.weight.shape) == (K + 1, 32) and tuple(pred.bbox_pred.weight.shape) == (4 * K, 32)
    for init in (lambda m: he_init(m, torch.Generator().manual_seed(0)), lambda m: damped_init(m, seed=0)):
        init(model)
        assert float(pred.scale.detach()) == 1.0
    sd = model.state_dict()
    tree = to_flax(sd)
    box = tree["params"]["roi_heads"]["box_predictor"]
    assert set(box) == {"cls_score_weight", "bbox_pred", "scale"}
    np.testing.assert_array_equal(box["cls_score_weight"], sd["roi_heads.box_predictor.cls_score.weight"].numpy().T)
    back = from_flax(tree)
    assert set(back) == set(sd) - {"pixel_mean", "pixel_std"}
    for k, v in back.items():
        torch.testing.assert_close(v, sd[k], rtol=0, atol=0)
    want = torch_to_flax({k: v.numpy() for k, v in sd.items()})["params"]["roi_heads"]["box_predictor"]
    np.testing.assert_array_equal(want["cls_score_weight"], box["cls_score_weight"])
    cfg.MODEL.ROI_HEADS.COSINE_SCALE = 20.0
    assert not isinstance(build_model(cfg, device="cpu").roi_heads.box_predictor.scale, torch.nn.Parameter)
