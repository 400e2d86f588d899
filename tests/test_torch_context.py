"""The context detector, RPNComp, PrecomputedProposals, the gradient decouple
layers and the clustering against the JAX package on the CPU.

- ``GeneralizedRCNN_Context`` on a narrow R-50-FPN (the widths of
  tests/test_torch_train.py: res2 64, FPN 64, 5 classes, FC 128) on a B=2
  128x192 canvas, POOLER_IMPL exact in both packages, JAX's seeded weights
  (scaled as tests/test_torch_rcnn.py scales them) through ``from_flax``.
  Sampling is exhaustive, so both packages sample the same sets. One
  training forward and backward: every loss rel 1e-5, the gradient of every
  parameter rel L2 1e-4 (``cont_conv``'s is 0 in both: its output is
  discarded); eval mode: ``image_scores`` abs 1e-5 and the detections as in
  tests/test_torch_rcnn.py (boxes 1e-3 px, scores 1e-4); ``MODEL.IMAGES_ONLY``:
  ``image_scores`` alone in eval, ``loss_context`` alone in training.
- ``RPNComp`` on a narrow plain ResNet (res5 out) over a batch of 64x64
  crops with the avg, max and identity pools: abs 1e-4.
- ``PrecomputedProposals``: a narrow ``GeneralizedRCNN`` without a proposal
  generator, fed the same seeded proposals: detections as above.
- ``decouple_layer`` and ``AffineLayer``: values and gradients to 1e-6.
- ``preprocess_features``: equal to JAX's up to a sign per column
  (``eigh`` fixes no sign), abs 1e-4 on a spectrum without near-equal
  eigenvalues; ``kmeans_run`` from the same initial centroids: the same
  assignments, centroids abs 1e-5.
"""
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from lvc_tpu.config import get_cfg as jax_get_cfg
from lvc_tpu.data.cluster import clustering as jclust
from lvc_tpu.modeling.meta_arch import gdl as jgdl
from lvc_tpu.modeling.meta_arch.build import build_model as jax_build_model
from lvc_tpu.utils.init import materialize_variables

from lvc_tpu_torch.checkpoint.convert import from_flax, to_flax
from lvc_tpu_torch.config import get_cfg
from lvc_tpu_torch.data.cluster import clustering
from lvc_tpu_torch.modeling.meta_arch.build import build_model
from lvc_tpu_torch.modeling.meta_arch.gdl import AffineLayer, decouple_layer
from lvc_tpu_torch.modeling.roi_heads.fast_rcnn import Detections

B, H, W, G = 2, 128, 192, 4


def _narrow(cfg, *opts):
    cfg.merge_from_file("configs/Base-RCNN-FPN.yaml")
    cfg.merge_from_list([
        "MODEL.RESNETS.DEPTH", 50, "MODEL.RESNETS.RES2_OUT_CHANNELS", 64, "MODEL.RESNETS.WIDTH_PER_GROUP", 16,
        "MODEL.FPN.OUT_CHANNELS", 64, "MODEL.ROI_HEADS.NUM_CLASSES", 5, "MODEL.ROI_BOX_HEAD.FC_DIM", 128,
        "MODEL.ROI_HEADS.POOLER_IMPL", "exact", "MODEL.RPN.PRE_NMS_TOPK_TRAIN", 200,
        "MODEL.RPN.POST_NMS_TOPK_TRAIN", 100, "MODEL.RPN.BATCH_SIZE_PER_IMAGE", 8192,
        "MODEL.RPN.POSITIVE_FRACTION", 0.999, "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", 128,
        "MODEL.ROI_HEADS.POSITIVE_FRACTION", 0.999, "MODEL.RPN.PRE_NMS_TOPK_TEST", 200,
        "MODEL.RPN.POST_NMS_TOPK_TEST", 100, "TEST.DETECTIONS_PER_IMAGE", 30,
        "MODEL.META_ARCHITECTURE", "GeneralizedRCNN_Context", *opts,
    ])
    return cfg


def _batch():
    rng = np.random.RandomState(3)
    gt_boxes = np.zeros((B, G, 4), np.float32)
    gt_boxes[0, :3] = [[20, 30, 90, 100], [60, 10, 150, 70], [5, 70, 40, 120]]
    gt_boxes[1, :3] = [[100, 20, 180, 110], [10, 10, 60, 50], [70, 60, 130, 100]]
    return {
        "image": (rng.rand(B, H, W, 3) * 255).astype(np.float32),
        "image_size": np.array([[H, W], [112, 160]], np.int32),
        "gt_boxes": gt_boxes,
        "gt_classes": np.array([[3, 1, 3, 0], [0, 2, 4, 0]], np.int32),
        "gt_valid": np.array([[True] * 3 + [False]] * B),
    }


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def _scale(var):
    """tests/test_torch_rcnn.py's scaling: spread RPN logits and class
    scores, so that no near-tie can reorder them."""
    for block in var["params"]["backbone"]["bottom_up"].values():
        for path, leaf in _leaves(block):
            if path[-1] == "kernel":
                leaf *= 0.7
    if "proposal_generator" in var["params"]:
        rpn = var["params"]["proposal_generator"]["rpn_head"]
        rpn["conv"]["conv"]["kernel"] *= 0.1
        rpn["objectness_logits"]["conv"]["kernel"] *= 0.1
        rpn["anchor_deltas"]["conv"]["kernel"] *= 0.01
    head = var["params"]["roi_heads"]["box_predictor"]
    head["cls_score"]["kernel"] *= 0.03
    head["bbox_pred"]["kernel"] *= 0.3
    return var


def _variables(jmodel, batch):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    shapes = jax.eval_shape(functools.partial(jmodel.init, train=False), {"params": jax.random.PRNGKey(0)}, jb)
    var = jax.tree_util.tree_map(lambda v: np.array(v, np.float32), materialize_variables(shapes, seed=0, conv_init="he"))
    return var


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _check_detections(got: Detections, want):
    want = [np.asarray(x) for x in want]
    np.testing.assert_array_equal(got.valid.numpy(), want[3])
    v = want[3]
    assert v.sum() > 5
    np.testing.assert_array_equal(got.classes.numpy()[v], want[2][v])
    np.testing.assert_allclose(got.boxes.numpy()[v], want[0][v], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got.scores.numpy()[v], want[1][v], rtol=0, atol=1e-4)


@pytest.fixture(scope="module")
def context():
    """JAX's variables, its losses and gradients of one training forward and
    its eval output. (JAX's ``images_only`` only drops the other outputs,
    ``lvc_tpu/modeling/meta_arch/rcnn.py:187-188,199-200``, so the port's
    IMAGES_ONLY outputs are held to these.)"""
    jcfg = _narrow(jax_get_cfg())
    jmodel = jax_build_model(jcfg)
    batch = _batch()
    var = _scale(_variables(jmodel, {k: batch[k] for k in ("image", "image_size")}))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.PRNGKey(7)

    def loss_fn(params):
        losses = jmodel.apply({"params": params, "batch_stats": var["batch_stats"]}, jb, train=True,
                              rngs={"sampling": key, "dropout": key})
        return sum(losses.values()), losses

    (_, losses), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(var["params"])
    out = jax.jit(lambda v, b: jmodel.apply(v, b, train=False))(var, {k: jb[k] for k in ("image", "image_size")})
    return var, {k: float(v) for k, v in losses.items()}, jax.tree_util.tree_map(np.asarray, grads), out


def _port(var, *opts):
    model = build_model(_narrow(get_cfg(), *opts), device="cpu")
    model.load_state_dict(from_flax(var))
    return model


def test_context_losses_and_gradients_match_jax(context):
    var, want, j_grads, *_ = context
    model = _port(var).train()
    losses = model(_batch(), torch.Generator().manual_seed(0))
    assert set(losses) == set(want) == {"loss_context", "loss_cls", "loss_box_reg", "loss_rpn_cls", "loss_rpn_loc"}
    for k, v in want.items():
        assert float(losses[k].detach()) == pytest.approx(v, rel=1e-5, abs=1e-7), k
    assert want["loss_context"] > 0 and want["loss_box_reg"] > 0
    sum(losses.values()).backward()
    j_grad = from_flax({"params": j_grads})
    for name, p in model.named_parameters():
        g = torch.zeros_like(p) if p.grad is None else p.grad
        if name.startswith("cont_conv."):
            assert p.grad is None and not j_grad[name].any(), name
            continue
        assert _rel_l2(g.numpy(), j_grad[name].numpy()) <= 1e-4, name
    assert model.cont_cls.weight.grad.abs().sum() > 0


def test_context_eval_and_images_only_match_jax(context):
    var, want, _, out = context
    batch = {k: v for k, v in _batch().items() if k in ("image", "image_size")}
    got = _port(var)(batch)
    assert set(got) == {"detections", "image_scores"}
    np.testing.assert_allclose(got["image_scores"].numpy(), np.asarray(out["image_scores"]), rtol=0, atol=1e-5)
    _check_detections(got["detections"], out["detections"])

    model = _port(var, "MODEL.IMAGES_ONLY", True)
    scores = model(batch)
    assert set(scores) == {"image_scores"}
    np.testing.assert_allclose(scores["image_scores"].numpy(), np.asarray(out["image_scores"]), rtol=0, atol=1e-5)
    losses = model.train()(_batch(), torch.Generator())
    assert set(losses) == {"loss_context"}
    assert float(losses["loss_context"]) == pytest.approx(want["loss_context"], rel=1e-5)


def test_context_weights_round_trip_and_reference_names(context):
    """``to_flax`` gives back JAX's tree for the context head, and the
    port's names are the reference's (``cont_conv.{weight,bias}``,
    ``cont_cls.weight``), loaded strictly."""
    var = context[0]
    model = _port(var)
    back = dict(_leaves(to_flax(model.state_dict())["params"]))
    for path, want in _leaves(var["params"]):
        np.testing.assert_array_equal(back[path], want)
    names = {k for k in model.state_dict() if k.startswith("cont_")}
    assert names == {"cont_conv.weight", "cont_conv.bias", "cont_cls.weight"}


@pytest.mark.parametrize("pooler", ["avg", "max", "identity"])
def test_rpn_comp_matches_jax(pooler):
    opts = ["MODEL.META_ARCHITECTURE", "RPNComp", "MODEL.BACKBONE.NAME", "build_resnet_backbone",
            "MODEL.RESNETS.OUT_FEATURES", ["res5"], "MODEL.RESNETS.RES2_OUT_CHANNELS", 16,
            "MODEL.RESNETS.WIDTH_PER_GROUP", 4, "MODEL.RESNETS.STEM_OUT_CHANNELS", 16,
            "MODEL.RPNCOMP.POOLER", pooler]
    jcfg, tcfg = jax_get_cfg(), get_cfg()
    jcfg.merge_from_list(opts)
    tcfg.merge_from_list(opts)
    jmodel = jax_build_model(jcfg)
    rng = np.random.RandomState(5)
    batch = {"image": (rng.rand(3, 64, 64, 3) * 255).astype(np.float32),
             "image_size": np.array([[64, 64], [64, 64], [48, 40]], np.int32)}
    var = _variables(jmodel, batch)
    want = np.asarray(jax.jit(lambda v, b: jmodel.apply(v, b, train=False))(var, batch))
    model = build_model(tcfg, device="cpu")
    model.load_state_dict(from_flax(var))
    got = model(batch).numpy()
    assert got.shape == want.shape == ((3, 128) if pooler != "identity" else (3, 2, 2, 128))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * max(1.0, float(np.abs(want).max())))
    with pytest.raises(RuntimeError, match="inference only"):
        model.train()(batch)


def test_precomputed_proposals_match_jax():
    opts = ("MODEL.META_ARCHITECTURE", "GeneralizedRCNN", "MODEL.PROPOSAL_GENERATOR.NAME", "PrecomputedProposals")
    jmodel = jax_build_model(_narrow(jax_get_cfg(), *opts))
    rng = np.random.RandomState(9)
    R = 40
    xy = rng.rand(B, R, 2) * [W - 40, H - 40]
    wh = 8 + rng.rand(B, R, 2) * 60
    batch = {
        "image": _batch()["image"], "image_size": _batch()["image_size"],
        "proposal_boxes": np.concatenate([xy, xy + wh], -1).astype(np.float32),
        "proposal_logits": rng.randn(B, R).astype(np.float32),
        "proposal_valid": np.arange(R)[None, :] < np.array([[R], [R - 7]]),
    }
    var = _scale(_variables(jmodel, batch))
    want = jax.jit(lambda v, b: jmodel.apply(v, b, train=False))(var, {k: jnp.asarray(v) for k, v in batch.items()})
    model = build_model(_narrow(get_cfg(), *opts), device="cpu")
    assert model.proposal_generator is None
    model.load_state_dict(from_flax(var))
    _check_detections(model(batch), want)


def test_gdl_matches_jax():
    rng = np.random.RandomState(2)
    x = rng.randn(4, 6).astype(np.float32)
    up = rng.randn(4, 6).astype(np.float32)
    for scale in (0.0, 0.01, 0.5):
        want, vjp = jax.vjp(lambda a: jgdl.decouple_layer(a, scale), jnp.asarray(x))
        xt = torch.tensor(x, requires_grad=True)
        got = decouple_layer(xt, scale)
        got.backward(torch.tensor(up))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-6)
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(vjp(jnp.asarray(up))[0]), atol=1e-6)
    for use_bias in (True, False):
        jlayer = jgdl.AffineLayer(features=6, use_bias=use_bias)
        params = {"weight": rng.randn(6).astype(np.float32)}
        if use_bias:
            params["bias"] = rng.randn(6).astype(np.float32)
        want, vjp = jax.vjp(lambda p, a: jlayer.apply({"params": p}, a), params, jnp.asarray(x))
        layer = AffineLayer(6, use_bias)
        fresh = dict(layer.named_parameters())
        assert set(fresh) == set(params) and all(float(fresh["weight"][i]) == 1.0 for i in range(6))
        with torch.no_grad():
            for k, v in params.items():
                getattr(layer, k).copy_(torch.from_numpy(v))
        xt = torch.tensor(x, requires_grad=True)
        got = layer(xt)
        got.backward(torch.tensor(up))
        g_params, g_x = vjp(jnp.asarray(up))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-6)
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g_x), atol=1e-6)
        for k in params:
            np.testing.assert_allclose(getattr(layer, k).grad.numpy(), np.asarray(g_params[k]), atol=1e-5)


def test_clustering_matches_jax():
    rng = np.random.RandomState(4)
    N, D, P, K = 600, 24, 12, 6
    # clusters along distinct directions, columns scaled so that no two
    # eigenvalues of the covariance are near-equal
    centers = rng.randn(K, D) * 4
    x = (centers[rng.randint(K, size=N)] + rng.randn(N, D)) * np.linspace(1.0, 3.0, D)
    x = x.astype(np.float32)
    want, (j_mean, j_comp) = jclust.preprocess_features(x, P)
    got, (mean, comp) = clustering.preprocess_features(torch.from_numpy(x), P, device="cpu")
    got = got.numpy()
    # eigh fixes no sign: align each column with JAX's before comparing
    sign = np.sign((got * want).sum(axis=0))
    assert (sign != 0).all()
    np.testing.assert_allclose(got * sign, want, rtol=0, atol=1e-4)
    np.testing.assert_allclose(mean.numpy(), j_mean, rtol=0, atol=1e-5)
    np.testing.assert_allclose(comp.numpy() * sign, j_comp, rtol=1e-3, atol=1e-5)

    gen = torch.Generator().manual_seed(3)
    idx = clustering.init_indices(N, K, gen)
    assert len(set(idx.tolist())) == K
    data = torch.from_numpy(want.astype(np.float32))
    centroids, assign, inertia = clustering.kmeans_run(data, data[idx], 20)
    j_cent, j_assign, j_inertia = jclust._kmeans_run(jnp.asarray(want), jnp.asarray(want[idx.numpy()]), 20)
    np.testing.assert_array_equal(assign.numpy(), np.asarray(j_assign))
    np.testing.assert_allclose(centroids.numpy(), np.asarray(j_cent), rtol=0, atol=1e-5)
    assert float(inertia) == pytest.approx(float(j_inertia), rel=1e-5)
    labels, loss = clustering.run_kmeans(data, K, 20, torch.Generator().manual_seed(3))
    np.testing.assert_array_equal(labels.numpy(), assign.numpy())
    km = clustering.Kmeans(K, pca_dim=P, device="cpu")
    km.cluster(x)
    assert sorted(i for lst in km.images_lists for i in lst) == list(range(N))
