"""The port's box corrector against the JAX package on the CPU: the matched
IoU and GIoU, the random box generator, the cascade heads (per-stage
losses and gradients, the iterated UBBR heads, the single-step UBBR heads),
reg-only inference, full cascade inference and the weight bridge of the
cascade names. The GIoU loss branch is held in tests/test_torch_losses.py.

Models are narrow R-50-FPNs (RES2_OUT_CHANNELS 64, WIDTH_PER_GROUP 16, FPN
64 wide, FC 128) on a B=2 64x96 canvas, float32, POOLER_IMPL auto (the exact
point gather on the CPU in both packages). JAX weights come over by
``from_flax``. Sampling cannot match draw for draw (``jax.random`` against a
``torch.Generator``, 64 of up to 128 boxes sampled), so the deterministic
parts are held with JAX's own draws injected: the RBG jitter from JAX's key
splits, and the training stage loop from the ``SampledProposals`` JAX's
``CascadeROIHeads`` returns.

Tolerances: IoU and GIoU abs 1e-6; RBG boxes abs
1e-4 (``exp`` may differ by an ulp between the frameworks), validity equal;
per-stage losses rel 1e-5; box-head and FPN-output gradients rel L2 1e-4
(the convs and the pool's backward sum in other orders; it also checks the
1/3 scaling of each stage's pooled gradient); reg-only boxes abs 1e-4; full
cascade detections boxes abs 1e-3 and scores rel 1e-4 with the weights scaled
so that the class scores spread (as tests/test_torch_rcnn.py does); the
weight bridge exact, with equal key sets.
"""
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from lvc_tpu.config import get_cfg as jax_get_cfg
from lvc_tpu.modeling.meta_arch.build import build_model as jax_build_model
from lvc_tpu.modeling.proposal_generator.rbg import RBG as JaxRBG
from lvc_tpu.modeling.roi_heads.cascade_rcnn import CascadeROIHeads as JaxCascade
from lvc_tpu.structures import boxes as jax_boxes
from lvc_tpu.utils.init import materialize_variables

from lvc_tpu_torch.checkpoint.convert import from_flax, to_flax
from lvc_tpu_torch.config import get_cfg
from lvc_tpu_torch.modeling.meta_arch.build import build_model
from lvc_tpu_torch.modeling.proposal_generator.rbg import rbg_proposals
from lvc_tpu_torch.modeling.roi_heads.cascade_rcnn import RegOnlyOutput
from lvc_tpu_torch.modeling.roi_heads.roi_heads import SampledProposals
from lvc_tpu_torch.structures import boxes as box_ops

B, H, W, G = 2, 64, 96, 4
UBBR_YAML = "configs/COCO-detection/cascade_ubbr_R_50_FPN_base.yaml"


def _boxes(rng, n, size=96.0):
    xy = rng.uniform(0, size * 0.7, (n, 2))
    wh = rng.uniform(2, size * 0.4, (n, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def _pairs():
    """Seeded aligned box pairs with disjoint, nested, touching, equal and
    zero-area rows."""
    rng = np.random.RandomState(0)
    a, b = _boxes(rng, 64), _boxes(rng, 64)
    a[:8] = [[0, 0, 10, 10], [0, 0, 10, 10], [5, 5, 5, 9], [0, 0, 0, 0],
             [2, 2, 8, 8], [0, 0, 10, 10], [3, 3, 3, 3], [1, 1, 4, 6]]
    b[:8] = [[20, 20, 30, 30], [2, 2, 8, 8], [0, 0, 10, 10], [0, 0, 0, 0],
             [0, 0, 10, 10], [10, 0, 20, 10], [3, 3, 3, 3], [1, 1, 4, 6]]
    return a, b


@pytest.mark.parametrize("fn", ["matched_pairwise_iou", "pairwise_giou"])
def test_aligned_overlaps_match_jax(fn):
    a, b = _pairs()
    want = np.asarray(getattr(jax_boxes, fn)(jnp.asarray(a), jnp.asarray(b)))
    got = getattr(box_ops, fn)(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


# ------------------------------------------------------------------- RBG

class _KeyedRBG(JaxRBG):
    """JAX's RBG drawing from a fixed key, so the test can recompute its
    draws."""

    key: jax.Array = None

    def make_rng(self, name="params"):
        return self.key


def _jax_draws(rbg, key, n_images):
    """The draws of ``rbg.py:54-76``, from the same key splits."""
    M = 2 * rbg.positive_num
    lo, hi = np.log(1 - rbg.beta), np.log(1 + rbg.beta)
    out = []
    for k in jax.random.split(key, n_images):
        k1, k2, k3, k4 = jax.random.split(k, 4)
        out.append([
            jax.random.uniform(k1, (M,), minval=-rbg.alpha, maxval=rbg.alpha),
            jax.random.uniform(k2, (M,), minval=-rbg.alpha, maxval=rbg.alpha),
            jax.random.uniform(k3, (M,), minval=lo, maxval=hi),
            jax.random.uniform(k4, (M,), minval=lo, maxval=hi),
        ])
    return [torch.from_numpy(np.stack([np.asarray(d[i]) for d in out])) for i in range(4)]


@pytest.mark.parametrize("with_proposals", [False, True])
def test_rbg_matches_jax_with_its_draws(with_proposals):
    """Image 0: valid gts at slots 0 and 2 (not contiguous); image 1: no
    valid gt (keeps nothing); image 2: three gts, one box near the image
    edge (clipped)."""
    rng = np.random.RandomState(2)
    n_img = 3
    gt = np.stack([_boxes(rng, G, 90) for _ in range(n_img)])
    gt[2, 0] = [60, 40, 95, 63]
    gtv = np.array([[1, 0, 1, 0], [0, 0, 0, 0], [1, 1, 1, 0]], bool)
    sizes = np.array([[64, 96], [64, 96], [60, 90]], np.int32)
    props = np.stack([_boxes(rng, 12, 90) for _ in range(n_img)]) if with_proposals else None
    pvalid = rng.rand(n_img, 12) > 0.2 if with_proposals else None
    key = jax.random.PRNGKey(7)
    rbg = _KeyedRBG(alpha=0.35, beta=0.5, t=0.3, batch_size_per_image=16, positive_fraction=1.0, key=key)
    kwargs = {} if not with_proposals else dict(
        proposal_boxes=jnp.asarray(props), proposal_logits=jnp.zeros((n_img, 12)),
        proposal_valid=jnp.asarray(pvalid))
    w_boxes, w_logits, w_valid, _ = rbg.apply({}, None, jnp.asarray(sizes), jnp.asarray(gt), jnp.asarray(gtv),
                                              train=True, **kwargs)
    draws = _jax_draws(rbg, key, n_img)
    got = rbg_proposals(torch.from_numpy(gt), torch.from_numpy(gtv), torch.from_numpy(sizes), *draws, 0.3,
                        None if props is None else torch.from_numpy(props),
                        None if pvalid is None else torch.from_numpy(pvalid))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(w_valid))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(w_boxes), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(w_logits))
    n_props = 12 if with_proposals else 0
    assert not got[2][1].any()
    assert got[2][0, n_props:].sum() > 8 and got[2][2, n_props:].sum() > 8
    assert got[0][..., 2].max() <= 96


# --------------------------------------------------------- cascade heads

def _cfg(get_cfg_fn, heads="CascadeROIHeads", output="BoxOnlyLayersCascade", arch="GeneralizedRCNN"):
    cfg = get_cfg_fn()
    cfg.merge_from_file(UBBR_YAML)
    cfg.MODEL.META_ARCHITECTURE = arch
    cfg.MODEL.RESNETS.RES2_OUT_CHANNELS = 64
    cfg.MODEL.RESNETS.WIDTH_PER_GROUP = 16
    cfg.MODEL.FPN.OUT_CHANNELS = 64
    cfg.MODEL.ROI_BOX_HEAD.FC_DIM = 128
    cfg.MODEL.ROI_HEADS.NAME = heads
    cfg.MODEL.ROI_HEADS.OUTPUT_LAYER = output
    cfg.MODEL.ROI_HEADS.POOLER_IMPL = "auto"
    if arch != "GeneralizedRCNNRegOnly" and output == "FastRCNNOutputLayers":
        cfg.MODEL.PROPOSAL_GENERATOR.NAME = "RPN"
        cfg.MODEL.ROI_HEADS.NUM_CLASSES = 5
        cfg.MODEL.RPN.PRE_NMS_TOPK_TEST = 200
        cfg.MODEL.RPN.POST_NMS_TOPK_TEST = 100
        cfg.TEST.DETECTIONS_PER_IMAGE = 30
    return cfg


def _batch():
    rng = np.random.RandomState(3)
    gt = np.zeros((B, G, 4), np.float32)
    gt[0, :3] = [[6, 8, 40, 50], [30, 5, 80, 40], [2, 30, 30, 62]]
    gt[1, [0, 2, 3]] = [[40, 10, 90, 55], [5, 5, 35, 30], [30, 25, 70, 50]]
    return {
        "image": (rng.rand(B, H, W, 3) * 255).astype(np.float32),
        "image_size": np.array([[H, W], [56, 80]], np.int32),
        "gt_boxes": gt,
        "gt_classes": np.array([[3, 1, 40, 0], [7, 0, 2, 59]], np.int32),
        "gt_valid": np.array([[1, 1, 1, 0], [1, 0, 1, 1]], bool),
    }


def _candidates():
    """The batch's gt slots, moved by a seeded jitter (the reg-only input)."""
    batch = _batch()
    rng = np.random.RandomState(4)
    cands = batch["gt_boxes"] + rng.uniform(-4, 4, batch["gt_boxes"].shape).astype(np.float32)
    return dict(batch, gt_boxes=np.where(batch["gt_valid"][..., None], cands, batch["gt_boxes"]))


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def _variables(cfg, arch):
    """He-init JAX variables for ``cfg`` (initialised through the reg-only
    forward, or the detector's for an RPN model), the backbone damped and
    every regressor scaled down so that the stages move their boxes by a
    few pixels; the classifiers spread their scores."""
    init_cfg = cfg.clone()
    init_cfg.MODEL.META_ARCHITECTURE = arch
    model = jax_build_model(init_cfg)
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}
    shapes = jax.eval_shape(functools.partial(model.init, train=False), {"params": jax.random.PRNGKey(0)}, batch)
    var = jax.tree_util.tree_map(np.asarray, materialize_variables(shapes, seed=0, conv_init="he"))
    for path, leaf in _leaves(var["params"]):
        if path[0] == "backbone" and path[1] == "bottom_up" and path[-1] == "kernel":
            leaf *= 0.7
        elif "bbox_pred" in path and path[-1] == "kernel":
            leaf *= 0.05
        elif "cls_score" in path and path[-1] == "kernel":
            leaf *= 0.3
        elif path[:3] == ("proposal_generator", "rpn_head", "conv") or "objectness_logits" in path:
            leaf *= 0.1
        elif "anchor_deltas" in path:
            leaf *= 0.01
    return var


def _port(cfg, var, train):
    model = build_model(cfg, device="cpu")
    model.load_state_dict(from_flax(var), strict=True)
    return model.train(train)


def _grads_by_port_name(grads):
    """JAX parameter gradients under the port's names and layout."""
    return {k: v.double() for k, v in from_flax({"params": jax.tree_util.tree_map(np.asarray, grads)}).items()}


def _rel_l2(a, b):
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


@pytest.mark.parametrize("heads", ["CascadeROIHeads", "CascadeUBBRROIHeads"])
def test_cascade_training_stages_match_jax(heads):
    """JAX's training forward (losses and gradients, its sampled slots
    captured); the port's stage loop from those slots."""
    cfg = _cfg(jax_get_cfg, heads)
    var = _variables(cfg, "GeneralizedRCNNRegOnly")
    model = jax_build_model(cfg)
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}

    def loss(params):
        losses, state = model.apply(
            {"params": params, "batch_stats": var["batch_stats"]}, batch, train=True,
            rngs={"sampling": jax.random.PRNGKey(5), "dropout": jax.random.PRNGKey(6)},
            capture_intermediates=lambda mdl, name: isinstance(mdl, JaxCascade) and name == "__call__",
            mutable=["intermediates"],
        )
        return sum(losses.values()), (losses, state["intermediates"]["roi_heads"]["__call__"][0][1])

    (_, (want, sampled)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(var["params"])
    want_grads = _grads_by_port_name(grads)

    port = _port(_cfg(get_cfg, heads), var, train=True)
    b = {k: torch.from_numpy(v) for k, v in _batch().items()}
    gt = {"boxes": b["gt_boxes"], "classes": b["gt_classes"], "valid": b["gt_valid"]}
    features = port.backbone(port.model_images(b))
    sampled = SampledProposals(*(torch.from_numpy(np.asarray(t)) for t in sampled))
    got = port.roi_heads.cascade_losses(features, sampled, gt, b["image_size"])
    sum(got.values()).backward()

    stage = "step" if heads == "CascadeUBBRROIHeads" else "stage"
    assert set(got) == set(want) == {f"loss_box_reg_{stage}{k}" for k in range(3)}
    for k in want:
        assert float(got[k].detach()) == pytest.approx(float(want[k]), rel=1e-5), k
        assert float(want[k]) > 0, k
    checked = 0
    for name, p in port.named_parameters():
        if name.startswith(("roi_heads.", "backbone.fpn_output")):
            assert _rel_l2(p.grad.double(), want_grads[name]) < 1e-4, name
            checked += 1
    assert checked >= (8 + 8 if heads == "CascadeUBBRROIHeads" else 8 + 24)


@pytest.mark.parametrize("heads,output", [
    ("CascadeROIHeads", "BoxOnlyLayersCascade"),
    ("CascadeUBBRROIHeads", "BoxOnlyLayersCascade"),
    ("UBBRROIHeads", "FastRCNNOutputLayers"),
])
def test_reg_only_inference_matches_jax(heads, output):
    cfg = _cfg(jax_get_cfg, heads, output, arch="GeneralizedRCNNRegOnly")
    var = _variables(cfg, "GeneralizedRCNNRegOnly")
    batch = _candidates()
    model = jax_build_model(cfg)
    want = jax.jit(functools.partial(model.apply, train=False))(var, {k: jnp.asarray(v) for k, v in batch.items()})
    port = _port(_cfg(get_cfg, heads, output, arch="GeneralizedRCNNRegOnly"), var, train=False)
    got = port(batch)
    assert isinstance(got, RegOnlyOutput)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.classes.numpy(), np.asarray(want.classes))
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes), rtol=0, atol=1e-4)
    moved = np.abs(got.boxes.numpy() - batch["gt_boxes"])[got.valid.numpy()]
    assert 0.05 < moved.max() < 50  # the stages move the boxes, by pixels
    if heads != "UBBRROIHeads":  # class 59 is valid, the padding slot is not
        assert got.valid.numpy().tolist() == [[True, True, True, False], [True, False, True, True]]


def test_cascade_full_inference_matches_jax():
    """``CascadeROIHeads`` with ``FastRCNNOutputLayers`` behind the RPN: the
    stages' averaged softmax and the last stage's boxes."""
    cfg = _cfg(jax_get_cfg, output="FastRCNNOutputLayers")
    var = _variables(cfg, "GeneralizedRCNN")
    batch = {k: v for k, v in _batch().items() if k in ("image", "image_size")}
    model = jax_build_model(cfg)
    want = jax.jit(functools.partial(model.apply, train=False))(var, {k: jnp.asarray(v) for k, v in batch.items()})
    got = _port(_cfg(get_cfg, output="FastRCNNOutputLayers"), var, train=False)(batch)
    v = got.valid.numpy()
    np.testing.assert_array_equal(v, np.asarray(want.valid))
    assert v.sum() >= 10
    np.testing.assert_array_equal(got.classes.numpy()[v], np.asarray(want.classes)[v])
    np.testing.assert_allclose(got.boxes.numpy()[v], np.asarray(want.boxes)[v], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got.scores.numpy()[v], np.asarray(want.scores)[v], rtol=1e-4)


@pytest.mark.parametrize("heads,output", [
    ("CascadeROIHeads", "BoxOnlyLayersCascade"),
    ("CascadeROIHeads", "FastRCNNOutputLayers"),
    ("CascadeUBBRROIHeads", "BoxOnlyLayersCascade"),
])
def test_cascade_weight_bridge_round_trip(heads, output):
    """The flax tree of every cascade head layout carries into the port's
    model with no key missing or left over, and back unchanged."""
    cfg = _cfg(jax_get_cfg, heads, output, arch="GeneralizedRCNNRegOnly")
    var = _variables(cfg, "GeneralizedRCNNRegOnly")
    sd = from_flax(var)
    port = build_model(_cfg(get_cfg, heads, output, arch="GeneralizedRCNNRegOnly"), device="cpu")
    assert set(sd) == set(port.state_dict())
    if heads == "CascadeROIHeads":
        assert "roi_heads.box_head.2.fc3.weight" in sd and "roi_heads.box_predictor.1.bbox_pred.bias" in sd
        assert "box_head_2" in var["params"]["roi_heads"]
    else:
        assert "roi_heads.box_head.fc1.weight" in sd and "roi_heads.box_predictor.bbox_pred.weight" in sd
    back = to_flax(sd)
    want = dict(_leaves(var))
    got = dict(_leaves(back))
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v)
