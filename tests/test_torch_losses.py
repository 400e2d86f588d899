"""The port's training losses against the JAX package on the CPU: box
deltas, the Fast R-CNN losses and the RPN losses, and the gradient that
reaches the RPN through the proposals.

Inputs are made with numpy from a seed and JAX weights are carried over by
``from_flax``. Tolerances: deltas to rel 1e-6 (the same float32 formulas);
losses to rel 1e-5; gradients to rel L2 1e-4 (the convs sum in another
order). RPN sampling is exhaustive (BATCH_SIZE_PER_IMAGE >= the anchor
count, POSITIVE_FRACTION 0.999), so both samplers pick the same anchors.

The proposal-gradient question: the JAX package puts no stop_gradient
between the RPN and the ROI heads (``rpn.py:238-288`` decodes the proposals
with differentiable ops; ``roi_heads.py:384-411`` gathers them and feeds them
to ``get_deltas`` in ``fast_rcnn_losses``), so ``loss_box_reg`` reaches
``rpn_head.anchor_deltas``; detectron2 detaches its proposals. The two links
are tested separately (no pool, which is slow in interpret mode): the RPN's
unclipped output boxes have a nonzero gradient in ``anchor_deltas``, and
``fast_rcnn_losses`` a nonzero gradient in the proposal boxes, in JAX, and the
port gives the same gradients: it does not detach either.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from lvc_tpu.modeling.box_regression import Box2BoxTransform as JaxB2B
from lvc_tpu.modeling.proposal_generator.rpn import RPN as JaxRPN
from lvc_tpu.modeling.roi_heads.fast_rcnn import fast_rcnn_losses as jax_fast_rcnn_losses

from lvc_tpu_torch.checkpoint.convert import from_flax
from lvc_tpu_torch.modeling.box_regression import Box2BoxTransform
from lvc_tpu_torch.modeling.proposal_generator.rpn import RPN
from lvc_tpu_torch.modeling.roi_heads.fast_rcnn import fast_rcnn_losses

WEIGHTS = (10.0, 10.0, 5.0, 5.0)


def _boxes(rng, n, size=200.0):
    xy = rng.uniform(0, size * 0.7, (n, 2))
    wh = rng.uniform(4, size * 0.3, (n, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def test_get_deltas_matches_jax():
    rng = np.random.RandomState(0)
    src, tgt = _boxes(rng, 64), _boxes(rng, 64)
    src[:4] = [[5, 5, 5, 9], [3, 3, 1, 8], [0, 0, 0, 0], [2, 7, 9, 7]]  # w or h <= 0: guarded
    tgt[4:6] = [[1, 1, 1, 1], [0, 0, 0, 0]]
    want = np.asarray(JaxB2B(WEIGHTS).get_deltas(jnp.asarray(src), jnp.asarray(tgt)))
    got = Box2BoxTransform(WEIGHTS).get_deltas(torch.from_numpy(src), torch.from_numpy(tgt)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def _fast_rcnn_inputs(cls_agnostic):
    rng = np.random.RandomState(1)
    N, K = 48, 6
    logits = rng.randn(N, K + 1).astype(np.float32) * 2
    deltas = rng.randn(N, 4 if cls_agnostic else 4 * K).astype(np.float32) * 0.3
    props = _boxes(rng, N)
    gt = props + rng.uniform(-6, 6, props.shape).astype(np.float32)
    classes = rng.randint(0, K + 1, N).astype(np.int32)  # K = background
    classes[:5] = -1  # ignore rows
    valid = np.ones(N, bool)
    valid[-8:] = False  # padding rows
    props[-3:] = 0.0  # padding rows hold zero boxes
    return logits, deltas, props, gt, classes, valid


@pytest.mark.parametrize("cls_agnostic", [False, True])
def test_fast_rcnn_losses_match_jax(cls_agnostic):
    logits, deltas, props, gt, classes, valid = _fast_rcnn_inputs(cls_agnostic)
    want = jax_fast_rcnn_losses(
        *(jnp.asarray(x) for x in (logits, deltas, props, gt, classes, valid)), JaxB2B(WEIGHTS)
    )
    got = fast_rcnn_losses(
        *(torch.from_numpy(x) for x in (logits, deltas, props, gt, classes, valid)),
        Box2BoxTransform(WEIGHTS),
    )
    assert set(got) == set(want)
    for k in want:
        assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-5), k
    assert float(got["loss_box_reg"]) > 0


@pytest.mark.parametrize("cls_agnostic", [False, True])
def test_fast_rcnn_losses_giou_names_the_roadmap(cls_agnostic):
    """The ``giou`` branch (ROADMAP queue 1, item 5; ported with the box
    corrector) against JAX's, class-specific and class-agnostic: ``1 - GIoU``
    of the decoded boxes over the foreground rows, divided by all valid
    rows."""
    logits, deltas, props, gt, classes, valid = _fast_rcnn_inputs(cls_agnostic)
    want = jax_fast_rcnn_losses(
        *(jnp.asarray(x) for x in (logits, deltas, props, gt, classes, valid)), JaxB2B(WEIGHTS),
        box_reg_loss_type="giou",
    )
    got = fast_rcnn_losses(
        *(torch.from_numpy(x) for x in (logits, deltas, props, gt, classes, valid)),
        Box2BoxTransform(WEIGHTS), box_reg_loss_type="giou",
    )
    assert set(got) == set(want)
    for k in want:
        assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-5), k
    assert float(got["loss_box_reg"]) > 0


def test_fast_rcnn_loss_gradient_reaches_proposals():
    """Link 2 of the proposal gradient: d loss_box_reg / d proposal boxes is
    nonzero in JAX, and the port's equals it."""
    logits, deltas, props, gt, classes, valid = _fast_rcnn_inputs(False)

    def jax_loss(p):
        return jax_fast_rcnn_losses(
            jnp.asarray(logits), jnp.asarray(deltas), p, jnp.asarray(gt),
            jnp.asarray(classes), jnp.asarray(valid), JaxB2B(WEIGHTS),
        )["loss_box_reg"]

    want = np.asarray(jax.grad(jax_loss)(jnp.asarray(props)))
    p = torch.from_numpy(props).requires_grad_()
    fast_rcnn_losses(
        torch.from_numpy(logits), torch.from_numpy(deltas), p, torch.from_numpy(gt),
        torch.from_numpy(classes), torch.from_numpy(valid), Box2BoxTransform(WEIGHTS),
    )["loss_box_reg"].backward()
    assert np.abs(want).sum() > 0
    np.testing.assert_allclose(p.grad.numpy(), want, rtol=1e-5, atol=1e-7)


# ------------------------------------------------------------------------ RPN

LEVELS = ("p2", "p3", "p4", "p5", "p6")
STRIDES = {f"p{i}": 2 ** i for i in range(2, 7)}
IMG = 64  # anchors: 3 * (16^2 + 8^2 + 4^2 + 2^2 + 1) = 1023 per image
C = 8


def _rpn_kwargs(ignore_regions=False):
    return dict(
        in_features=LEVELS, strides=STRIDES, anchor_sizes=((32,), (64,), (128,), (256,), (512,)),
        anchor_aspect_ratios=((0.5, 1.0, 2.0),), head_conv_dim=C, batch_size_per_image=2048,
        positive_fraction=0.999, pre_nms_topk_test=300, post_nms_topk_test=100,
        pre_nms_topk_train=300, post_nms_topk_train=100, ignore_regions=ignore_regions,
    )


def _rpn_inputs():
    rng = np.random.RandomState(4)
    B = 2
    feats = {
        f: rng.randn(B, IMG // s, IMG // s, C).astype(np.float32)
        for f, s in STRIDES.items()
    }
    gt = np.array(
        [[[4, 6, 30, 40], [20, 20, 60, 50], [0, 30, 25, 64], [10, 10, 50, 50]],
         [[30, 2, 62, 34], [5, 5, 20, 20], [0, 0, 0, 0], [8, 40, 40, 62]]], np.float32
    )
    valid = np.array([[1, 1, 1, 1], [1, 1, 0, 1]], bool)
    ignores = np.array([[0, 0, 0, 1], [0, 0, 0, 1]], bool)  # row 3: an ignore region
    sizes = np.array([[IMG, IMG], [56, 60]], np.int32)
    return feats, gt, valid, ignores, sizes


def _jax_rpn(ignore_regions=False):
    model = JaxRPN(**_rpn_kwargs(ignore_regions))
    feats, gt, valid, ignores, sizes = _rpn_inputs()
    jf = {k: jnp.asarray(v) for k, v in feats.items()}
    params = model.init(jax.random.PRNGKey(0), jf, jnp.asarray(sizes))["params"]
    # spread the logits and deltas: no near-ties in top-k or NMS
    params = jax.tree_util.tree_map(lambda x: x * 3.0 if x.ndim == 4 else x, params)
    return model, params, jf


def _port_rpn(params, ignore_regions=False, train=False):
    rpn = RPN(in_channels=C, **_rpn_kwargs(ignore_regions))
    rpn.load_state_dict(from_flax({"params": params}))
    return rpn.train(train)


def _nchw(feats):
    return {k: torch.from_numpy(v).permute(0, 3, 1, 2) for k, v in feats.items()}


@pytest.mark.parametrize("ignore_regions", [False, True], ids=["RPN", "RPN_Ignore"])
def test_rpn_losses_match_jax(ignore_regions):
    model, params, jf = _jax_rpn(ignore_regions)
    feats, gt, valid, ignores, sizes = _rpn_inputs()
    _, _, _, want = model.apply(
        {"params": params}, jf, jnp.asarray(sizes), jnp.asarray(gt), jnp.asarray(valid),
        jnp.asarray(ignores), train=True, rngs={"sampling": jax.random.PRNGKey(1)},
    )
    rpn = _port_rpn(params, ignore_regions, train=True)
    _, _, _, got = rpn(
        _nchw(feats), torch.from_numpy(sizes), torch.from_numpy(gt), torch.from_numpy(valid),
        torch.from_numpy(ignores), torch.Generator().manual_seed(0),
    )
    assert set(got) == set(want) == {"loss_rpn_cls", "loss_rpn_loc"}
    for k in want:
        assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-5), k
        assert float(want[k]) > 0


def test_rpn_ignore_regions_change_the_loss():
    _, params, _ = _jax_rpn(True)
    feats, gt, valid, ignores, sizes = _rpn_inputs()
    losses = []
    for ig in (ignores, np.zeros_like(ignores)):
        rpn = _port_rpn(params, True, train=True)
        losses.append(rpn(_nchw(feats), torch.from_numpy(sizes), torch.from_numpy(gt),
                          torch.from_numpy(valid), torch.from_numpy(ig))[3])
    assert float(losses[0]["loss_rpn_cls"]) != float(losses[1]["loss_rpn_cls"])


def test_rpn_without_ignore_rows_skips_the_ioa_exactly():
    """With RPN_Ignore off, or no ``gt_ignores`` given, the RPN skips the
    dense ignore-region IoA; its losses equal, bit for bit, those of the IoA
    path run on all-False ignores (same sampling priorities)."""
    _, params, _ = _jax_rpn(True)
    feats, gt, valid, ignores, sizes = _rpn_inputs()
    losses = []
    for ignore_regions, ig in ((True, np.zeros_like(ignores)), (False, ignores), (True, None)):
        rpn = _port_rpn(params, ignore_regions, train=True)
        losses.append(rpn(
            _nchw(feats), torch.from_numpy(sizes), torch.from_numpy(gt), torch.from_numpy(valid),
            None if ig is None else torch.from_numpy(ig), torch.Generator().manual_seed(0),
        )[3])
    for got in losses[1:]:
        for k, v in losses[0].items():
            assert torch.equal(got[k], v), k


def test_rpn_proposal_gradient_reaches_anchor_deltas():
    """Link 1 of the proposal gradient: a weighted sum of the RPN's unclipped
    output boxes has a nonzero gradient in ``anchor_deltas`` in JAX, and the
    port's equals it (proposals match slot for slot)."""
    model, params, jf = _jax_rpn()
    feats, _, _, _, sizes = _rpn_inputs()
    boxes, _, valid, _ = model.apply({"params": params}, jf, jnp.asarray(sizes))
    boxes, valid = np.asarray(boxes), np.asarray(valid)
    h, w = sizes[:, 0, None].astype(np.float32), sizes[:, 1, None].astype(np.float32)
    inside = valid & (boxes[..., 0] > 0) & (boxes[..., 1] > 0) & (boxes[..., 2] < w) & (boxes[..., 3] < h)
    assert inside.sum() > 20
    weights = np.random.RandomState(5).randn(*boxes.shape).astype(np.float32) * inside[..., None]

    def jax_obj(p):
        out = model.apply({"params": p}, jf, jnp.asarray(sizes))[0]
        return jnp.sum(out * weights)

    j_grads = jax.grad(jax_obj)(params)["rpn_head"]["anchor_deltas"]["conv"]
    rpn = _port_rpn(params)
    t_boxes, _, t_valid, _ = rpn(_nchw(feats), torch.from_numpy(sizes))
    np.testing.assert_array_equal(t_valid.numpy(), valid)
    np.testing.assert_allclose(t_boxes.detach().numpy(), boxes, rtol=1e-5, atol=1e-4)
    (t_boxes * torch.from_numpy(weights)).sum().backward()
    conv = rpn.rpn_head.anchor_deltas
    want_w = np.asarray(j_grads["kernel"]).transpose(3, 2, 0, 1)
    assert np.abs(want_w).sum() > 0
    for got, want in ((conv.weight.grad, want_w), (conv.bias.grad, np.asarray(j_grads["bias"]))):
        rel = np.linalg.norm(got.numpy() - want) / np.linalg.norm(want)
        assert rel <= 1e-4, rel
