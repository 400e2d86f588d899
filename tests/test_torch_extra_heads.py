"""The extra ROI heads and the debug inference against the JAX package on the
CPU, at the head level (``lvc_tpu/modeling/roi_heads/extra_heads.py``,
``fast_rcnn_debug.py``), plus the ``combine_parallel`` checkpoint.

Each head is built by both packages' ``build_roi_heads`` from the same config
(FPN heads: p2-p5 of a B=2 256x320 canvas, 16 channels, FC 32), JAX's seeded
weights carried over by ``from_flax``; features, proposals and gt are made
with numpy from a seed. Sampling is exhaustive (BATCH_SIZE_PER_IMAGE above
the proposals plus gt, POSITIVE_FRACTION 0.999), so both samplers take the
same sets; the pool is the exact point gather in both. Some gt boxes are
larger than 200 x 200, so the CascadeBBox branch loss is not 0.

Tolerances: losses rel 1e-5; gradients of every head parameter and of the
features rel L2 1e-4 (the pool's backward sums in another order); detections
equal in ``valid``, ``classes`` and ``proposal_idx``, boxes abs 1e-4 and
scores abs 1e-5, with the class scores spread so that no near-tie can
reorder them. (The C4 head: tests/test_torch_c4.py.)
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from lvc_tpu.checkpoint.convert import torch_to_flax
from lvc_tpu.config import get_cfg as jax_get_cfg
from lvc_tpu.modeling.meta_arch.build import build_roi_heads as jax_build_roi_heads
from lvc_tpu.utils.init import materialize_variables

from lvc_tpu_torch.checkpoint.convert import from_flax, to_flax
from lvc_tpu_torch.config import get_cfg
from lvc_tpu_torch.modeling.meta_arch.build import build_model, build_roi_heads
from lvc_tpu_torch.modeling.roi_heads.extra_heads import ParallelStandardROIHeads
from lvc_tpu_torch.modeling.roi_heads.fast_rcnn_debug import DetectionsDebug
from lvc_tpu_torch.tools import ckpt_surgery
from lvc_tpu_torch.utils.init import damped_init

B, H, W, C, R = 2, 256, 320, 16, 12
STRIDES = {"p2": 4, "p3": 8, "p4": 16, "p5": 32, "p6": 64}
HEADS = ("ParallelStandardROIHeads", "CascadeStandardROIHeads", "StandardROIHeadsCascadeBBox")


def _opts(name, debug=False):
    return [
        "MODEL.ROI_HEADS.NAME", name, "MODEL.ROI_HEADS.IN_FEATURES", ["p2", "p3", "p4", "p5"],
        "MODEL.ROI_HEADS.NUM_CLASSES", 80 if name == "ParallelStandardROIHeads" else 6,
        "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", 64, "MODEL.ROI_HEADS.POSITIVE_FRACTION", 0.999,
        "MODEL.ROI_HEADS.POOLER_IMPL", "exact", "MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION", 7,
        "MODEL.ROI_BOX_HEAD.NUM_FC", 2, "MODEL.ROI_BOX_HEAD.FC_DIM", 32,
        "MODEL.ROI_HEADS.SCORE_THRESH_TEST", 0.01, "TEST.DETECTIONS_PER_IMAGE", 8, "DEBUG", debug,
    ]


def _heads(opts, strides, channels, seed=0, cls_gain=30.0):
    """(JAX head, its variables, the port's head with the same weights)."""
    jcfg, tcfg = jax_get_cfg(), get_cfg()
    jcfg.merge_from_list(opts)
    tcfg.merge_from_list(opts)
    jheads = jax_build_roi_heads(jcfg, strides)
    return jheads, tcfg, lambda args: _materialize(jheads, args, seed, cls_gain, tcfg, strides, channels)


def _materialize(jheads, args, seed, cls_gain, tcfg, strides, channels):
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: jheads.init({"params": key, "sampling": key}, *args, train=True))
    var = materialize_variables(shapes, seed=seed, conv_init="he")
    var = jax.tree_util.tree_map(lambda v: np.asarray(v, np.float32), var)
    # spread the class scores (no near-ties) and give the regressors pixels to move
    for path, leaf in jax.tree_util.tree_flatten_with_path(var["params"])[0]:
        names = [getattr(p, "key", "") for p in path]
        if "cls_score" in names and names[-1] == "kernel":
            leaf *= cls_gain
        if "bbox_pred" in names and names[-1] == "kernel":
            leaf *= 0.3
    theads = build_roi_heads(tcfg, strides, channels)
    sd = from_flax({k: {"roi_heads": v} for k, v in var.items()})
    missing, unexpected = theads.load_state_dict({k[len("roi_heads."):]: v for k, v in sd.items()}, strict=True)
    assert not missing and not unexpected
    return var, theads


def fpn_inputs(seed=4):
    """Seeded p2-p5 features (NHWC), proposals, gt (some larger than 200^2)."""
    rng = np.random.RandomState(seed)
    feats = {f"p{l}": rng.normal(0, 1, (B, H // 2 ** l, W // 2 ** l, C)).astype(np.float32) for l in range(2, 6)}
    xy = rng.uniform(0, 120, (B, R, 2))
    wh = rng.uniform(16, 190, (B, R, 2))
    proposals = np.concatenate([xy, np.minimum(xy + wh, [W - 1, H - 1])], -1).astype(np.float32)
    gt_boxes = proposals[:, [0, 3, 7], :] + rng.uniform(-3, 3, (B, 3, 4)).astype(np.float32)
    gt_boxes[:, 0] = [[10.0, 12.0, 240.0, 238.0], [30.0, 4.0, 300.0, 250.0]]  # area > 200^2
    proposals[:, 0] = gt_boxes[:, 0] + 4.0
    # classes over seen (7, 9, 10) and unseen (0, 2, 5) ids of the 80
    gt = {"boxes": gt_boxes, "classes": np.array([[7, 0, 5], [2, 9, 10]], np.int32),
          "valid": np.array([[True, True, True], [True, True, False]])}
    sizes = np.array([[H, W], [H - 16, W - 32]], np.int32)
    return feats, proposals, np.ones((B, R), bool), sizes, gt


def nchw(feats, grad=False):
    return {k: torch.from_numpy(v).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
            .requires_grad_(grad) for k, v in feats.items()}


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def check_training(jheads, var, theads, feats, proposals, valid, sizes, gt, num_classes):
    """One training forward and backward of both heads: every loss to rel
    1e-5, the gradients of the features and every parameter the port has
    (FrozenBN affines are buffers there) to rel L2 1e-4."""
    jgt = {k: jnp.asarray(v % num_classes if k == "classes" else v) for k, v in gt.items()}
    args = (jnp.asarray(proposals), jnp.asarray(valid), jnp.asarray(sizes))
    key = jax.random.PRNGKey(0)

    def f(params, feats):
        losses, _ = jheads.apply(dict(var, params=params), feats, *args, jgt, train=True, rngs={"sampling": key})
        return sum(losses.values()), losses

    (_, j_losses), (j_gp, j_gf) = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(
        var["params"], {k: jnp.asarray(v) for k, v in feats.items()})

    theads.train()
    tf = nchw(feats, grad=True)
    tgt = {k: torch.from_numpy(np.array(v)) for k, v in jgt.items()}
    losses = theads(tf, torch.from_numpy(proposals), torch.from_numpy(valid), torch.from_numpy(sizes), tgt,
                    torch.Generator().manual_seed(0))
    sum(losses.values()).backward()
    assert set(losses) == set(j_losses)
    for k, v in j_losses.items():
        assert float(losses[k].detach()) == pytest.approx(float(v), rel=1e-5, abs=1e-7), k
    for k in feats:
        assert rel_l2(tf[k].grad.permute(0, 2, 3, 1), j_gf[k]) < 1e-4, k
    got = to_flax({f"roi_heads.{n}": p.grad for n, p in theads.named_parameters()})["params"]["roi_heads"]
    got = {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_flatten_with_path(got)[0]}
    want = {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_flatten_with_path(j_gp)[0]}
    assert set(got) <= set(want) and all("FrozenBatchNorm_0" in k for k in set(want) - set(got))
    for k, g in got.items():
        assert rel_l2(g, want[k]) < 1e-4, k
    return {k: float(v) for k, v in j_losses.items()}


def check_detections(jheads, var, theads, feats, proposals, valid, sizes, min_valid=8):
    """Eval-mode detections of both heads: ``valid``, ``classes`` and
    ``proposal_idx`` equal, boxes abs 1e-4, scores abs 1e-5 (and the top-2
    fields when JAX returns them). Returns the port's detections."""
    jd, _ = jax.jit(lambda v, f: jheads.apply(v, f, jnp.asarray(proposals), jnp.asarray(valid),
                                               jnp.asarray(sizes), None, train=False))(
        var, {k: jnp.asarray(v) for k, v in feats.items()})
    theads.eval()
    with torch.no_grad():
        td = theads(nchw(feats), torch.from_numpy(proposals), torch.from_numpy(valid), torch.from_numpy(sizes))
    assert type(td).__name__ == type(jd).__name__
    v = np.asarray(jd.valid)
    assert v.sum() >= min_valid
    np.testing.assert_array_equal(td.valid.numpy(), v)
    np.testing.assert_array_equal(td.classes.numpy()[v], np.asarray(jd.classes)[v])
    np.testing.assert_array_equal(td.proposal_idx.numpy()[v], np.asarray(jd.proposal_idx)[v])
    np.testing.assert_allclose(td.boxes.numpy()[v], np.asarray(jd.boxes)[v], atol=1e-4, rtol=0)
    np.testing.assert_allclose(td.scores.numpy()[v], np.asarray(jd.scores)[v], atol=1e-5, rtol=0)
    if isinstance(td, DetectionsDebug):
        np.testing.assert_array_equal(td.top2_inds.numpy()[v], np.asarray(jd.top2_inds)[v])
        np.testing.assert_allclose(td.top2_scores.numpy()[v], np.asarray(jd.top2_scores)[v], atol=1e-5, rtol=0)
    return td


@pytest.mark.parametrize("name", HEADS)
def test_head_training_matches_jax(name):
    feats, proposals, valid, sizes, gt = fpn_inputs()
    jheads, _, make = _heads(_opts(name), STRIDES, C)
    var, theads = make((feats, proposals, valid, sizes, {k: jnp.asarray(v) for k, v in gt.items()}))
    losses = check_training(jheads, var, theads, feats, proposals, valid, sizes, gt,
                            80 if name == "ParallelStandardROIHeads" else 6)
    if name == "ParallelStandardROIHeads":
        assert set(losses) == {f"{p}_{k}" for p in ("base", "novel") for k in ("loss_cls", "loss_box_reg")}
        assert min(losses.values()) > 0
    if name == "StandardROIHeadsCascadeBBox":
        assert losses["loss_box_reg_branch"] > 0


@pytest.mark.parametrize("name", HEADS + ("StandardROIHeads",))
def test_head_detections_match_jax(name):
    """``StandardROIHeads`` runs with ``DEBUG``: ``DetectionsDebug``.
    Parallel's merged detections have twice ``DETECTIONS_PER_IMAGE`` slots,
    classes in the 80-way space; CascadeStandard's second pass runs on the
    first pass's candidates."""
    feats, proposals, valid, sizes, gt = fpn_inputs()
    jheads, _, make = _heads(_opts(name, debug=name == "StandardROIHeads"), STRIDES, C)
    var, theads = make((feats, proposals, valid, sizes, {k: jnp.asarray(v) for k, v in gt.items()}))
    dets = check_detections(jheads, var, theads, feats, proposals, valid, sizes)
    assert isinstance(dets, DetectionsDebug) == (name == "StandardROIHeads")
    if name == "ParallelStandardROIHeads":
        assert tuple(dets.boxes.shape) == (B, 16, 4)
        cls = dets.classes.numpy()
        seen = set(get_cfg().DATASETS.SEEN_IDS)
        assert all(c in seen for c in cls[:, :8][dets.valid.numpy()[:, :8]])
        assert not any(c in seen for c in cls[:, 8:][dets.valid.numpy()[:, 8:]]) and cls.max() < 80


def test_cascade_standard_first_pass_keeps_every_candidate():
    """Pass 1 runs at NMS threshold 1.5: every candidate above the score
    threshold survives, up to ``refine_candidates`` slots, best first."""
    from lvc_tpu_torch.modeling.roi_heads.fast_rcnn import fast_rcnn_inference

    rng = np.random.RandomState(0)
    boxes = torch.from_numpy(rng.uniform(0, 50, (2, 30, 4)).astype(np.float32)).sort(-1).values
    boxes = torch.cat([boxes[..., :2], boxes[..., :2] + 20], -1).repeat(1, 1, 3)  # overlapping, 3 classes
    probs = torch.softmax(torch.from_numpy(rng.normal(0, 2, (2, 30, 4)).astype(np.float32)), -1)
    valid = torch.ones(2, 30, dtype=torch.bool)
    sizes = torch.tensor([[100, 100], [100, 100]])
    dets = fast_rcnn_inference(boxes, probs, sizes, valid, 0.05, 1.5, 512)
    want = (probs[..., :-1] > 0.05).sum((1, 2))
    assert dets.valid.sum(1).tolist() == want.tolist()
    assert dets.boxes.shape[1] == 90  # min(512, R * K) slots
    for b, n in enumerate(want.tolist()):
        assert bool(dets.valid[b, :n].all()) and bool((dets.scores[b, : n - 1] >= dets.scores[b, 1:n]).all())


def _model_cfg(name):
    cfg = get_cfg()
    cfg.merge_from_file("configs/Base-RCNN-FPN.yaml")
    cfg.MODEL.RESNETS.RES2_OUT_CHANNELS = 64
    cfg.MODEL.RESNETS.WIDTH_PER_GROUP = 16
    cfg.MODEL.FPN.OUT_CHANNELS = 64
    cfg.MODEL.ROI_BOX_HEAD.FC_DIM = 32
    cfg.MODEL.ROI_HEADS.NAME = name
    return cfg


def test_combine_parallel_checkpoint_loads_strictly(tmp_path):
    """``ckpt_surgery --method combine_parallel`` of a 60-class base and a
    20-class novel checkpoint (both written by the port) loads into the
    built ``ParallelStandardROIHeads`` with no missing or unexpected key; the
    twins hold the two sources' weights and the bridge carries them to JAX's
    ``roi_heads/{base,novel}_head`` tree and back. JAX's own ``torch_to_flax``
    keeps the doubled ``roi_heads/roi_heads`` prefix, which its tree does not
    have: a deliberate difference (the port loads the reference layout)."""
    paths = {}
    for tag, k in (("base", 60), ("novel", 20)):
        cfg = _model_cfg("StandardROIHeads")
        cfg.MODEL.ROI_HEADS.NUM_CLASSES = k
        model = damped_init(build_model(cfg, device="cpu"), seed=k)
        paths[tag] = str(tmp_path / f"{tag}.pth")
        torch.save({"model": model.state_dict(), "iteration": 0}, paths[tag])
    args = ckpt_surgery.parser.parse_args([
        "--method", "combine_parallel", "--coco", "--src1", paths["base"], "--src2", paths["novel"],
        "--save-dir", str(tmp_path), "--tar-name", "model_reset",
    ])
    ckpt_surgery.main(args)
    out = torch.load(tmp_path / "model_reset_combine_parallel.pth")["model"]

    cfg = _model_cfg("ParallelStandardROIHeads")
    cfg.MODEL.ROI_HEADS.NUM_CLASSES = 80
    model = build_model(cfg, device="cpu")
    assert isinstance(model.roi_heads, ParallelStandardROIHeads)
    missing, unexpected = model.load_state_dict(out, strict=True)
    assert not missing and not unexpected
    sources = {t: torch.load(p)["model"] for t, p in paths.items()}
    sd = model.state_dict()
    for tag in ("base", "novel"):
        for k, v in sources[tag].items():
            if k.startswith("roi_heads."):
                torch.testing.assert_close(sd[k.replace("roi_heads.", f"roi_heads.roi_heads.{tag}.", 1)], v,
                                           rtol=0, atol=0)
    assert sd["roi_heads.roi_heads.base.box_predictor.cls_score.weight"].shape[0] == 61
    assert sd["roi_heads.roi_heads.novel.box_predictor.bbox_pred.weight"].shape[0] == 80
    tree = to_flax(sd)
    assert set(tree["params"]["roi_heads"]) == {"base_head", "novel_head"}
    back = from_flax(tree)
    assert set(back) == set(sd) - {"pixel_mean", "pixel_std"}
    for k, v in back.items():
        torch.testing.assert_close(v, sd[k], rtol=0, atol=0)
    jax_tree = torch_to_flax({k: v.numpy() for k, v in out.items()})["params"]["roi_heads"]
    assert set(jax_tree) == {"roi_heads"} and set(jax_tree["roi_heads"]) == {"base", "novel"}


@pytest.mark.parametrize("name", HEADS)
def test_build_model_builds_the_heads(name):
    """``build_model`` builds each head on the RPN's and pool's FPN width,
    with the config's classes; CascadeBBox's branch and Parallel's twins
    are in the state dict under their reference names."""
    cfg = _model_cfg(name)
    cfg.MODEL.ROI_HEADS.NUM_CLASSES = 80
    sd = build_model(cfg, device="cpu").state_dict()
    assert sd["proposal_generator.rpn_head.conv.weight"].shape[1] == 64
    if name == "ParallelStandardROIHeads":
        assert sd["roi_heads.roi_heads.base.box_predictor.cls_score.weight"].shape == (61, 32)
        assert sd["roi_heads.roi_heads.novel.box_predictor.cls_score.weight"].shape == (21, 32)
        assert sd["roi_heads.roi_heads.base.box_head.fc1.weight"].shape == (32, 64 * 49)
    else:
        assert sd["roi_heads.box_predictor.cls_score.weight"].shape == (81, 32)
    assert ("roi_heads.bbox_branch.bbox_pred.weight" in sd) == (name == "StandardROIHeadsCascadeBBox")


def test_cli_setup_turns_tf32_off(tmp_path):
    """The verifier CLI's ``setup`` turns TF32 off (its float32 ViT); the
    training CLIs' ``setup`` (``train_net``'s, through ``default_setup``)
    leaves the process's setting, PyTorch's default of TF32 convolutions: on
    the card they trained float32 2.00-2.13x faster and kept 240-246 of a
    trained model's 241-246 result rows within 1 px (PERF.md, phases
    17-18)."""
    from lvc_tpu_torch.engine.defaults import default_argument_parser
    from lvc_tpu_torch.tools import run_nearest_neighbours, train_net

    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    args = default_argument_parser().parse_args(["MODEL.DEVICE", "cpu", "OUTPUT_DIR", str(tmp_path)])
    try:
        for flags in ((True, False), (False, False), (True, True)):
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
            train_net.setup(args)
            assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == flags
            run_nearest_neighbours.setup(args)
            assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == (False, False)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
