"""RetinaNet, the semantic-segmentation FPN and Panoptic FPN against the JAX
package on the CPU, on the same weights (``from_flax``).

The models are ``chip_smoke.dense_opts(kind, narrow=True)`` on
Base-RCNN-FPN.yaml: R-50 with res2 64 wide, FPN 64 wide, RetinaNet's towers
2 convs (256 wide, as in JAX) over 5 classes and 9 anchors a location (the
model zoo's three octaves), the semantic head 32 wide over 7 classes, and
for Panoptic FPN the box head 128 wide with the mask head 2 convs 32 wide
and exhaustive sampling; POOLER_IMPL exact in both packages. JAX's
he-init weights, the backbone scaled by 0.7, RetinaNet's towers by 0.5,
``cls_score`` by 0.2 with its bias at the prior's (the scores spread about
0.01 with std ~2 in logits, a few percent above the 0.05 threshold) and
``bbox_pred`` by 0.03; Panoptic FPN's RPN and box predictor as
tests/test_torch_rcnn.py scales them. A B=2 batch of 64x64 seeded images
(the second 56x56 inside the canvas) with 3 gt boxes each, 32 x 32 blocks of
seeded semantic classes (255 in the padding) and gt bitmasks at 1/4 of the
canvas (``chip_smoke.dense_batch``).

Tolerances: every loss rel 1e-5; every parameter's gradient rel L2 1e-4;
RetinaNet's detections boxes 1e-3 px and scores 1e-4, classes and validity
equal (the scores are spread, so no near-tie under 1e-5 decides a slot:
checked); the semantic logits abs 1e-5 of the largest; Panoptic FPN's
instances as RetinaNet's and its masks abs 5e-5 (as in
tests/test_torch_mask_keypoint.py). The focal loss on logits up to +-40:
rel 1e-6. The panoptic fusion: ids and segment infos equal to JAX's
function on the same inputs. The weights round-trip through ``to_flax``,
and a state dict in detectron2's names and shapes loads strictly. Two gloo
ranks of ``make_data_parallel_train_step`` equal one process for RetinaNet
and the semantic FPN: losses rel 2e-4 / abs 1e-5 (as in
tests/test_torch_ddp.py) and each gradient rel L2 1e-4 (the gradients'
tolerance against JAX), held against its own norm or 1e-6 of the largest
gradient's, whichever is larger. RetinaNet's gradients into the FPN are
sums whose terms cancel (down to 1e-12 of the largest at p6/p7): in runs
beside other CPU work their order of summation moved them by up to rel
3.2e-5, over tests/test_torch_ddp.py's 1e-5. ``global_ratio`` makes the
positive count and the pixel count global.

JAX's models are built and run once each for the module.
"""
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import chip_smoke
from lvc_tpu.config import get_cfg as jax_get_cfg
from lvc_tpu.modeling.backbone.fpn import fpn_strides as jax_fpn_strides
from lvc_tpu.modeling.meta_arch import panoptic_fpn as jpan
from lvc_tpu.modeling.meta_arch import retinanet as jretina
from lvc_tpu.modeling.meta_arch.build import build_model as jax_build_model
from lvc_tpu.utils.init import materialize_variables

from lvc_tpu_torch.checkpoint.convert import from_flax, to_flax
from lvc_tpu_torch.config import get_cfg
from lvc_tpu_torch.engine.launch import launch
from lvc_tpu_torch.modeling.backbone.fpn import fpn_strides
from lvc_tpu_torch.modeling.meta_arch import panoptic_fpn as pan
from lvc_tpu_torch.modeling.meta_arch import retinanet
from lvc_tpu_torch.modeling.meta_arch.build import build_model
from lvc_tpu_torch.modeling.roi_heads.mask_head import paste_masks_in_image

KINDS = ("retinanet", "semantic", "panoptic")
B, H, W, G = 2, 64, 64, 4
PRIOR_BIAS = -np.log(99.0)


def _cfg(get, kind, *extra):
    cfg = get()
    cfg.merge_from_file("configs/Base-RCNN-FPN.yaml")
    cfg.merge_from_list(chip_smoke.dense_opts(kind, narrow=True) + ["MODEL.ROI_HEADS.POOLER_IMPL", "exact", *extra])
    return cfg


def _batch():
    batch = chip_smoke.dense_batch(B, H, W, G, seed=3, device="cpu", num_classes=5, sem_classes=7, n_gt=(3, 3),
                                   size=(14, 40))
    return {k: v.numpy() for k, v in batch.items()}


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def _scale(kind, var):
    for block in var["params"]["backbone"]["bottom_up"].values():
        for path, leaf in _leaves(block):
            if path[-1] == "kernel":
                leaf *= 0.7
    if kind == "retinanet":
        head = var["params"]["head"]
        for name, mod in head.items():
            mod["conv"]["kernel"] *= {"cls_score": 0.2, "bbox_pred": 0.03}.get(name, 0.5)
        head["cls_score"]["conv"]["bias"][:] = PRIOR_BIAS
    if kind == "panoptic":
        rpn = var["params"]["proposal_generator"]["rpn_head"]
        rpn["conv"]["conv"]["kernel"] *= 0.1
        rpn["objectness_logits"]["conv"]["kernel"] *= 0.1
        rpn["anchor_deltas"]["conv"]["kernel"] *= 0.01
        box = var["params"]["roi_heads"]["box_predictor"]
        box["cls_score"]["kernel"] *= 0.03
        box["bbox_pred"]["kernel"] *= 0.3
        var["params"]["roi_heads"]["mask_head"]["predictor"]["kernel"] *= 0.01
    return var


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@functools.lru_cache(maxsize=None)
def _jax_run(kind):
    """(kind, JAX's variables, its losses, gradients and eval output), once
    a kind."""
    jmodel = jax_build_model(_cfg(jax_get_cfg, kind))
    jb = {k: jnp.asarray(v) for k, v in _batch().items()}
    if kind != "panoptic":
        jb.pop("gt_masks")
    eval_batch = {k: jb[k] for k in ("image", "image_size")}
    shapes = jax.eval_shape(functools.partial(jmodel.init, train=False), {"params": jax.random.PRNGKey(0)},
                            eval_batch)
    var = jax.tree_util.tree_map(lambda v: np.array(v, np.float32),
                                 materialize_variables(shapes, seed=0, conv_init="he"))
    var = _scale(kind, var)
    key = jax.random.PRNGKey(7)

    def loss_fn(params):
        losses = jmodel.apply({"params": params, "batch_stats": var["batch_stats"]}, jb, train=True,
                              rngs={"sampling": key, "dropout": key})
        return sum(losses.values()), losses

    (_, losses), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(var["params"])
    out = jax.jit(lambda v, b: jmodel.apply(v, b, train=False))(var, eval_batch)
    return kind, var, {k: float(v) for k, v in losses.items()}, jax.tree_util.tree_map(np.array, grads), out


def _port(kind, var):
    model = build_model(_cfg(get_cfg, kind), device="cpu")
    model.load_state_dict(from_flax(var))
    return model


def _check_detections(got, want, masks=False):
    """Padded detections slot by slot; no two valid scores within 1e-5 of
    each other (no near-tie decides a slot)."""
    want = [np.asarray(x) for x in want]
    v = want[3]
    np.testing.assert_array_equal(got.valid.numpy(), v)
    assert v.sum(axis=1).min() >= 5
    for b in range(v.shape[0]):
        s = np.sort(want[1][b][v[b]])
        assert np.diff(s).min() > 1e-5
    np.testing.assert_array_equal(got.classes.numpy()[v], want[2][v])
    np.testing.assert_allclose(got.boxes.numpy()[v], want[0][v], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got.scores.numpy()[v], want[1][v], rtol=0, atol=1e-4)


@pytest.mark.parametrize("kind", KINDS)
def test_losses_and_gradients_match_jax(kind):
    kind, var, want, j_grads, _ = _jax_run(kind)
    model = _port(kind, var).train()
    batch = _batch()
    if kind != "panoptic":
        batch.pop("gt_masks")
    losses = model(batch, torch.Generator().manual_seed(0))
    expect = {"retinanet": {"loss_cls", "loss_box_reg"}, "semantic": {"loss_sem_seg"},
              "panoptic": {"loss_sem_seg", "loss_cls", "loss_box_reg", "loss_mask", "loss_rpn_cls", "loss_rpn_loc"}}
    assert set(losses) == set(want) == expect[kind]
    for k, v in want.items():
        assert float(losses[k].detach()) == pytest.approx(v, rel=1e-5, abs=1e-7), k
        assert v > 0
    sum(losses.values()).backward()
    j_grad = from_flax({"params": j_grads})
    for name, p in model.named_parameters():
        if not p.requires_grad:
            continue
        assert p.grad is not None, name
        assert _rel_l2(p.grad.numpy(), j_grad[name].numpy()) <= 1e-4, name


@pytest.mark.parametrize("kind", KINDS)
def test_eval_matches_jax(kind):
    kind, var, _, _, out = _jax_run(kind)
    batch = {k: v for k, v in _batch().items() if k in ("image", "image_size")}
    got = _port(kind, var)(batch)
    if kind == "retinanet":
        _check_detections(got, out)
        # the merged candidate slot, as JAX's: the same level and rank
        np.testing.assert_array_equal(got.proposal_idx.numpy()[got.valid.numpy()],
                                      np.asarray(out.proposal_idx)[np.asarray(out.valid)])
        return
    logits = out if kind == "semantic" else out["sem_seg"]
    sem = got if kind == "semantic" else got["sem_seg"]
    want = np.asarray(logits)
    assert sem.shape == (B, 7, H, W) and sem.dtype == torch.float32
    np.testing.assert_allclose(sem.permute(0, 2, 3, 1).numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())
    if kind == "panoptic":
        inst, want_inst = got["instances"], out["instances"]
        _check_detections(inst, want_inst)
        v = np.asarray(want_inst.valid)
        np.testing.assert_allclose(inst.masks.numpy()[v], np.asarray(want_inst.masks)[v], rtol=0, atol=5e-5)


def test_panoptic_combine_matches_jax():
    """The fusion on the port's eval output of each image and on a seeded
    case with overlapping instances, crowded stuff and a low-confidence
    instance: JAX's function gives the same ids and segments."""
    kind, var, _, _, _ = _jax_run("panoptic")
    out = _port(kind, var)({k: v for k, v in _batch().items() if k in ("image", "image_size")})
    inst = out["instances"]
    cases = []
    for i in range(B):
        masks = paste_masks_in_image(inst.masks[i], inst.boxes[i], (H, W), 0.5).numpy()
        logits = out["sem_seg"][i].permute(1, 2, 0).numpy()
        cases.append(((inst.boxes[i].numpy(), inst.scores[i].numpy(), inst.classes[i].numpy(),
                       inst.valid[i].numpy(), masks, logits), dict(instances_confidence_threshold=0.05,
                                                                  stuff_area_limit=64)))
    rng = np.random.RandomState(0)
    yy, xx = np.mgrid[0:40, 0:48]
    masks = np.stack([(yy - cy) ** 2 + (xx - cx) ** 2 < r ** 2 for cy, cx, r in
                      ((10, 10, 8), (14, 14, 8), (30, 30, 6), (12, 12, 3), (30, 40, 5))])
    scores = np.array([0.9, 0.8, 0.7, 0.6, 0.3], np.float32)
    cases.append(((np.zeros((5, 4), np.float32), scores, np.array([1, 2, 1, 3, 0]), np.array([1, 1, 1, 1, 0], bool),
                   masks, rng.normal(0, 1, (40, 48, 4)).astype(np.float32)), dict(stuff_area_limit=100)))
    things = 0
    for args, kwargs in cases:
        got = pan.combine_semantic_and_instance_outputs(*args, **kwargs)
        want = jpan.combine_semantic_and_instance_outputs(*args, **kwargs)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
        things += sum(s["isthing"] for s in got[1])
    assert things >= 4 and any(not s["isthing"] for s in got[1])


@pytest.mark.parametrize("kind", KINDS)
def test_weights_round_trip_and_detectron2_layout(kind):
    """``to_flax`` gives JAX's tree back; the dense heads' keys are
    detectron2's, so its state dict loads strictly."""
    kind, var, _, _, _ = _jax_run(kind)
    model = _port(kind, var)
    back = dict(_leaves(to_flax(model.state_dict())["params"]))
    assert set(back) == set(dict(_leaves(var["params"])))
    for path, want in _leaves(var["params"]):
        np.testing.assert_array_equal(back[path], want)
    d2 = {}
    if kind == "retinanet":
        for branch in ("cls_subnet", "bbox_subnet"):
            for i in range(2):
                d2[f"head.{branch}.{2 * i}.weight"] = (256, 64 if i == 0 else 256, 3, 3)
                d2[f"head.{branch}.{2 * i}.bias"] = (256,)
        d2.update({"head.cls_score.weight": (45, 256, 3, 3), "head.cls_score.bias": (45,),
                   "head.bbox_pred.weight": (36, 256, 3, 3), "head.bbox_pred.bias": (36,),
                   "backbone.top_block.p6.weight": (64, 512, 3, 3), "backbone.top_block.p6.bias": (64,),
                   "backbone.top_block.p7.weight": (64, 64, 3, 3), "backbone.top_block.p7.bias": (64,)})
    else:
        for f, n in (("p2", 1), ("p3", 1), ("p4", 2), ("p5", 3)):
            for k in range(n):
                d2[f"sem_seg_head.{f}.{2 * k}.weight"] = (32, 64 if k == 0 else 32, 3, 3)
                d2[f"sem_seg_head.{f}.{2 * k}.norm.weight"] = d2[f"sem_seg_head.{f}.{2 * k}.norm.bias"] = (32,)
        d2.update({"sem_seg_head.predictor.weight": (7, 32, 1, 1), "sem_seg_head.predictor.bias": (7,)})
    prefixes = ("head.", "backbone.top_block.", "sem_seg_head.")
    state = {k: v for k, v in model.state_dict().items() if not k.startswith(prefixes)}
    state.update({k: torch.zeros(s) for k, s in d2.items()})
    model.load_state_dict(state, strict=True)


def test_sigmoid_focal_loss_matches_jax():
    rng = np.random.RandomState(0)
    logits = np.concatenate([rng.uniform(-40, 40, 500), rng.normal(0, 3, 500), [-40.0, 40.0, 0.0]]).astype(np.float32)
    targets = (rng.rand(logits.size) < 0.3).astype(np.float32)
    for alpha, gamma in ((0.25, 2.0), (-1.0, 2.0), (0.5, 0.0), (0.25, 1.5)):
        want = np.asarray(jax.jit(jretina.sigmoid_focal_loss, static_argnums=(2, 3))(
            jnp.asarray(logits), jnp.asarray(targets), alpha, gamma), np.float64)
        got = retinanet.sigmoid_focal_loss(torch.from_numpy(logits), torch.from_numpy(targets), alpha, gamma).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-30)


def test_anchor_rule_and_strides_match_jax():
    """JAX's ``SIZES`` rule: Base-RCNN-FPN's five one-size entries give 3
    anchors a location, the RetinaNet yaml's and a single entry 9; and the
    FPN strides of each top block. ``p6p7`` from p5 (not reachable from the
    config, as in JAX) takes the top FPN output."""
    for opts, want in (((), 3), (("MODEL.ANCHOR_GENERATOR.SIZES", chip_smoke.RETINANET_SIZES), 9),
                       (("MODEL.ANCHOR_GENERATOR.SIZES", [[32]]), 9)):
        cfg = get_cfg()
        cfg.merge_from_file("configs/Base-RCNN-FPN.yaml")
        cfg.merge_from_list(["MODEL.META_ARCHITECTURE", "RetinaNet", "MODEL.RESNETS.RES2_OUT_CHANNELS", 64,
                             "MODEL.RESNETS.WIDTH_PER_GROUP", 16, *opts])
        model = build_model(cfg, device="cpu")
        assert model.anchor_generator.num_anchors == [want] * 5
        assert model.backbone.in_features == ("res2", "res3", "res4", "res5")  # the yaml's FPN.IN_FEATURES
    for top in ("maxpool", "p6p7", ""):
        for feats in (("res2", "res3", "res4", "res5"), ("res3", "res4", "res5")):
            assert fpn_strides(feats, top) == jax_fpn_strides(feats, top)
    model = build_model(_cfg(get_cfg, "retinanet"), device="cpu")
    fpn = model.backbone
    fpn.p6p7_from_res5 = False
    fpn.top_block.p6 = torch.nn.Conv2d(64, 64, 3, stride=2, padding=1)
    x = torch.from_numpy(_batch()["image"]).permute(0, 3, 1, 2)
    with torch.no_grad():
        out = fpn(x)
        np.testing.assert_array_equal(out["p6"].numpy(), fpn.top_block.p6(out["p5"]).numpy())
        np.testing.assert_array_equal(out["p7"].numpy(), fpn.top_block.p7(torch.relu(out["p6"])).numpy())


def _dp_jobs():
    jobs = []
    for kind in ("retinanet", "semantic"):
        cfg = _cfg(get_cfg, kind, "MODEL.DEVICE", "cpu")
        model = build_model(cfg, device="cpu")
        chip_smoke.calibrated_init(model, seed=0)
        if kind == "retinanet":
            with torch.no_grad():
                model.head.cls_score.bias.fill_(PRIOR_BIAS)
        batch = chip_smoke.dense_batch(4, H, W, G, seed=5, device="cpu", num_classes=5, sem_classes=7, n_gt=(1, 3),
                                       size=(14, 40))
        jobs.append((kind, cfg, model.state_dict(), batch, chip_smoke.DP_SEED))
    return jobs


def test_two_ranks_equal_one_process(tmp_path):
    jobs = _dp_jobs()
    refs = {kind: chip_smoke.dp_step(cfg, w, batch, seed, data_parallel=False) for kind, cfg, w, batch, seed in jobs}
    launch(chip_smoke.dp_rank_main, 2, args=(str(tmp_path), jobs), devices=["cpu", "cpu"])
    for kind, _, _, _, _ in jobs:
        ref, ranks = refs[kind], chip_smoke.dp_load(str(tmp_path), kind, 2)
        assert [r["batch"] for r in ranks] == [2, 2]
        for r in ranks:
            assert set(r["metrics"]) == set(ref["metrics"])
            for k, want in ref["metrics"].items():
                assert abs(r["metrics"][k] - want) <= 1e-5 + 2e-4 * abs(want), (kind, k)
        # RetinaNet's gradients into the FPN are sums whose terms cancel (the top levels' down to 1e-12 of the
        # largest gradient): each is held against its own norm or 1e-6 of the largest, at the port's gradient
        # tolerance against JAX
        top = max(float(g.norm()) for g in ref["grads"].values())
        for name, want in ref["grads"].items():
            got = ranks[0]["grads"][name]
            assert float((got - want).norm()) <= 1e-4 * max(float(want.norm()), 1e-6 * top), (kind, name)
            assert torch.equal(ranks[1]["grads"][name], got), (kind, name)  # both ranks hold the all-reduced one
    # the positive count differs between the ranks' halves: a per-rank normaliser would not give these losses
    assert refs["retinanet"]["metrics"]["loss_cls"] > 0
    chip_smoke.dp_toy_check(str(tmp_path), 2)


@pytest.mark.parametrize("kind", KINDS)
def test_build_model_defaults_to_cuda(kind):
    cfg = _cfg(get_cfg, kind)
    if torch.cuda.is_available():
        assert next(build_model(cfg).parameters()).is_cuda
    else:
        with pytest.raises(RuntimeError, match="no GPU was found"):
            build_model(cfg)
