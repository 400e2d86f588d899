"""BatchNorm, SyncBN and PreciseBN: the port against the JAX package on the CPU.

The JAX package computes all three as plain XLA (``lvc_tpu/modeling/layers.py:91-124``
``SyncBatchNorm``, ``engine/hooks.py:137-202`` ``update_bn_stats`` and
``PreciseBN``); the port holds that arithmetic. Every ``running_mean`` and
``running_var`` here has seeded values (``chip_smoke.syncbn_stats``: var in
(0.5, 2), mean N(0, 0.1)), never the init's 0 and 1, so that a swapped or
unused statistic shows.

- The module's running form (every detector call site's) on float32 and bf16
  inputs, with the affine float32 and rounded to bf16 (the AMP step's): the
  output dtype equal to JAX's (float32: flax promotes a bf16 input) and the
  values within 3 float32 ulps of ``|x * scale| + |mean * scale|`` (XLA's
  rsqrt is its own approximation, a float32 ulp from torch's on a third of
  the variances: the scale moves by 1-2 ulps; measured up to 3 ulps of those
  terms). Its ``train=True`` form: the output and the EMA'd statistics rel
  1e-6 of the largest (the batch sums run in another order); over 2 gloo
  ranks with the process group, the halves of a batch give the one-process
  output and statistics (rel 1e-6), and a PreciseBN refresh of the narrow SyncBN detector on different
  batches leaves both ranks' buffers equal.
- ``get_norm`` builds the module for ``BN``, ``SyncBN`` and ``naiveSyncBN``.
- A narrow SyncBN Mask R-CNN (``chip_smoke.syncbn_opts(narrow=True)``: res2
  64, FPN 64, 5 classes, the SyncBN box head 2 convs 32 wide and an fc of 64,
  B=2 on 128x192, exhaustive sampling, POOLER_IMPL exact) on JAX's He
  weights scaled as tests/test_torch_mask_keypoint.py scales them: one
  ``make_train_step`` step in float32 (losses rel 1e-5, every trainable
  gradient rel L2 1e-4, the BN affines' included), one AMP step
  (tests/test_torch_train.py's AMP rule for the losses, rel 5e-2 / abs
  5e-3, and PR 15's bf16 rule for the gradients: their cosine distance from
  JAX's AMP at most 3 times JAX's own AMP distance from its float32), the
  eval forward (boxes 1e-3 px, scores
  1e-4, masks 5e-5) and bf16 serving's FPN levels (PR 15's bf16 rule:
  float32 in both packages, as JAX's BN promotes, each level within 3 times
  JAX's own bf16 distance from its float32);
  the running statistics bit-unchanged by both packages' steps.
- The weight-decay groups and trainability equal JAX's with FREEZE_AT 2 and
  three decays (tests/test_torch_swin.py's ``check_wd_groups``); the
  converter round-trips a model holding FrozenBN, GN and SyncBN norms bit
  for bit both ways; a detectron2-layout ``.pth`` of a SyncBN model loads as
  JAX's checkpointer loads it (its norms' entries unexpected, the SyncBN
  norms kept), both converters' validations refuse it without
  ``--allow-partial``, and JAX's converted ``.ckpt`` (FrozenBN-named norms)
  fills no SyncBN norm in either package.
- ``update_bn_stats`` against JAX's on tests/test_d2_surface.py's toy module
  (``train=True``; statistics bit-equal on batches on a 1/64 grid, where
  every order of the batch sums gives the same float32, and rel 1e-6 of the
  mean square on its own draws, whose sums XLA adds in another order) and on the narrow
  FrozenBN and SyncBN detectors: statistics bit-equal, and equal to a
  float32 replay of the EMA inversion. A trainer run with ``TEST.PRECISE_BN.ENABLED`` (the step and the
  refresh stubbed to record): hook order, firing iterations, the batches the
  refreshes draw and the batch each step takes after them equal JAX's.
"""
import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import flax.linen as fnn
import optax

import chip_smoke
from lvc_tpu.checkpoint.checkpointer import DetectionCheckpointer as JaxCheckpointer
from lvc_tpu.config import get_cfg as jax_get_cfg
from lvc_tpu.engine import hooks as jhooks
from lvc_tpu.engine.defaults import DefaultTrainer as JaxTrainer
from lvc_tpu.engine.train_loop import TrainState
from lvc_tpu.engine.train_loop import make_train_step as jax_make_train_step
from lvc_tpu.modeling import layers as jlayers
from lvc_tpu.modeling.meta_arch.build import build_model as jax_build_model
from lvc_tpu.solver.build import build_optimizer as jax_build_optimizer
from lvc_tpu.utils.init import materialize_variables

from lvc_tpu_torch.checkpoint.checkpointer import DetectionCheckpointer
from lvc_tpu_torch.checkpoint.convert import from_flax, to_flax
from lvc_tpu_torch.config import get_cfg
from lvc_tpu_torch.engine import hooks
from lvc_tpu_torch.engine.defaults import DefaultTrainer
from lvc_tpu_torch.engine.launch import launch
from lvc_tpu_torch.engine.train_loop import make_train_step
from lvc_tpu_torch.modeling.layers import FrozenBatchNorm, SyncBatchNorm, compute_dtype_scope, get_norm
from lvc_tpu_torch.modeling.meta_arch.build import build_model
from lvc_tpu_torch.solver.build import build_lr_schedule, build_optimizer
from test_torch_swin import check_wd_groups, leaves, rel_l2
from test_torch_trainer import _narrow as trainer_narrow
from test_torch_trainer import tree  # noqa: F401  (the module's seeded COCO tree)
from torch_bn_ranks import group_rank, narrow_syncbn_model

B, H, W, G, C = 2, 128, 192, 4, 24


# ------------------------------------------------------------------ the module
def _module_inputs(seed=0, n=3, h=5, w=7):
    rng = np.random.RandomState(seed)
    x = (rng.normal(0.5, 2.0, (n, C, h, w))).astype(np.float32)
    return x, chip_smoke.syncbn_stats(rng, C)


def _jax_vars(stats, bf16_affine=False):
    cast = (lambda v: jnp.asarray(v, jnp.bfloat16)) if bf16_affine else jnp.asarray
    return {"params": {"weight": cast(stats["weight"]), "bias": cast(stats["bias"])},
            "batch_stats": {k: jnp.asarray(stats[k]) for k in ("running_mean", "running_var")}}


def _port_bn(stats):
    bn = SyncBatchNorm(C)
    bn.load_state_dict({k: torch.from_numpy(v) for k, v in stats.items()})
    return bn


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("amp", [False, True])
def test_running_form_matches_jax(dtype, amp):
    x, stats = _module_inputs()
    xj = jnp.asarray(x.transpose(0, 2, 3, 1)).astype(dtype)
    want = jax.jit(jlayers.SyncBatchNorm(C).apply)(_jax_vars(stats, amp), xj)
    assert want.dtype == jnp.float32
    with torch.no_grad(), compute_dtype_scope(None, bf16_params=amp):
        got = _port_bn(stats)(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert got.dtype == torch.float32
    w = np.asarray(want).transpose(0, 3, 1, 2)
    xv = np.asarray(xj.astype(jnp.float32)).transpose(0, 3, 1, 2)
    weight = stats["weight"].astype(np.float64)
    if amp:
        weight = np.asarray(jnp.asarray(stats["weight"], jnp.bfloat16).astype(jnp.float32), np.float64)
    scale = (weight / np.sqrt(stats["running_var"].astype(np.float64) + 1e-5)).reshape(1, C, 1, 1)
    terms = (np.abs(xv * scale) + np.abs(stats["running_mean"].reshape(1, C, 1, 1) * scale)).astype(np.float32)
    assert np.all(np.abs(got.numpy() - w) <= 3 * np.spacing(terms)), np.abs(got.numpy() - w).max()


def test_train_form_matches_jax():
    x, stats = _module_inputs(seed=1, n=4)
    want, mutated = _jax_train_form(stats, x)
    bn = _port_bn(stats)
    got = bn(torch.from_numpy(x), train=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want).transpose(0, 3, 1, 2), rtol=1e-6, atol=1e-6)
    for k in ("running_mean", "running_var"):
        want_k = np.asarray(mutated["batch_stats"][k])
        # the batch sums run in another order: rel 1e-6 of the largest
        np.testing.assert_allclose(getattr(bn, k).numpy(), want_k, rtol=0, atol=1e-6 * np.abs(want_k).max())
        assert not np.allclose(getattr(bn, k).numpy(), stats[k])


def _jax_train_form(stats, x):
    """JAX's train-form output and updated statistics on NCHW ``x``."""
    return jax.jit(functools.partial(jlayers.SyncBatchNorm(C).apply, train=True, mutable=["batch_stats"]))(
        _jax_vars(stats), jnp.asarray(x.transpose(0, 2, 3, 1)))


def test_group_moments_and_refresh_over_two_ranks(tmp_path, jax_detector):
    x, stats = _module_inputs(seed=2, n=4)
    batches = [_batch(seed) for seed in (5, 6)]
    launch(group_rank, 2, args=(str(tmp_path), x, stats, batches, from_flax(jax_detector["var"])),
           devices=["cpu", "cpu"])
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(2)]
    one = _port_bn(stats)
    want = one(torch.from_numpy(x), train=True).detach()
    for r, res in enumerate(ranks):
        np.testing.assert_allclose(res["y"].numpy(), want[2 * r:2 * r + 2].numpy(), rtol=1e-6, atol=1e-6)
        for k, v in res["stats"].items():
            want_k = getattr(one, k).numpy()
            np.testing.assert_allclose(v.numpy(), want_k, rtol=0, atol=1e-6 * np.abs(want_k).max())
    assert ranks[0]["n"] == ranks[1]["n"] == 1
    assert ranks[0]["buffers"].keys() == ranks[1]["buffers"].keys() and len(ranks[0]["buffers"]) > 50
    for k, v in ranks[0]["buffers"].items():
        assert torch.equal(v, ranks[1]["buffers"][k]), k


@pytest.mark.parametrize("name", ["BN", "SyncBN", "naiveSyncBN"])
def test_get_norm_builds_sync_batch_norm(name):
    norm = get_norm(name, 32)
    assert type(norm) is SyncBatchNorm and norm.process_group is None and norm.momentum == 0.9
    assert [n for n, _ in norm.named_parameters()] == ["weight", "bias"]
    assert [n for n, _ in norm.named_buffers()] == ["running_mean", "running_var"]
    assert type(jlayers.get_norm(name, 32)) is jlayers.SyncBatchNorm


# -------------------------------------------------------------- the detector
def _cfg(get, **over):
    cfg = get()
    cfg.merge_from_file("configs/Base-RCNN-FPN.yaml")
    cfg.merge_from_list(chip_smoke.syncbn_opts(narrow=True) + ["MODEL.ROI_HEADS.POOLER_IMPL", "exact"])
    for k, v in over.items():
        cfg.merge_from_list([k, v])
    return cfg


def _batch(seed=3):
    batch = chip_smoke.train_batch(B, H, W, G, seed=seed, device="cpu", num_classes=5, n_gt=(3, 3), size=(24, 100))
    batch["gt_masks"] = chip_smoke.box_masks(batch["gt_boxes"], batch["gt_valid"], H, W)
    return {k: v.numpy() for k, v in batch.items()}


def _seed_variables(var, seed=0):
    """JAX's He weights, scaled as tests/test_torch_mask_keypoint.py scales
    them, with every norm's statistics seeded: a SyncBatchNorm's and its
    affine from ``chip_smoke.syncbn_stats``, a FrozenBN's var in (0.5, 2)
    and mean N(0, 0.1)."""
    for block in var["params"]["backbone"]["bottom_up"].values():
        for path, leaf in leaves(block):
            if path[-1] == "kernel":
                leaf *= 0.7
    rpn = var["params"]["proposal_generator"]["rpn_head"]
    rpn["conv"]["conv"]["kernel"] *= 0.1
    rpn["objectness_logits"]["conv"]["kernel"] *= 0.1
    rpn["anchor_deltas"]["conv"]["kernel"] *= 0.01
    head = var["params"]["roi_heads"]["box_predictor"]
    head["cls_score"]["kernel"] *= 0.03
    head["bbox_pred"]["kernel"] *= 0.3
    var["params"]["roi_heads"]["mask_head"]["predictor"]["kernel"] *= 0.01
    rng = np.random.RandomState(seed)
    n = 0
    for path, stat in leaves(var["batch_stats"]):
        if path[-2] == "FrozenBatchNorm_0":
            stat[...] = rng.uniform(0.5, 2.0, stat.shape) if path[-1] == "running_var" else rng.normal(0, 0.1, stat.shape)
            n += path[-1] == "running_var"
        elif path[-2:] == ("SyncBatchNorm_0", "running_mean"):
            vals = chip_smoke.syncbn_stats(rng, stat.shape[0])
            node, pnode = var["batch_stats"], var["params"]
            for p in path[:-1]:
                node, pnode = node[p], pnode[p]
            for k, v in vals.items():
                (node if k.startswith("running_") else pnode)[k] = v
            n += 1
    assert n > 50
    return var


def _detector(var, **over):
    if not over:
        return narrow_syncbn_model(from_flax(var))
    model = build_model(_cfg(get_cfg, **over), device="cpu")
    model.load_state_dict(from_flax(var))
    return model


def _keep_grads(tx):
    def init(params):
        return tx.init(params), jax.tree_util.tree_map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        updates, inner = tx.update(grads, state[0], params)
        return updates, (inner, grads)

    return optax.GradientTransformation(init, update)


@pytest.fixture(scope="module")
def jax_detector():
    """JAX's seeded variables; one float32 and one AMP ``make_train_step``
    step (metrics, gradients, statistics after); eval detections; the FPN
    levels of float32 and bf16 serving."""
    cfg = _cfg(jax_get_cfg)
    model = jax_build_model(cfg)
    jb = {k: jnp.asarray(v) for k, v in _batch().items()}
    image = {k: jb[k] for k in ("image", "image_size")}
    shapes = jax.eval_shape(functools.partial(model.init, train=False), {"params": jax.random.PRNGKey(0)}, image)
    var = _seed_variables(jax.tree_util.tree_map(lambda v: np.array(v, np.float32),
                                                 materialize_variables(shapes, seed=0, conv_init="he")))
    out = {"var": var}
    for amp in (False, True):
        tx = _keep_grads(jax_build_optimizer(cfg, var["params"]))
        state = TrainState.create(jax.tree_util.tree_map(jnp.asarray, var), tx)
        state, m = jax.jit(jax_make_train_step(model, tx, mixed_precision=amp))(state, jb, jax.random.PRNGKey(7))
        out["amp" if amp else "f32"] = ({k: float(v) for k, v in m.items()},
                                        jax.tree_util.tree_map(np.asarray, state.opt_state[1]),
                                        jax.tree_util.tree_map(np.asarray, state.batch_stats))
    out["dets"] = jax.jit(lambda v, b: model.apply(v, b, train=False))(var, image)
    from lvc_tpu.modeling.meta_arch.rcnn import model_images

    def features(v, b):
        return model.apply(v, b, method=lambda m, b: m.backbone(model_images(m, b)))

    out["p_f32"] = jax.tree_util.tree_map(np.asarray, jax.jit(features)(var, image))
    jlayers.set_compute_dtype(jnp.bfloat16)
    try:  # a new function: the compute dtype is read when it is traced
        bf16 = jax.jit(lambda v, b: features(v, b))(var, image)
    finally:
        jlayers.set_compute_dtype(jnp.float32)
    out["p_bf16_dtype"] = {k: v.dtype for k, v in bf16.items()}
    out["p_bf16"] = jax.tree_util.tree_map(np.asarray, bf16)
    return out


def _port_step(var, amp):
    model = _detector(var).train()
    opt = build_optimizer(_cfg(get_cfg), model)
    metrics = make_train_step(model, opt, build_lr_schedule(_cfg(get_cfg), opt), mixed_precision=amp)(
        _batch(), torch.Generator().manual_seed(0))
    grads = {n: p.grad for n, p in model.named_parameters() if p.requires_grad}
    return model, {k: float(v) for k, v in metrics.items()}, grads


def _assert_stats_unchanged(model, var, j_stats):
    want = from_flax({"batch_stats": var["batch_stats"]})
    got = {k: v for k, v in model.state_dict().items() if "running_" in k}
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    for path, v in leaves(var["batch_stats"]):
        np.testing.assert_array_equal(dict(leaves(j_stats))[path], v)


def test_train_step_matches_jax(jax_detector):
    var = jax_detector["var"]
    j_metrics, j_grads, j_stats = jax_detector["f32"]
    model, metrics, grads = _port_step(var, amp=False)
    assert set(metrics) == set(j_metrics) and "loss_mask" in metrics
    for k, want in j_metrics.items():
        assert metrics[k] == pytest.approx(want, rel=1e-5, abs=1e-7), k
    j_grad = from_flax({"params": j_grads})
    bn = [n for n in grads if ".norm." in n]
    assert len(bn) > 60 and any(n.startswith("roi_heads.box_head.") for n in bn)
    for name, g in grads.items():
        assert rel_l2(g.numpy(), j_grad[name].numpy()) <= 1e-4, name
    _assert_stats_unchanged(model, var, j_stats)


def test_amp_step_matches_jax(jax_detector):
    """tests/test_torch_train.py's AMP rule for the losses (rel 5e-2 / abs
    5e-3, as tests/test_mixed_precision.py holds JAX's AMP against its
    float32) and PR 15's bf16 rule for the gradients: the cosine distance of
    all of them from JAX's AMP at most 3 times JAX's own AMP distance from
    its float32 (this model's bf16 gradients are far from float32 in both
    packages: JAX's own cosine is about 0.91)."""
    var = jax_detector["var"]
    j_metrics, j_grads, j_stats = jax_detector["amp"]
    model, metrics, grads = _port_step(var, amp=True)
    assert set(metrics) == set(j_metrics)
    for k, want in j_metrics.items():
        assert metrics[k] == pytest.approx(want, rel=5e-2, abs=5e-3), (k, metrics[k], want)
    j_grad, j32_grad = from_flax({"params": j_grads}), from_flax({"params": jax_detector["f32"][1]})

    def flat(gs):
        return np.concatenate([gs[n].numpy().ravel() for n in grads]).astype(np.float64)

    def cos_distance(a, b):
        return 1.0 - a @ b / (np.linalg.norm(a) * np.linalg.norm(b))

    own = cos_distance(flat(j_grad), flat(j32_grad))
    assert cos_distance(flat(grads), flat(j_grad)) <= 3 * own, own
    _assert_stats_unchanged(model, var, j_stats)


def test_inference_matches_jax(jax_detector):
    dets = _detector(jax_detector["var"])({k: v for k, v in _batch().items() if k in ("image", "image_size")})
    want = jax_detector["dets"]
    v = np.asarray(want.valid)
    assert v.sum() >= 10
    np.testing.assert_array_equal(dets.valid.numpy(), v)
    np.testing.assert_array_equal(dets.classes.numpy()[v], np.asarray(want.classes)[v])
    np.testing.assert_allclose(dets.boxes.numpy()[v], np.asarray(want.boxes)[v], rtol=0, atol=1e-3)
    np.testing.assert_allclose(dets.scores.numpy()[v], np.asarray(want.scores)[v], rtol=0, atol=1e-4)
    np.testing.assert_allclose(dets.masks.numpy()[v], np.asarray(want.masks)[v], rtol=0, atol=5e-5)


def test_bf16_serving_levels_are_float32_as_in_jax(jax_detector):
    """JAX's SyncBN promotes: the FPN levels of a bf16 forward are float32,
    every conv still running in bf16."""
    assert all(d == jnp.float32 for d in jax_detector["p_bf16_dtype"].values())
    var = jax_detector["var"]
    batch = {k: v for k, v in _batch().items() if k in ("image", "image_size")}
    model = _detector(var, **{"MODEL.DTYPE": "bfloat16"})
    got = model.backbone_features(batch)
    assert set(got) == set(jax_detector["p_bf16"])
    for k, want in jax_detector["p_bf16"].items():
        assert got[k].dtype == torch.float32, k
        want = want.transpose(0, 3, 1, 2)
        own = np.abs(want - jax_detector["p_f32"][k].transpose(0, 3, 1, 2)).max()
        err = np.abs(got[k].numpy() - want).max()
        assert err <= 3 * own, (k, err, own)
    assert all(p.dtype == torch.float32 for p in model.parameters())


# ------------------------------------------------------- solver and converter
def test_weight_decay_groups_and_trainability_match_jax():
    groups = check_wd_groups(chip_smoke.syncbn_opts(narrow=True) + ["MODEL.BACKBONE.FREEZE_AT", 2])
    norm = {n for n, g in groups.items() if g == "norm"}
    assert norm == {n for n in groups if ".norm." in n} and len(norm) > 60


def test_converter_round_trips_syncbn_frozen_bn_and_gn():
    opts = {"MODEL.RESNETS.NORM": "FrozenBN", "MODEL.FPN.NORM": "GN", "MODEL.ROI_BOX_HEAD.CONV_DIM": 64}
    model = build_model(_cfg(get_cfg, **opts), device="cpu")
    kinds = {type(m) for m in model.modules()}
    assert {SyncBatchNorm, FrozenBatchNorm} <= kinds and any(type(m).__name__ == "GroupNorm" for m in model.modules())
    rng = np.random.RandomState(0)
    sd = {k: torch.from_numpy(rng.normal(0, 1, v.shape).astype(np.float32)) for k, v in model.state_dict().items()}
    model.load_state_dict(sd)
    flax = to_flax(model.state_dict(), model)
    names = {p[-2] for p, _ in leaves(flax["params"])} | {p[-2] for p, _ in leaves(flax["batch_stats"])}
    assert {"SyncBatchNorm_0", "FrozenBatchNorm_0", "GroupNorm_0"} <= names
    box = flax["batch_stats"]["roi_heads"]["box_head"]["conv1"]
    assert set(box) == {"SyncBatchNorm_0"} and set(box["SyncBatchNorm_0"]) == {"running_mean", "running_var"}
    back = from_flax(flax)
    assert back.keys() == sd.keys()
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
    again = to_flax(back, model)
    for col in ("params", "batch_stats"):
        for path, v in leaves(flax[col]):
            np.testing.assert_array_equal(dict(leaves(again[col]))[path], v)
    # JAX builds the same tree: every SyncBatchNorm_0 leaf where the port puts one
    jmodel = jax_build_model(_cfg(jax_get_cfg, **opts))
    image = {"image": jnp.zeros((1, 64, 64, 3)), "image_size": jnp.asarray([[64, 64]], np.int32)}
    shapes = jax.eval_shape(functools.partial(jmodel.init, train=False), {"params": jax.random.PRNGKey(0)}, image)
    for col in ("params", "batch_stats"):
        assert {p for p, _ in leaves(shapes[col])} == {p for p, _ in leaves(flax[col])}, col


def test_detectron2_file_loads_as_jax_loads_it(jax_detector, tmp_path, capsys):
    """JAX's ``torch_to_flax`` names every ``.norm`` FrozenBatchNorm_0: on a
    SyncBN model its checkpointer leaves the SyncBN norms as they were (each
    file entry unexpected, each norm entry missing) and its converter's
    validation refuses the file; the port's do the same."""
    var = jax_detector["var"]
    d2 = {k: v + 1.0 for k, v in from_flax(var).items()}
    sync = [k for k in d2 if ".norm." in k]
    assert len(sync) > 200
    path = str(tmp_path / "d2_syncbn.pth")
    torch.save({"model": d2}, path)
    port = _detector(var)
    DetectionCheckpointer(port).load(path)
    lines = capsys.readouterr().out.splitlines()
    got = port.state_dict()
    start = from_flax(var)
    for k, v in d2.items():
        assert torch.equal(got[k], start[k] if k in sync else v), k
    assert sorted(ln.split(": ")[1] for ln in lines if "missing key" in ln) == sorted(sync)
    assert sorted(ln.split(": ")[1].split()[0] for ln in lines if "unexpected key" in ln) == sorted(sync)

    state = TrainState.create(jax.tree_util.tree_map(jnp.asarray, var), optax.sgd(0.1))
    state = JaxCheckpointer(state).load(path, state)
    j_lines = capsys.readouterr().out.splitlines()
    assert sum("unexpected" in ln and "FrozenBatchNorm_0" in ln for ln in j_lines) == len(sync)
    assert sum("missing" in ln and "SyncBatchNorm_0" in ln for ln in j_lines) == len(sync)
    conv1 = ("roi_heads", "box_head", "conv1")
    j_params = dict(leaves(jax.tree_util.tree_map(np.asarray, state.params)))
    want = dict(leaves(var["params"]))
    np.testing.assert_array_equal(j_params[conv1 + ("SyncBatchNorm_0", "weight")],
                                  want[conv1 + ("SyncBatchNorm_0", "weight")])
    np.testing.assert_array_equal(j_params[conv1 + ("conv", "kernel")], want[conv1 + ("conv", "kernel")] + 1.0)

    from lvc_tpu_torch.tools import convert_reference_ckpt as port_tool
    import tools.convert_reference_ckpt as jax_tool

    opts = [str(o) for o in chip_smoke.syncbn_opts(narrow=True)]
    for tool, dst, word in ((port_tool, "x.pth", ".norm."), (jax_tool, "x.ckpt", "BatchNorm_0")):
        assert tool.main(["--src", path, "--dst", str(tmp_path / dst), "--config-file",
                          "configs/Base-RCNN-FPN.yaml", *opts]) == 1
        out = capsys.readouterr().out.splitlines()
        assert sum("missing in checkpoint" in ln and word in ln for ln in out) == len(sync), tool
        assert sum("unexpected in checkpoint" in ln and word in ln for ln in out) == len(sync), tool
        assert not os.path.exists(tmp_path / dst)
    # JAX's converted file names the norms FrozenBatchNorm_0: loaded into either package's SyncBN model, the
    # norms stay as they were
    ckpt = str(tmp_path / "x.ckpt")
    assert jax_tool.main(["--src", path, "--dst", ckpt, "--config-file", "configs/Base-RCNN-FPN.yaml", *opts,
                          "--allow-partial"]) == 0
    capsys.readouterr()
    port = _detector(var)
    DetectionCheckpointer(port).load(ckpt)
    lines = capsys.readouterr().out.splitlines()
    got = port.state_dict()
    for k, v in d2.items():
        assert torch.equal(got[k], start[k] if k in sync else v), k
    assert sorted(ln.split(": ")[1].split()[0] for ln in lines if "unexpected key" in ln) == sorted(sync)
    state = JaxCheckpointer(state).load(ckpt, TrainState.create(jax.tree_util.tree_map(jnp.asarray, var),
                                                                optax.sgd(0.1)))
    assert sum("unexpected" in ln and "FrozenBatchNorm_0" in ln for ln in capsys.readouterr().out.splitlines()) \
        == len(sync)


# ------------------------------------------------------------------ PreciseBN
def test_update_bn_stats_toy_matches_jax():
    """tests/test_d2_surface.py:299's module: a SyncBatchNorm of 2 features
    in its ``train=True`` form, four batches of 16."""

    class J(fnn.Module):
        @fnn.compact
        def __call__(self, batch, train=False):
            return jlayers.SyncBatchNorm(features=2, name="bn")(batch["x"], train=train)

    class T(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.bn = SyncBatchNorm(2)

        def forward(self, batch, generator=None):
            return self.bn(batch["x"][..., None, None], train=self.training)

    class FakeState:
        def __init__(self, params, batch_stats):
            self.params, self.batch_stats = params, batch_stats

        def replace(self, **kw):
            return FakeState(self.params, kw.get("batch_stats", self.batch_stats))

    rng = np.random.RandomState(0)
    stats = {"running_mean": np.array([0.3, -0.2], np.float32), "running_var": np.array([1.7, 0.6], np.float32)}
    state = FakeState({"bn": {"weight": jnp.ones(2), "bias": jnp.zeros(2)}}, {"bn": stats})
    # on a grid of 1/64 every order of the batch sums gives the same float32, so the refresh's own arithmetic
    # (the EMA, its inversion, the average) is held bit for bit; on the test's draws, the moments rel 1e-6
    for grid in (True, False):
        batches = [{"x": (np.round(rng.rand(16, 2) * 64) / 64 if grid else rng.rand(16, 2)).astype(np.float32) + i}
                   for i in range(4)]
        want = jhooks.update_bn_stats(J(), state, iter(batches)).batch_stats["bn"]
        model = T()
        model.bn.load_state_dict({"weight": torch.ones(2), "bias": torch.zeros(2),
                                  **{k: torch.from_numpy(v) for k, v in stats.items()}})
        assert hooks.update_bn_stats(model.eval(), iter(batches)) == 4
        assert not model.training
        for k, v in want.items():
            if grid:
                np.testing.assert_array_equal(getattr(model.bn, k).numpy(), np.asarray(v), err_msg=k)
            else:  # rel 1e-6 of the mean square, which var = E[x^2] - mean^2 cancels
                scale = max(float(np.square(b["x"]).mean(0).max()) for b in batches)
                np.testing.assert_allclose(getattr(model.bn, k).numpy(), np.asarray(v), rtol=0, atol=1e-6 * scale,
                                           err_msg=k)


class _JittedApply:
    """A flax model whose ``apply`` in ``update_bn_stats``'s form runs jitted
    (the refresh's EMA inversion stays JAX's eager arithmetic)."""

    def __init__(self, model):
        self._f = jax.jit(lambda v, b, r: model.apply(v, b, train=True, mutable=["batch_stats"],
                                                        rngs={"sampling": r, "dropout": r}))

    def apply(self, variables, batch, train, mutable, rngs):
        return self._f(variables, batch, rngs["sampling"])


@pytest.mark.parametrize("norm", ["FrozenBN", "SyncBN"])
def test_update_bn_stats_detectors_match_jax(norm, jax_detector):
    var = jax_detector["var"]
    over = {} if norm == "SyncBN" else {"MODEL.RESNETS.NORM": "FrozenBN", "MODEL.FPN.NORM": "",
                                        "MODEL.ROI_BOX_HEAD.NORM": ""}
    jmodel = jax_build_model(_cfg(jax_get_cfg, **over))
    if norm == "FrozenBN":
        image = {"image": jnp.zeros((1, H, W, 3)), "image_size": jnp.asarray([[H, W]], np.int32)}
        shapes = jax.eval_shape(functools.partial(jmodel.init, train=False), {"params": jax.random.PRNGKey(0)}, image)
        var = _seed_variables(jax.tree_util.tree_map(lambda v: np.array(v, np.float32),
                                                     materialize_variables(shapes, seed=0, conv_init="he")))
    batches = [_batch(seed) for seed in (3, 4)]
    state = TrainState.create(jax.tree_util.tree_map(jnp.asarray, var), optax.sgd(0.1))
    want = from_flax({"batch_stats": jax.tree_util.tree_map(
        np.asarray, jhooks.update_bn_stats(_JittedApply(jmodel), state, iter(batches)).batch_stats)})
    model = _detector(var, **over).eval()
    old = {k: v.clone() for k, v in model.state_dict().items() if "running_" in k}
    assert hooks.update_bn_stats(model, iter(batches)) == 2
    assert not model.training
    kinds = {type(m) for m in model.modules()}
    assert (SyncBatchNorm in kinds) == (norm == "SyncBN") and (FrozenBatchNorm in kinds) == (norm == "FrozenBN")
    got = model.state_dict()
    assert want.keys() == old.keys() and len(want) > 100
    replay = chip_smoke.replay_refresh(old, 2)
    moved = 0
    for k, v in want.items():
        assert torch.equal(got[k], v), k
        assert torch.equal(got[k], replay[k]), k
        moved += int((got[k] != old[k]).sum())
    assert moved > 0  # the inversion's float32 rounding moves some of them by an ulp or a few, as JAX's does


def test_no_norm_model_refresh_draws_nothing():
    model = torch.nn.Sequential(torch.nn.Linear(2, 2))
    drawn = []
    assert hooks.update_bn_stats(model, (drawn.append(i) for i in range(3))) == 0
    assert drawn == []


def _recorders(trainers, records):
    """Stubs each trainer's step (recording the batch it takes) and each
    package's refresh (recording the iteration and the batches it draws)."""
    def refresh(kind):
        def fn(model, *args):
            batches = list(args[-1])
            records[kind].append(("refresh", trainers[kind].iter, [b["image"].sum() for b in batches]))
            return args[0] if kind == "jax" else len(batches)
        return fn

    jt, pt = trainers["jax"], trainers["port"]

    def jax_step(state, batch, rng):
        records["jax"].append(("step", jt.iter, np.asarray(batch["image"]).sum()))
        return state, {"total_loss": jnp.zeros(())}

    def port_step(batch, seed):
        records["port"].append(("step", pt.iter, batch["image"].numpy().sum()))
        return {"total_loss": torch.zeros(())}

    jt.train_step, pt.train_step = jax_step, port_step
    return refresh("jax"), refresh("port")


def test_precise_bn_trainer_matches_jax(tree, tmp_path, monkeypatch):  # noqa: F811
    over = ["TEST.PRECISE_BN.ENABLED", True, "TEST.PRECISE_BN.NUM_ITER", 2, "TEST.EVAL_PERIOD", 2,
            "SOLVER.MAX_ITER", 4, "SOLVER.CHECKPOINT_PERIOD", 100]
    jcfg = trainer_narrow(jax_get_cfg(), str(tmp_path / "jax"))
    jcfg.merge_from_list(over)
    pcfg = trainer_narrow(get_cfg(), str(tmp_path / "port"))
    pcfg.merge_from_list(over + ["MODEL.DEVICE", "cpu"])

    class JT(JaxTrainer):
        def _materialize(self, shapes, seed):
            return jax.tree_util.tree_map(lambda v: np.zeros(v.shape, v.dtype), shapes)

    trainers = {"jax": JT(jcfg), "port": DefaultTrainer(pcfg)}
    names = {k: [type(h).__name__ for h in t._hooks] for k, t in trainers.items()}
    assert names["port"] == names["jax"] == ["IterationTimer", "LRSchedulerHook", "PreciseBN",
                                             "PeriodicCheckpointerHook", "EvalHookFsdet", "PeriodicWriter"]
    records = {"jax": [], "port": []}
    j_refresh, p_refresh = _recorders(trainers, records)
    monkeypatch.setattr(jhooks, "update_bn_stats", j_refresh)
    monkeypatch.setattr(hooks, "update_bn_stats", p_refresh)
    for t in trainers.values():
        t.train()
    kinds = [(r[0], r[1]) for r in records["port"]]
    assert kinds == [(r[0], r[1]) for r in records["jax"]] == [
        ("step", 0), ("step", 1), ("refresh", 1), ("step", 2), ("step", 3), ("refresh", 3)]
    for got, want in zip(records["port"], records["jax"]):
        np.testing.assert_allclose(got[2], want[2], rtol=1e-6)


def test_trained_syncbn_checkpoint_loads_whole(tree, tmp_path, monkeypatch):  # noqa: F811
    """``train_net`` trains the narrow SyncBN model (seeded statistics, a
    PreciseBN refresh after its last step) and writes its last checkpoint;
    ``train_net --eval-only MODEL.WEIGHTS <that .pth>`` loads every
    SyncBN weight, bias and statistic bit-equal to the trained model's, and
    so does the converter's output of that file (as JAX's trainer restores
    its own ``.ckpt`` whole). A detectron2 file is another matter
    (``test_detectron2_file_loads_as_jax_loads_it``)."""
    from lvc_tpu_torch.engine.defaults import default_argument_parser
    from lvc_tpu_torch.tools import convert_reference_ckpt as port_tool
    from lvc_tpu_torch.tools import train_net
    from lvc_tpu_torch.utils.init import damped_init

    cfg = trainer_narrow(get_cfg(), str(tmp_path / "out"))
    cfg.merge_from_list(chip_smoke.syncbn_opts(narrow=True) + [
        "MODEL.ROI_HEADS.POOLER_IMPL", "exact", "MODEL.DEVICE", "cpu", "SOLVER.MAX_ITER", 2,
        "SOLVER.CHECKPOINT_PERIOD", 100, "TEST.EVAL_PERIOD", 2, "TEST.PRECISE_BN.NUM_ITER", 1])
    config = str(tmp_path / "syncbn.yaml")
    with open(config, "w") as f:
        f.write(cfg.dump())
    made = {}

    class Seeded(train_net.Trainer):
        def _materialize(self, model, seed):
            chip_smoke.seed_syncbn(damped_init(model, seed), seed)
            made["train"] = self

    class Evaluated(train_net.Trainer):
        @classmethod
        def test(cls, cfg, model, evaluators=None):
            made["eval"] = model
            return {}

    monkeypatch.setattr(train_net, "Trainer", Seeded)
    train_net.main(default_argument_parser().parse_args(["--config-file", config]))
    final = DetectionCheckpointer(None, str(tmp_path / "out")).get_checkpoint_file()
    monkeypatch.setattr(train_net, "Trainer", Evaluated)
    train_net.main(default_argument_parser().parse_args(["--eval-only", "--config-file", config,
                                                         "MODEL.WEIGHTS", final]))
    trained = made["train"].model.state_dict()
    fresh = build_model(cfg, device="cpu").state_dict()  # the init an unloaded entry would keep
    seeded = chip_smoke.seed_syncbn(damped_init(build_model(cfg, device="cpu"), 3), 3).state_dict()
    sync = {f"{n}.{k}" for n, m in made["train"].model.named_modules() if isinstance(m, SyncBatchNorm)
            for k in ("weight", "bias", "running_mean", "running_var")}
    assert len(sync) > 200 and all(not torch.equal(trained[k], fresh[k]) for k in sync)
    assert sum(not torch.equal(trained[k], seeded[k]) for k in sync if k.endswith("bias")) > 50  # trained
    got = made["eval"].state_dict()
    for k, v in trained.items():
        assert torch.equal(got[k], v), k
    dst = str(tmp_path / "converted.pth")
    assert port_tool.main(["--src", final, "--dst", dst, "--config-file", config]) == 0
    converted = build_model(cfg, device="cpu")
    DetectionCheckpointer(converted).load(dst)
    got = converted.state_dict()
    for k, v in trained.items():
        assert torch.equal(got[k], v), k
