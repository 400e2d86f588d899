"""The ResNet-D (CLIP) and deformable bottlenecks, deformable convolution
and the CLIP optimizer against the JAX package on the CPU, on the same
weights (``from_flax``) and inputs made from a numpy seed.

- ``deform_conv2d`` v1 and v2 at stride 2, dilation 2 and padding 2 on a
  (2, 8, 11, 13) input, with offsets that push samples out of range (below
  -1, at exactly -1 and H), into (-1, 0), exactly onto rows 0 and H-1 and
  onto integer positions: outputs abs 1e-5 of the largest, gradients of the
  input, the weight, the offsets and the modulation rel L2 1e-4.
- ``DeformConv`` with its zero-initialised offset conv: every edge tap sits
  exactly on row 0 or H-1, where the clip's gradient splits (0.5, as
  ``jnp.clip``'s): the offset conv's gradient rel L2 1e-4.
- ``BottleneckBlockCLIP`` and ``DeformBottleneckBlock`` (v1 and v2, stride 2
  with the shortcut) against the flax blocks: outputs abs 1e-5 of the
  largest, gradients rel L2 1e-4.
- Narrow ResNet-D and DCN (DEFORM_ON_PER_STAGE F,T,T,T, v1) Faster R-CNNs
  through ``make_train_step`` and inference: the tolerances of
  tests/test_torch_swin.py's ``check_detector`` (the whole-model ones of
  tests/test_torch_c4.py and test_torch_train.py). JAX fills the deformable ``weight`` with ones (its
  ``materialize_variables`` rule for a leaf named ``weight``), so the test
  redraws it from N(0, 2/fan_out), scales the offset convs by 0.1 and,
  as tests/test_torch_train.py does for the R-50, every other bottom-up
  kernel by 0.7 (so the class scores do not saturate).
- ``build_clip_optimizer`` over 3 steps with momentum 0.9 and the three weight
  decays, from the same gradients: every parameter rel 1e-6 of its norm
  against optax's, and (in float64, where the warm-up's tiny first update is
  not lost to the rounding of the weights) a first bottom-up update
  CLIP_LR/BASE_LR times the plain optimizer's, rel 1e-10. ``train_net_qe_ig``'s trainer builds it for
  ``MODEL.RESNETS.D``.
- Every DEFORM_ON_PER_STAGE pattern tried, DCN v1 and v2, and ResNet-D build
  and run a forward; the weight-decay groups of the ResNet-D and the GN DCN
  models equal JAX's; the weights round-trip through ``to_flax`` and a
  detectron2-layout state dict loads strictly.
"""
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from lvc_tpu.config import get_cfg as jax_get_cfg
from lvc_tpu.modeling.backbone import resnet as jresnet
from lvc_tpu.ops import deform_conv as jdc
from lvc_tpu.solver.build import build_clip_optimizer as jax_build_clip_optimizer

from lvc_tpu_torch.checkpoint.convert import from_flax, to_flax
from lvc_tpu_torch.config import get_cfg
from lvc_tpu_torch.modeling.backbone import resnet
from lvc_tpu_torch.modeling.meta_arch.build import build_model
from lvc_tpu_torch.ops import deform_conv as dc
from lvc_tpu_torch.solver.build import build_clip_optimizer, build_lr_schedule, build_optimizer
from lvc_tpu_torch.tools.train_net_qe_ig import TrainerQEIgnore
from test_torch_swin import check_detector, check_wd_groups, leaves, rel_l2

NARROW = ["MODEL.RESNETS.RES2_OUT_CHANNELS", 64, "MODEL.RESNETS.WIDTH_PER_GROUP", 16]
RESNET_D = NARROW + ["MODEL.RESNETS.D", True]
DCN = NARROW + ["MODEL.RESNETS.DEFORM_ON_PER_STAGE", [False, True, True, True]]


def _offsets(N, K, Ho, Wo, H, W, stride, pad, dil, seed=0):
    """(N, Ho, Wo, K*K, 2) offsets: random, with taps moved onto integer
    positions, exactly onto rows/columns 0 and H-1 / W-1, into (-1, 0),
    onto exactly -1 and H, and far outside."""
    rng = np.random.RandomState(seed)
    off = rng.uniform(-3, 3, (N, Ho, Wo, K * K, 2)).astype(np.float32)
    hh, ww, ky, kx = np.meshgrid(np.arange(Ho), np.arange(Wo), np.arange(K), np.arange(K), indexing="ij")
    base_y = (hh * stride - pad + ky * dil).reshape(Ho, Wo, K * K)
    base_x = (ww * stride - pad + kx * dil).reshape(Ho, Wo, K * K)
    base = np.stack([base_y, base_x], -1)[None].repeat(N, 0)
    size = np.array([H, W], np.float32)
    kind = rng.randint(0, 8, off.shape)
    pos = base + off
    pos = np.where(kind == 1, np.round(pos), pos)
    pos = np.where(kind == 2, 0.0, pos)
    pos = np.where(kind == 3, size - 1, pos)
    pos = np.where(kind == 4, -0.5, pos)
    pos = np.where(kind == 5, -1.0, pos)
    pos = np.where(kind == 6, size, pos)
    pos = np.where(kind == 7, rng.uniform(-6, 20, off.shape), pos)
    return (pos - base).astype(np.float32)


@pytest.mark.parametrize("modulated", [False, True])
def test_deform_conv2d_matches_jax(modulated):
    rng = np.random.RandomState(0)
    N, C, H, W, F, K, s, p, d = 2, 8, 11, 13, 6, 3, 2, 2, 2
    Ho = (H + 2 * p - d * (K - 1) - 1) // s + 1
    Wo = (W + 2 * p - d * (K - 1) - 1) // s + 1
    x = rng.randn(N, H, W, C).astype(np.float32)
    w = rng.randn(K, K, C, F).astype(np.float32) * 0.3
    off = _offsets(N, K, Ho, Wo, H, W, s, p, d).reshape(N, Ho, Wo, 2 * K * K)
    mask = rng.uniform(0, 2, (N, Ho, Wo, K * K)).astype(np.float32) if modulated else None
    wts = rng.randn(N, Ho, Wo, F).astype(np.float32)

    def f(x, off, w, mask):
        out = jdc.deform_conv2d(x, off, w, s, p, d, mask)
        return jnp.sum(out * wts), out

    args = tuple(jnp.asarray(a) if a is not None else None for a in (x, off, w, mask))
    argnums = (0, 1, 2, 3) if modulated else (0, 1, 2)
    (_, j_out), j_g = jax.jit(jax.value_and_grad(f, argnums=argnums, has_aux=True))(*args)
    tx = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).requires_grad_(True)
    toff = torch.from_numpy(off.transpose(0, 3, 1, 2).copy()).requires_grad_(True)
    tw = torch.from_numpy(w.transpose(3, 2, 0, 1).copy()).requires_grad_(True)
    tm = torch.from_numpy(mask.transpose(0, 3, 1, 2).copy()).requires_grad_(True) if modulated else None
    out = dc.deform_conv2d(tx, toff, tw, s, p, d, tm)
    (out * torch.from_numpy(wts.transpose(0, 3, 1, 2).copy())).sum().backward()
    j_out = np.asarray(j_out).transpose(0, 3, 1, 2)
    assert np.abs(out.detach().numpy() - j_out).max() <= 1e-5 * np.abs(j_out).max()
    assert rel_l2(tx.grad.numpy().transpose(0, 2, 3, 1), j_g[0]) <= 1e-4
    assert rel_l2(toff.grad.numpy().transpose(0, 2, 3, 1), j_g[1]) <= 1e-4
    assert rel_l2(tw.grad.numpy().transpose(2, 3, 1, 0), j_g[2]) <= 1e-4
    if modulated:
        assert rel_l2(tm.grad.numpy().transpose(0, 2, 3, 1), j_g[3]) <= 1e-4


def _block_check(jblock, tblock, x_nchw, name, prepare=None):
    """A flax block and the port's on the same weights (the flax variables
    placed at ``backbone/bottom_up/<name>``): output abs 1e-5 of the largest,
    gradients of the input and every parameter rel L2 1e-4."""
    xj = jnp.asarray(x_nchw.transpose(0, 2, 3, 1))
    var = jax.tree_util.tree_map(np.array, jax.jit(jblock.init)(jax.random.PRNGKey(0), xj))
    if prepare is not None:
        prepare(var)
    wts = np.random.RandomState(5).randn(*jax.eval_shape(lambda v: jblock.apply(v, xj), var).shape).astype(
        np.float32)

    def f(params, x):
        out = jblock.apply({"params": params, "batch_stats": var["batch_stats"]}, x)
        return jnp.sum(out * wts), out

    (_, j_out), (j_gp, j_gx) = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(var["params"], xj)

    def port(tree):
        tree = {k: {"backbone": {"bottom_up": {name: v}}} for k, v in tree.items()}
        prefix = f"backbone.bottom_up.{name}."
        return {k[len(prefix):]: v for k, v in from_flax(tree).items()}

    tblock.load_state_dict(port(var), strict=True)
    tx = torch.from_numpy(x_nchw).requires_grad_(True)
    out = tblock(tx)
    (out * torch.from_numpy(wts.transpose(0, 3, 1, 2).copy())).sum().backward()
    j_out = np.asarray(j_out).transpose(0, 3, 1, 2)
    assert np.abs(out.detach().numpy() - j_out).max() <= 1e-5 * np.abs(j_out).max()
    assert rel_l2(tx.grad.numpy().transpose(0, 2, 3, 1), j_gx) <= 1e-4
    g = port({"params": jax.tree_util.tree_map(np.asarray, j_gp)})
    for n, p in tblock.named_parameters():
        assert rel_l2(p.grad.numpy(), g[n].numpy()) <= 1e-4, n
    return var, g


def _redraw_deform(var, offset_gain=0.1, seed=0):
    """The deformable weights JAX's init leaves at ones, redrawn from
    N(0, 2/fan_out); offset convs scaled by ``offset_gain``."""
    rng = np.random.RandomState(seed)
    for path, leaf in leaves(var["params"]):
        if path[-2:] == ("conv2", "weight"):
            K, _, _, F = leaf.shape
            leaf[...] = rng.normal(0, np.sqrt(2.0 / (K * K * F)), leaf.shape)
        if "offset_conv" in path and path[-1] == "kernel":
            leaf *= offset_gain


def test_clip_block_matches_jax():
    x = np.random.RandomState(0).randn(2, 16, 13, 18).astype(np.float32)
    jb = jresnet.BottleneckBlockCLIP(out_channels=32, bottleneck_channels=8, stride=2, has_shortcut=True)
    tb = resnet.BottleneckBlockCLIP(16, 32, 8, stride=2, has_shortcut=True)
    _block_check(jb, tb, x, "res3.0")


@pytest.mark.parametrize("modulated", [False, True])
def test_deform_block_matches_jax(modulated):
    x = np.random.RandomState(0).randn(2, 16, 13, 18).astype(np.float32)
    jb = jresnet.DeformBottleneckBlock(out_channels=32, bottleneck_channels=8, stride=2, has_shortcut=True,
                                      deform_modulated=modulated)
    tb = resnet.DeformBottleneckBlock(16, 32, 8, stride=2, has_shortcut=True, deform_modulated=modulated)
    _block_check(jb, tb, x, "res3.0", lambda v: _redraw_deform(v, offset_gain=3.0))


def test_zero_offsets_split_the_clip_gradient_as_jax():
    """Zero offsets (the init): the offset conv's gradient passes through
    the clip at its ties on the edge rows and columns."""
    x = np.random.RandomState(1).randn(2, 8, 9, 10).astype(np.float32)
    jb = jresnet.DeformBottleneckBlock(out_channels=8, bottleneck_channels=8, stride=1)
    tb = resnet.DeformBottleneckBlock(8, 8, 8, stride=1)

    def zero(var):
        _redraw_deform(var)
        conv = var["params"]["conv2"]["offset_conv"]
        conv["kernel"][...] = 0.0
        conv["bias"][...] = 0.0

    _, g = _block_check(jb, tb, x, "res2.1", zero)
    assert float(g["conv2_offset.weight"].abs().max()) > 0


def _damp_backbone(var):
    """``_redraw_deform``, then every bottom-up kernel and deformable weight
    scaled by 0.7 as tests/test_torch_train.py scales the R-50's (the he-init
    activations otherwise saturate the class scores)."""
    _redraw_deform(var)
    for block in var["params"]["backbone"]["bottom_up"].values():
        for path, leaf in leaves(block):
            if path[-1] == "kernel" and "offset_conv" not in path or path[-2:] == ("conv2", "weight"):
                leaf *= 0.7


@pytest.mark.parametrize("opts", [RESNET_D, DCN], ids=["resnet_d", "dcn"])
def test_detector_matches_jax(opts):
    check_detector(opts, rescale=_damp_backbone)


def test_clip_optimizer_matches_jax():
    opts = RESNET_D + ["SOLVER.WEIGHT_DECAY", 1e-2, "SOLVER.WEIGHT_DECAY_BIAS", 3e-3, "SOLVER.WEIGHT_DECAY_NORM",
                       7e-4, "SOLVER.MOMENTUM", 0.9, "SOLVER.BASE_LR", 0.02, "SOLVER.CLIP_LR", 0.002,
                       "SOLVER.WARMUP_ITERS", 2, "MODEL.BACKBONE.FREEZE_AT", 0]
    jcfg, cfg = jax_get_cfg(), get_cfg()
    for c in (jcfg, cfg):
        c.merge_from_file("configs/Base-RCNN-FPN.yaml")
        c.merge_from_list(opts)
    model = build_model(cfg, device="cpu")
    rng = np.random.RandomState(0)
    sd = {k: torch.from_numpy(rng.randn(*v.shape).astype(np.float32) * 0.1) if v.is_floating_point() else v
          for k, v in model.state_dict().items()}
    model.load_state_dict(sd)
    params = to_flax(model.state_dict())["params"]
    grads = [jax.tree_util.tree_map(lambda p: rng.randn(*p.shape).astype(np.float32), params) for _ in range(3)]

    def jax_steps(build):
        tx = build(jcfg, params)

        @jax.jit
        def step(p, state, g):
            upd, state = tx.update(g, state, p)
            return optax.apply_updates(p, upd), state

        p, state = params, tx.init(params)
        for g in grads:
            p, state = step(p, state, g)
        return from_flax({"params": jax.tree_util.tree_map(np.asarray, p)})

    def port_steps(build, steps=3, dtype=torch.float32):
        model.load_state_dict(sd)
        model.to(dtype)
        opt = build(cfg, model)
        sched = build_lr_schedule(cfg, opt)
        for g in grads[:steps]:
            tg = from_flax({"params": g})
            for n, p in model.named_parameters():
                p.grad = tg[n].to(dtype) if p.requires_grad else None
            opt.step()
            sched.step()
        out = {n: p.detach().clone() for n, p in model.named_parameters()}
        model.float()
        return out

    want, got = jax_steps(jax_build_clip_optimizer), port_steps(build_clip_optimizer)
    plain = port_steps(build_optimizer)
    assert want.keys() >= got.keys()
    for n, p in got.items():
        assert float((p - want[n]).norm()) <= 1e-6 * float(want[n].norm()), n
    # the first step moves a bottom-up parameter CLIP_LR / BASE_LR as far as the plain optimizer (later steps'
    # decay terms see different weights)
    ratio = cfg.SOLVER.CLIP_LR / cfg.SOLVER.BASE_LR
    one_clip = port_steps(build_clip_optimizer, 1, torch.float64)
    one_plain = port_steps(build_optimizer, 1, torch.float64)
    for n in ("backbone.bottom_up.res3.0.conv1.weight", "backbone.fpn_lateral3.weight"):
        scale = ratio if n.startswith("backbone.bottom_up.") else 1.0
        start = sd[n].double()
        assert rel_l2((one_clip[n] - start).numpy(), scale * (one_plain[n] - start).numpy()) <= 1e-10, n
    assert float((plain["backbone.bottom_up.res3.0.conv1.weight"] - got["backbone.bottom_up.res3.0.conv1.weight"])
                 .norm()) > 0


def test_qe_ig_trainer_builds_the_clip_optimizer():
    cfg = get_cfg()
    cfg.merge_from_file("configs/Base-RCNN-FPN.yaml")
    cfg.merge_from_list(RESNET_D + ["SOLVER.BASE_LR", 0.02, "SOLVER.CLIP_LR", 0.001])
    model = build_model(cfg, device="cpu")
    opt = TrainerQEIgnore.build_optimizer(cfg, model)
    bottom_up = {id(p) for n, p in model.named_parameters() if n.startswith("backbone.bottom_up.")}
    for group in opt.param_groups:
        scaled = {id(p) in bottom_up for p in group["params"]}
        assert len(scaled) == 1
        assert group["lr"] == pytest.approx(0.001 if scaled.pop() else 0.02, rel=1e-12)
    cfg.MODEL.RESNETS.D = False
    cfg.MODEL.RESNETS.DEFORM_ON_PER_STAGE = [False, True, False, False]
    plain = TrainerQEIgnore.build_optimizer(cfg, build_model(cfg, device="cpu"))
    assert {g["lr"] for g in plain.param_groups} == {0.02}


@pytest.mark.parametrize("pattern", [[True, False, False, False], [False, True, True, True],
                                     [True, True, True, True], [False, False, False, True]])
@pytest.mark.parametrize("modulated", [False, True])
def test_every_deform_pattern_builds_and_runs(pattern, modulated):
    cfg = get_cfg()
    cfg.merge_from_file("configs/Base-RCNN-FPN.yaml")
    cfg.merge_from_list(NARROW + ["MODEL.RESNETS.DEFORM_ON_PER_STAGE", pattern,
                                  "MODEL.RESNETS.DEFORM_MODULATED", modulated, "MODEL.RPN.POST_NMS_TOPK_TEST", 50])
    model = build_model(cfg, device="cpu")
    blocks = [m for m in model.backbone.bottom_up.modules() if isinstance(m, resnet.DeformBottleneckBlock)]
    assert len(blocks) == sum(n for n, on in zip((3, 4, 6, 3), pattern) if on)
    assert all(b.conv2_offset.out_channels == (27 if modulated else 18) for b in blocks)
    assert all(float(b.conv2_offset.weight.abs().max()) == 0 for b in blocks)
    rng = np.random.RandomState(0)
    with torch.no_grad():
        dets = model({"image": (rng.rand(1, 64, 96, 3) * 255).astype(np.float32),
                      "image_size": np.array([[64, 96]], np.int32)})
    assert torch.isfinite(dets.boxes).all()


def test_resnet_d_builds_clip_blocks_everywhere():
    cfg = get_cfg()
    cfg.merge_from_file("configs/Base-RCNN-FPN.yaml")
    cfg.merge_from_list(RESNET_D + ["MODEL.RESNETS.DEFORM_ON_PER_STAGE", [True] * 4, "MODEL.RESNETS.DROPOUT", 0.5])
    model = build_model(cfg, device="cpu")
    kinds = {type(m) for m in model.backbone.bottom_up.modules()
             if isinstance(m, (resnet.BottleneckBlock, resnet.BottleneckBlockCLIP, resnet.DeformBottleneckBlock))}
    assert kinds == {resnet.BottleneckBlockCLIP}
    assert all(c.stride == (1, 1) for c in model.backbone.bottom_up.modules() if isinstance(c, torch.nn.Conv2d)
               and c is not model.backbone.bottom_up.stem.conv1)


@pytest.mark.parametrize("opts", [RESNET_D, ["MODEL.RESNETS.NORM", "GN", "MODEL.RESNETS.RES2_OUT_CHANNELS", 128,
                                             "MODEL.RESNETS.WIDTH_PER_GROUP", 32, "MODEL.FPN.NORM", "GN",
                                             "MODEL.RESNETS.DEFORM_ON_PER_STAGE", [False, True, False, True],
                                             "MODEL.RESNETS.DEFORM_MODULATED", True, "MODEL.BACKBONE.FREEZE_AT", 3]],
                         ids=["resnet_d", "dcn_gn"])
def test_weight_decay_groups_match_jax(opts):
    groups = check_wd_groups(opts)
    if "GN" in opts:
        assert groups["backbone.bottom_up.res3.0.conv2.norm.weight"] == "norm"
        assert groups["backbone.bottom_up.res3.0.conv2_offset.bias"] == "bias"


@functools.lru_cache(maxsize=None)
def _dcn_variables():
    from lvc_tpu.modeling.meta_arch.build import build_model as jax_build_model
    from lvc_tpu.utils.init import materialize_variables

    jcfg = jax_get_cfg()
    jcfg.merge_from_file("configs/Base-RCNN-FPN.yaml")
    jcfg.merge_from_list(DCN + ["MODEL.RESNETS.DEFORM_MODULATED", True])
    jm = jax_build_model(jcfg)
    batch = {"image": jnp.zeros((1, 64, 64, 3)), "image_size": jnp.asarray([[64, 64]], jnp.int32)}
    shapes = jax.eval_shape(functools.partial(jm.init, train=False), {"params": jax.random.PRNGKey(0)}, batch)
    return jax.tree_util.tree_map(lambda v: np.array(v, np.float32),
                                  materialize_variables(shapes, seed=0, conv_init="damped"))


def test_deform_weights_round_trip_and_detectron2_names_load():
    var = _dcn_variables()
    sd = from_flax(var)
    for key, shape in (("backbone.bottom_up.res3.0.conv2_offset.weight", (27, 32, 3, 3)),
                       ("backbone.bottom_up.res3.0.conv2_offset.bias", (27,)),
                       ("backbone.bottom_up.res3.0.conv2.weight", (32, 32, 3, 3)),
                       ("backbone.bottom_up.res3.0.conv2.norm.running_var", (32,))):
        assert tuple(sd[key].shape) == shape, key
    cfg = get_cfg()
    cfg.merge_from_file("configs/Base-RCNN-FPN.yaml")
    cfg.merge_from_list(DCN + ["MODEL.RESNETS.DEFORM_MODULATED", True])
    model = build_model(cfg, device="cpu")
    model.load_state_dict(sd, strict=True)
    back = to_flax(model.state_dict())
    for coll in ("params", "batch_stats"):
        got, want = dict(leaves(back[coll])), dict(leaves(var[coll]))
        assert set(got) == set(want), coll
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v)
