"""Swin Mask R-CNN on AdamW (``SOLVER.OPTIMIZER "AdamW"``) through the port's
``make_train_step`` against the benchmark's plain reference
(``benchmark/reference/swin_mask.py``), on the CPU in float32, from the
reference's seeded weights (``swin_weights``) on seeded bitmask traffic
(``traffic/masks.py``).

The model keeps Swin-S's depths (2, 2, 18, 2) with widths cut (embed 16,
heads 1-2-4-8, the mask head 16 wide, 16 slots an image), two images on a
96x160 canvas. The reference follows the port's proposal selection (its
replay must give the port's proposals exactly); tolerances, all float32
against float32 summed in other orders through 24 blocks:

- losses of each of the three steps: rel 1e-5;
- the first step's gradient of every parameter: rel L2 1e-4, but the qkv
  biases' key thirds, whose exact gradient is 0 (the softmax cancels them)
  and which both sides leave at float noise;
- each parameter's change after three AdamW steps: rel L2 1e-3 of the
  change (AdamW divides each gradient by its own size, so an element whose
  gradient is within float noise of 0 moves by noise; the qkv key thirds
  again left out);
- the foreground slots' mask logits (every class) of each step: rel L2 1e-5.

The reference's first step in fp8 e4m3 in the port's place (the
benchmark's control, one precision below the cell's bf16 AMP) fails them. AdamW's groups on
Swin-S's names, ``build_optimizer``'s SGD on R-50-FPN as it was, and the
Swin and mask spans (recorded only while a profiler records) close it.
"""
import pytest
import torch
from torch.profiler import profile

from benchmark import spec
from benchmark.drivers.train_swin_mask import MaskCapture, replay_selection
from benchmark.reference import boxes as bx
from benchmark.reference import swin_mask as ref
from benchmark.reference import swin_weights
from benchmark.traffic.masks import make_mask_pool
from lvc_tpu_torch.config import get_cfg
from lvc_tpu_torch.engine.train_loop import make_train_step
from lvc_tpu_torch.modeling.backbone import swin
from lvc_tpu_torch.modeling.meta_arch.build import build_model
from lvc_tpu_torch.solver.build import (
    SGD, AdamW, adamw_no_decay, build_lr_schedule, build_optimizer, trainability_mask, wd_groups)
from lvc_tpu_torch.utils import tracing

NARROW = "narrow_s"
swin.SWIN_CONFIGS.setdefault(NARROW, dict(embed_dim=16, depths=(2, 2, 18, 2), num_heads=(1, 2, 4, 8)))
ref.SWIN_SIZES.setdefault(NARROW, (16, (2, 2, 18, 2), (1, 2, 4, 8)))

OVERRIDES = {
    "MODEL.SWIN.SWIN_SIZE": NARROW, "MODEL.ROI_MASK_HEAD.CONV_DIM": 16, "MODEL.ROI_BOX_HEAD.FC_DIM": 64,
    "MODEL.RPN.PRE_NMS_TOPK_TRAIN": 200, "MODEL.RPN.POST_NMS_TOPK_TRAIN": 100,
    "MODEL.RPN.PRE_NMS_TOPK_TEST": 200, "MODEL.RPN.POST_NMS_TOPK_TEST": 100, "TEST.DETECTIONS_PER_IMAGE": 10,
    "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE": 16, "MODEL.ROI_HEADS.POOLER_IMPL": "pallas",
    "PAD.CANVAS_BUCKETS": [[96, 160]], "PAD.MAX_GT_PER_IMAGE": 6, "INPUT.MIN_SIZE_TRAIN": [96],
    "INPUT.MAX_SIZE_TRAIN": 160, "SOLVER.AMP.ENABLED": False, "SOLVER.BASE_LR": 1e-3,
}
TRAFFIC = {"batch": 2, "structure_seed": 0, "canvases": [0, 0, 0], "photos": [[72, 120, 1], [96, 160, 1]],
           "min_sizes": [96], "vertices": [8, 16],
           "boxes": {"count_lognormal": [1.2, 0.4], "count_range": [2, 6], "area_mix": [[12, 40, 0.5], [40, 80, 0.5]]}}
SEED = 2 ** 33 + 17
STEPS = 3


def _config():
    config = spec.config("swin_s_mask_rcnn_3x")
    return config, dict(config["cfg"], **OVERRIDES)


def _port_cfg():
    from benchmark.program import port_cfg

    return port_cfg(_config()[0], OVERRIDES)


def rel_l2(a, b):
    a, b = a.detach().double(), b.detach().double()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b).clamp(min=1e-30))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The narrow model's ops are small: one intra-op thread runs them without
    the spinning of many, which the suite's parallel workers would share."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def run(one_thread):
    """The port's three steps (losses, first gradients, last parameters,
    captures) and the reference's along the port's choices."""
    cfgd = _config()[1]
    dev = torch.device("cpu")
    params0 = swin_weights.make(cfgd, SEED, dev)
    batches = make_mask_pool(TRAFFIC, cfgd, SEED + 1, dev)
    seeds = [bx.fold_in(SEED, 3, i) for i in range(STEPS)]
    model = build_model(_port_cfg(), device="cpu")
    model.load_state_dict(params0, strict=True)
    model.train()
    opt = build_optimizer(_port_cfg(), model)
    step = make_train_step(model, opt, build_lr_schedule(_port_cfg(), opt))
    capture = MaskCapture(model)
    losses, grads = [], None
    for i in range(STEPS):
        capture.begin()
        metrics = step(batches[i], seeds[i])
        capture.end()
        losses.append({k: float(v) for k, v in metrics.items() if k != "total_loss"})
        if i == 0:
            grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    capture.remove()
    follow, mismatch = [], 0
    for call, batch in zip(capture.calls, batches):
        sel, bad = replay_selection(cfgd, call, batch["image_size"])
        follow.append({"selection": sel, "proposals": call["proposals"]})
        mismatch += bad
    return dict(cfgd=cfgd, params0=params0, batches=batches, seeds=seeds, follow=follow, mismatch=mismatch,
                losses=losses, grads=grads, params={n: p.detach() for n, p in model.named_parameters()},
                calls=capture.calls, ref=ref.steps(cfgd, params0, batches, seeds, "fp32", follow))


def _gaps(run, play):
    """The largest gaps of ``play`` (the reference's ``steps`` output, or the
    port's readings in its form) from the reference's own steps, over the
    steps it made; the update only after all three."""
    r = run["ref"]
    gaps = {
        "loss": max(abs(pl[k] - v) / abs(v) for pl, rl in zip(play["losses"], r["losses"]) for k, v in rl.items()),
        "grad": max(rel_l2(ref.measured(k, play["grads"][k]), ref.measured(k, g)) for k, g in r["grads"].items()),
        "mask": max(rel_l2(logits[rows], want)
                    for logits, rows, want in zip(play["mask_logits"], r["fg_rows"], r["mask_logits"])),
    }
    if len(play["losses"]) == STEPS:
        gaps["update"] = max(rel_l2(ref.measured(k, play["params"][k] - run["params0"][k]),
                                    ref.measured(k, r["params"][k] - run["params0"][k])) for k in r["params"])
    return gaps


LIMITS = {"loss": 1e-5, "grad": 1e-4, "update": 1e-3, "mask": 1e-5}


def test_port_matches_the_reference(run):
    assert run["mismatch"] == 0
    assert set(run["losses"][0]) == {"loss_rpn_cls", "loss_rpn_loc", "loss_cls", "loss_box_reg", "loss_mask"}
    assert all(len(rows) > 0 for rows in run["ref"]["fg_rows"])
    play = {"losses": run["losses"], "grads": run["grads"], "params": run["params"],
            "mask_logits": [c["mask_logits"] for c in run["calls"]]}
    gaps = _gaps(run, play)
    assert all(gaps[k] <= LIMITS[k] for k in LIMITS), gaps
    # each parameter moved, and by a learning-rate-sized step (AdamW's)
    for k, p in run["params"].items():
        assert float((p - run["params0"][k]).abs().max()) > 0, k


def test_fp8_control_fails_a_tolerance(run):
    """The reference's first step at fp8 in the port's place, along the
    port's choices, its mask logits put back on the slots it sampled."""
    cfgd = run["cfgd"]
    play = ref.steps(cfgd, run["params0"], run["batches"][:1], run["seeds"][:1], "fp8", run["follow"][:1])
    logits = []
    for rows, fg in zip(play["fg_rows"], play["mask_logits"]):
        whole = torch.zeros((2 * cfgd["MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE"],) + tuple(fg.shape[1:]))
        whole[rows] = fg
        logits.append(whole)
    gaps = _gaps(run, {"losses": play["losses"], "grads": play["grads"], "mask_logits": logits})
    assert any(gaps[k] > LIMITS[k] for k in gaps), gaps


def test_adamw_groups_on_swin_s():
    """Swin-S Mask R-CNN (full width, on the meta device): decay 0 exactly
    for the norms' affines and the bias tables (the reference's rule by
    name), WEIGHT_DECAY for the rest, biases included; betas and the
    learning rate from the config; every parameter trains."""
    config = spec.config("swin_s_mask_rcnn_3x")
    from benchmark.program import port_cfg

    cfg = port_cfg(config)
    with torch.device("meta"):
        model = build_model(cfg, device="meta")
    opt = build_optimizer(cfg, model)
    assert type(opt) is AdamW
    names = {id(p): n for n, p in model.named_parameters()}
    by_decay = {g["weight_decay"]: {names[id(p)] for p in g["params"]} for g in opt.param_groups}
    assert set(by_decay) == {0.05, 0.0}
    assert by_decay[0.0] == adamw_no_decay(model) == {n for n in names.values() if not ref.decays(n)}
    assert by_decay[0.0] | by_decay[0.05] == set(names.values())
    assert sum(n.endswith("relative_position_bias_table") for n in by_decay[0.0]) == 24
    assert "backbone.bottom_up.layers.2.blocks.17.attn.qkv.bias" in by_decay[0.05]
    assert "roi_heads.mask_head.predictor.bias" in by_decay[0.05]
    assert "backbone.bottom_up.layers.1.downsample.norm.weight" in by_decay[0.0]
    assert all(g["betas"] == (0.9, 0.999) and g["lr"] == 1e-4 for g in opt.param_groups)


def test_sgd_is_built_as_before():
    """``SOLVER.OPTIMIZER "SGD"`` (the default) on the R-50-FPN: the SGD of
    d2's three weight-decay groups in the order other, bias, norm, each
    group the trainable parameters of that kind in model order, momentum,
    the clip settings; and its step is the clipped gradient plus decay
    through torch's SGD."""
    cfg = get_cfg()
    cfg.merge_from_file("configs/Base-RCNN-FPN.yaml")
    cfg.merge_from_list(["MODEL.RESNETS.DEPTH", 50, "SOLVER.WEIGHT_DECAY_BIAS", 3e-4, "SOLVER.MOMENTUM", 0.8,
                         "SOLVER.CLIP_GRADIENTS.ENABLED", True, "SOLVER.CLIP_GRADIENTS.CLIP_TYPE", "norm",
                         "SOLVER.CLIP_GRADIENTS.CLIP_VALUE", 0.5])
    assert cfg.SOLVER.OPTIMIZER == "SGD"
    with torch.device("meta"):
        model = build_model(cfg, device="meta")
    opt = build_optimizer(cfg, model)
    assert type(opt) is SGD and (opt.clip_type, opt.clip_value) == ("norm", 0.5)
    mask, groups = trainability_mask(model, cfg), wd_groups(model)
    want = [(kind, [p for n, p in model.named_parameters() if mask[n] and groups[n] == kind])
            for kind in ("other", "bias", "norm")]
    want = [(kind, ps) for kind, ps in want if ps]
    decay = {"other": 1e-4, "bias": 3e-4, "norm": 0.0}
    assert len(opt.param_groups) == len(want)
    for g, (kind, ps) in zip(opt.param_groups, want):
        assert [id(p) for p in g["params"]] == [id(p) for p in ps]
        assert (g["weight_decay"], g["lr"], g["momentum"], g["nesterov"]) == (decay[kind], cfg.SOLVER.BASE_LR,
                                                                              0.8, False)
    assert not any(p.requires_grad for n, p in model.named_parameters() if not mask[n])

    w = torch.nn.Parameter(torch.tensor([3.0, -4.0]))
    b = torch.nn.Parameter(torch.tensor([1.0]))
    sgd = SGD([{"params": [w], "weight_decay": 0.1}, {"params": [b], "weight_decay": 0.0}], clip_type="norm",
              clip_value=0.5, lr=0.1, momentum=0.9)
    w.grad = torch.tensor([6.0, 8.0])  # norm 10 -> clipped to 0.5 of it; b has no gradient: a zero one
    sgd.step()
    torch.testing.assert_close(w.detach(), torch.tensor([3.0, -4.0]) - 0.1 * (torch.tensor([0.3, 0.4])
                                                                               + 0.1 * torch.tensor([3.0, -4.0])))
    torch.testing.assert_close(b.detach(), torch.tensor([1.0]))


def _model():
    model = build_model(_port_cfg(), device="cpu")
    model.load_state_dict(swin_weights.make(_config()[1], SEED, torch.device("cpu")), strict=True)
    return model


def test_spans_and_counters_only_while_a_profiler_records():
    cfgd = _config()[1]
    batch = make_mask_pool(TRAFFIC, cfgd, SEED + 1, torch.device("cpu"))[0]
    model = _model().train()
    tracing.reset()
    with torch.no_grad():
        model(batch, torch.Generator().manual_seed(0))
    assert tracing.totals() == {}
    with profile(), torch.no_grad():
        losses = model(batch, torch.Generator().manual_seed(0))
        model.eval()
        dets = model({k: batch[k] for k in ("image", "image_size")})
    totals = tracing.totals()
    tracing.reset()
    assert "loss_mask" in losses
    assert totals["swin.attention"]["calls"] == totals["swin.mlp"]["calls"] == 2 * 24
    assert totals["swin.merge"]["calls"] == 2 * 3
    # the windows of a 96x160 canvas: tokens 24x40, 12x20, 6x10, 3x5, padded to 7s
    windows = 2 * (4 * 6) + 2 * (2 * 3) + 18 * (1 * 2) + 2 * 1
    assert totals["swin.attention"]["counts"] == {"swin.windows": 2 * 2 * windows}  # two forwards of two images
    mask = totals["roi_heads.mask"]
    assert mask["calls"] == 2
    D = dets.valid.shape[1]
    assert mask["counts"]["mask.slots"] == 2 * 16 + 2 * D
    assert 0 < mask["counts"]["mask.fg_slots"] <= 2 * 16 * 0.25 + int(dets.valid.sum())
