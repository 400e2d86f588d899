"""The Swin Mask R-CNN cell's harness on the CPU: its files resolve by name;
its readers return None outside their mode; ``counts_swin`` against
``torch.utils.flop_counter`` on the port's narrow model and against a
window worked by hand; ``counts.k2_bound``/``k3_bound`` on a P=14 call's
taps against a count made tap by tap; and `train_swin_mask.run` whole at a
narrow width: correct in float32, not correct under the fp8 control or a
planted fault."""
import math

import pytest
import torch

from benchmark import check, counts, counts_swin, program, spec
from benchmark.drivers import train_swin_mask
from benchmark.readings_swin_mask import FAULTS
from benchmark.reference import swin_mask
from benchmark.tests import narrow
from lvc_tpu_torch.modeling.backbone import swin

CELL = "swin_s_mask_train_b8"
NEW = ["swin_attn_ms.train", "swin_mlp_ms.train", "swin_attn_roofline_pct.train", "mask_head_ms.train",
       "mask_fg_pct.train"]
swin.SWIN_CONFIGS.setdefault("narrow_s", dict(embed_dim=16, depths=(2, 2, 18, 2), num_heads=(1, 2, 4, 8)))
swin_mask.SWIN_SIZES.setdefault("narrow_s", (16, (2, 2, 18, 2), (1, 2, 4, 8)))
OVERRIDES = dict({k: v for k, v in narrow.OVERRIDES.items() if not k.startswith(("MODEL.RESNETS", "DATALOADER"))},
                 **{"MODEL.SWIN.SWIN_SIZE": "narrow_s", "MODEL.ROI_MASK_HEAD.CONV_DIM": 16})
FP32 = dict(OVERRIDES, **{"SOLVER.AMP.ENABLED": False})


def test_cell_config_driver_and_readers_resolve():
    bench = spec.benchmark()
    cell = spec.cell(CELL)
    assert cell["driver"] == "train_swin_mask" and cell["traffic"]["mix"] == "coco"
    assert spec.config(cell["config"])["cfg"]["SOLVER.OPTIMIZER"] == "AdamW"
    assert [m["name"] for m in spec.end_to_end(bench, CELL)] == ["train_img_per_s", "setup_s"]
    reported = {m["name"] for m in spec.per_layer(bench, CELL)}
    assert set(NEW) <= reported and "k2_roofline_pct.train" in reported and "loader_wait_ms.train" not in reported
    # rank 0's trace summary: its ranges and kernels, the ranks' idle and exposed all-reduce; the program's
    # spans are recorded in the rank processes, so their readers have nothing there
    assert {m["name"] for m in spec.per_layer(bench, "base_train_dp4")} == {
        "idle_pct.train", "mfu.train", "allreduce_exposed_ms.train", "backbone_ms.train", "rpn_ms.train",
        "roi_heads_ms.train", "backward_ms.train", "optimizer_ms.train", "k2_roofline_pct.train",
        "k3_roofline_pct.train"}
    assert {k["call"] for k in spec.kernels(bench, CELL)} == {"lvc_tpu_torch.ops.roi_align:roi_align_paired",
                                                              "lvc_tpu_torch.ops.roi_align:roi_align_paired_bwd"}


@pytest.mark.parametrize("name", NEW)
def test_new_readers_return_none_outside_their_mode(name):
    trace = {"range_ms": {}, "kernels_ms": {}, "busy_s": 1.0, "window_s": 2.0}
    for mode in ("infer", "train"):
        ctx = spec.Context(mode, {"seconds": 1.0, "flops": 1.0, "peak_flops": 1.0}, trace if mode == "infer" else None,
                           2, {"swin.attention": 1.0})
        assert spec.reader(name)(ctx) is None


def _narrow_cfg():
    return dict(spec.config("swin_s_mask_rcnn_3x")["cfg"], **FP32)


def test_swin_flops_against_the_flop_counter():
    """Swin (narrow widths, Swin-S's depths) and the FPN on a 96x160 canvas,
    and the mask head on 5 boxes, counted by ``torch.utils.flop_counter``
    while the port computes them: within 5% (the counter also counts the
    FPN's upsampling adds as nothing and the attention's products as
    ``bmm``)."""
    from torch.utils.flop_counter import FlopCounterMode

    cfgd = _narrow_cfg()
    model = program.build_model(program.port_cfg(spec.config("swin_s_mask_rcnn_3x"), FP32),
                                train_swin_mask.swin_weights.make(cfgd, 3, torch.device("cpu")), torch.device("cpu"))
    x = torch.randn(1, 3, 96, 160)
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        model.backbone(x.contiguous(memory_format=torch.channels_last))
    want, _ = counts_swin.backbone_flops(cfgd, 96, 160)
    assert fc.get_total_flops() == pytest.approx(want, rel=0.05)
    pooled = torch.randn(5, 14, 14, 256)
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        model.roi_heads.mask_head(pooled)
    assert fc.get_total_flops() == pytest.approx(5 * counts_swin.mask_head_flops(cfgd), rel=0.05)


def test_attention_least_ms_of_one_window_by_hand(monkeypatch):
    """One block (C=96, 3 heads) on a 28x28 canvas: 7x7 tokens, one window.
    FLOPs 2 x 49 x (3 x 96^2 + 2 x 49 x 96 + 96^2); bytes, bf16: the input
    and output 2 x 49 x 96, the weights 4 x 96^2 + 4 x 96 + 169 x 3 + 2 x 96."""
    monkeypatch.setitem(swin_mask.SWIN_SIZES, "one", (96, (1, 0, 0, 0), (3, 6, 12, 24)))
    cfg = dict(spec.config("swin_s_mask_rcnn_3x")["cfg"], **{"MODEL.SWIN.SWIN_SIZE": "one"})
    flops = 2 * 49 * (3 * 96 * 96 + 2 * 49 * 96 + 96 * 96)
    nbytes = 2 * (2 * 49 * 96 + 4 * 96 * 96 + 4 * 96 + 169 * 3 + 2 * 96)
    want = max(flops / 989e12, nbytes / 3.35e12) * 1e3
    assert counts_swin.attention_least_ms(cfg, 1, 28, 28) == pytest.approx(want, rel=1e-12)
    assert nbytes / 3.35e12 > flops / 989e12  # one window of one image is bound by its bytes
    # 8 images: the input and output scale with B, the weights do not
    flops8 = 8 * flops
    nbytes8 = 2 * (2 * 8 * 49 * 96 + 4 * 96 * 96 + 4 * 96 + 169 * 3 + 2 * 96)
    assert counts_swin.attention_least_ms(cfg, 8, 28, 28) == pytest.approx(
        max(flops8 / 989e12, nbytes8 / 3.35e12) * 1e3, rel=1e-12)


def _by_taps(level_shapes, itemsize, taps, backward):
    """The K2 (K3) bound counted tap by tap: each feature pixel a nonzero
    row tap and a nonzero in-range column tap reach, once."""
    n, P, NR = taps.rows.shape
    C = level_shapes[0][3]
    pixels, ops = set(), 0
    for i in range(n):
        lv = int(taps.lvl[i])
        W = level_shapes[lv][2]
        for py in range(P):
            rows = [int(taps.rows[i, py, r]) for r in range(NR)
                    if float(taps.wy[i, py, r]) != 0 and int(taps.rows[i, py, r]) >= 0]
            for px in range(P):
                cols = [int(taps.xs[i]) + int(taps.tcol[i, px, t]) for t in range(taps.tcol.shape[2])
                        if float(taps.wx[i, px, t]) != 0 and int(taps.xs[i]) + int(taps.tcol[i, px, t]) < W]
                pixels |= {(lv, r, c) for r in rows for c in cols}
                ops += C * (len(cols) * (2 * len(rows) + (0 if backward else 2)) + 1)
    meta = sum(t.numel() * t.element_size() for t in taps)
    out = n * P * P * C * itemsize
    if backward:
        nbytes = out + meta + sum(math.prod(s) for s in level_shapes) * itemsize
    else:
        nbytes = len(pixels) * C * itemsize + out + meta
    return max(nbytes / counts.HBM_BYTES_PER_S, ops / counts.F32_OPS_PER_S) * 1e3


@pytest.mark.parametrize("P", [7, 14])
def test_k2_k3_bounds_of_a_p14_call_by_tap(P):
    """The port's training pool at P (the box head's 7, the mask head's 14)
    on two levels, its K2 and K3 calls recorded as a traced run records
    them: ``counts.k2_bound``/``k3_bound`` equal the count made tap by tap."""
    from lvc_tpu_torch.ops import roi_align

    g = torch.Generator().manual_seed(P)
    feats = [torch.randn(2, 24, 40, 8, generator=g, requires_grad=True),
             torch.randn(2, 12, 20, 8, generator=g, requires_grad=True)]
    xy = torch.rand(2, 6, 2, generator=g) * torch.tensor([120.0, 70.0])
    wh = 4 + torch.rand(2, 6, 2, generator=g) * 60
    boxes = torch.cat([xy, xy + wh], -1)
    kernels = [{"call": "lvc_tpu_torch.ops.roi_align:roi_align_paired", "counts": "benchmark.counts:K2"},
               {"call": "lvc_tpu_torch.ops.roi_align:roi_align_paired_bwd", "counts": "benchmark.counts:K3"}]
    with program.KernelCalls(kernels) as kc:
        roi_align.pool_paired_train(feats, boxes, (4, 8), output_size=P, min_level=2).sum().backward()
    (k2,), (k3,) = kc.calls[kernels[0]["call"]], kc.calls[kernels[1]["call"]]
    assert k2[2].rows.shape[1] == P
    assert counts.K2.least_ms(k2) == pytest.approx(_by_taps(*k2, backward=False), rel=1e-12)
    assert counts.K3.least_ms(k3) == pytest.approx(_by_taps(*k3, backward=True), rel=1e-12)


def _cell():
    c = narrow.cell(spec.cell(CELL))
    assert c["traffic"]["vertices"] == [8, 16]
    return c


def test_narrow_run_is_correct_and_reads_its_metrics():
    cell = _cell()
    kernels = spec.kernels(spec.benchmark(), CELL)
    out = train_swin_mask.run(cell, spec.config(cell["config"]), 2 ** 40 + 9, 0.2, True, torch.device("cpu"), FP32,
                              kernels=kernels)
    n = out["numbers"]
    assert n["proposal_mismatch"] == 0
    for k in ("rpn_logit_gap", "loss_gap", "grad_gap", "update_gap", "mask_logit_gap"):
        assert n[k] < 1e-3, (k, n[k])
    assert check.judge(n, cell["limits"])[0]
    assert cell["driver"] == "train"  # the readers' mode
    ctx = spec.Context(cell["driver"], out["window"], out["trace"], out["traced_steps"], out["kernel_least_ms"])
    assert out["kernel_least_ms"]["swin.attention"] > 0
    assert 0 < spec.reader("mask_fg_pct.train")(ctx) <= 25.0
    assert spec.reader("mfu.train")(ctx) > 0
    assert spec.reader("swin_attn_ms.train")(ctx) is None  # no stream time on the CPU


def test_control_is_not_correct():
    cell = _cell()
    cfgd = dict(spec.config(cell["config"])["cfg"], **OVERRIDES)
    numbers = train_swin_mask.played(cfgd, cell, 5, torch.device("cpu"), "fp8")
    assert not check.judge(numbers, cell["limits"])[0], numbers


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct(fault):
    cell = _cell()
    out = train_swin_mask.run(cell, spec.config(cell["config"]), 21, 0.2, False, torch.device("cpu"), FP32,
                              faults=FAULTS[fault]())
    assert not check.judge(out["numbers"], cell["limits"])[0], out["numbers"]
