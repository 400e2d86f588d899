"""``benchmark/counts.py`` against values worked out by hand."""

import pytest
import torch

from benchmark import counts, spec


def test_conv_flops_by_hand():
    # 3x3, stride 1, pad 1 on 4x6: 24 outputs x 5 x 2 x 9 multiply-adds, x2
    assert counts._conv(4, 6, 2, 5, 3, 1, 1) == (4, 6, 2.0 * 24 * 5 * 2 * 9)
    # 7x7, stride 2, pad 3 on 64x96 -> 32x48
    assert counts._conv(64, 96, 3, 8, 7, 2, 3)[:2] == (32, 48)


def test_model_flops_of_a_tiny_detector_by_hand():
    cfg = dict(spec.config("lvc_r50_fpn_base")["cfg"])
    cfg.update({"MODEL.RESNETS.STEM_OUT_CHANNELS": 1, "MODEL.RESNETS.RES2_OUT_CHANNELS": 1,
                "MODEL.RESNETS.WIDTH_PER_GROUP": 1, "MODEL.FPN.OUT_CHANNELS": 1, "MODEL.ROI_BOX_HEAD.FC_DIM": 1,
                "MODEL.ROI_HEADS.NUM_CLASSES": 1, "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE": 2,
                "MODEL.RPN.POST_NMS_TOPK_TEST": 3})
    frozen, trained, levels = counts.backbone_flops(cfg, 64, 64)
    assert levels == {"p2": (16, 16), "p3": (8, 8), "p4": (4, 4), "p5": (2, 2), "p6": (1, 1)}
    stem = 2.0 * 32 * 32 * 147
    # res2 at 16x16, widths 1/1: block 0 has a shortcut; every conv of a block is 1x1 (1), 3x3 (9), 1x1 (1)
    res2 = 2.0 * 256 * (1 + 3 * (1 + 9 + 1))
    assert frozen == pytest.approx(stem + res2)
    # the box head: 49 x 1 -> 1, then 1 -> 1, the classifier 1 -> 2, the regressor 1 -> 4, x2 a box
    per_box = 2.0 * (49 + 1 + 2 + 4)
    rpn = sum(2.0 * h * w * (9 + 3 + 12) for h, w in levels.values())
    assert counts.model_flops(cfg, 64, 64, train=False) == pytest.approx(frozen + trained + rpn + 3 * per_box)
    assert counts.model_flops(cfg, 64, 64, train=True) == pytest.approx(frozen + 3 * (trained + rpn + 2 * per_box))


def test_full_size_counts():
    cfg = spec.config("lvc_r50_fpn_base")["cfg"]
    assert counts.model_flops(cfg, 832, 1344, train=True) / 1e9 == pytest.approx(1200.77, abs=0.01)
    assert counts.peak_flops(cfg, train=True) == (989e12, "bf16")
    assert counts.peak_flops(spec.config("lvc_r50_fpn_ft_all")["cfg"], train=False) == (495e12, "tf32")


def _taps(n=1, P=1, NR=2, NT=2):
    from benchmark.reference.pool import Taps

    return Taps(torch.zeros(n, dtype=torch.int32), torch.zeros(n, dtype=torch.int32), torch.ones(n),
                torch.tensor([[[0, 1]]], dtype=torch.int32), torch.tensor([[[0.5, 0.5]]]),
                torch.tensor([[[0, 1]]], dtype=torch.int32), torch.tensor([[[0.25, 0.75]]]))


def test_k2_and_k3_bounds_by_hand():
    taps = _taps()
    shapes = [(1, 4, 4, 8)]  # one level, B=1, 4x4, C=8
    meta = sum(t.numel() * t.element_size() for t in taps)
    # 2 rows x 2 columns touched, C=8, float32; the output 1x1x8; ops: C x (2 taps x (2 rows x 2 + 2) + 1)
    nbytes = 4 * 8 * 4 + 8 * 4 + meta
    ops = 8 * (2 * (2 * 2 + 2) + 1)
    assert counts.k2_bound(shapes, 4, taps) == pytest.approx(
        max(nbytes / counts.HBM_BYTES_PER_S, ops / counts.F32_OPS_PER_S) * 1e3)
    nbytes3 = 8 * 4 + meta + 4 * 4 * 8 * 4
    ops3 = 8 * (2 * 2 * 2 + 1)
    assert counts.k3_bound(shapes, 4, taps) == pytest.approx(
        max(nbytes3 / counts.HBM_BYTES_PER_S, ops3 / counts.F32_OPS_PER_S) * 1e3)
