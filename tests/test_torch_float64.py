"""The float64 witness that ``chip_smoke.py``'s phase 25 holds the card's and
the CPU's float32 against, on the CPU.

- The plain versions of K2 and K3 take float64 features (and gradients)
  with float64 tap weights on the CPU and sum in float64; they agree with
  their float32 results to atol 1e-5 (the float32 rounding of sums of a few
  hundred terms of order 1). Float64 features with float32 taps stay
  refused (``tests/test_torch_roi_align.py::test_wrapper_rejects_bad_inputs``).
- ``chip_smoke.float64_witness`` runs phase 25's narrow C4 model, converted
  to float64, in float64: its gradients are float64, its losses differ from
  the float32 model's (so no float32 cast was left in) by at most rel 1e-5,
  its gradients by rel L2 1e-3 (the float32 backbone gradients are 6e-6 to
  6e-5 from float64 on these batches), and its detections keep the float32
  model's slots with boxes within 1e-2 px.
"""
import copy

import numpy as np
import torch

import chip_smoke
from lvc_tpu_torch.modeling.meta_arch.build import build_model
from lvc_tpu_torch.ops import roi_align as tra
from test_torch_roi_cases import _pyramid


def _to64(taps):
    return taps._replace(inv=taps.inv.double(), wy=taps.wy.double(), wx=taps.wx.double())


def test_plain_pools_take_float64_on_the_cpu():
    feats, boxes, strides = _pyramid()
    tfeats = [torch.from_numpy(f) for f in feats]
    shapes = [tuple(f.shape[1:3]) for f in feats]
    prep = tra.tiled_prep_2d(shapes, 2, torch.from_numpy(boxes), strides)
    taps = tra.paired_taps(prep, shapes, 48)
    want = tra.roi_align_paired(tfeats, taps)
    got = tra.roi_align_paired([f.double() for f in tfeats], _to64(taps))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want.double().numpy(), atol=1e-5, rtol=0)

    gout = torch.from_numpy(np.random.RandomState(5).rand(*want.shape).astype(np.float32))
    level_shapes = [tuple(f.shape) for f in tfeats]
    want_g = tra.roi_align_paired_bwd(level_shapes, taps, gout)
    got_g = tra.roi_align_paired_bwd(level_shapes, _to64(taps), gout.double())
    for w, g in zip(want_g, got_g):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), w.double().numpy(), atol=1e-5, rtol=0)


def test_float64_witness_runs_the_model_in_float64():
    cfg = chip_smoke.extra_heads_cfg("Res5ROIHeads", "cpu")
    batch = chip_smoke.train_batch(2, 128, 192, 4, seed=8, device="cpu", num_classes=5, n_gt=(3, 3),
                                   size=(40, 120))
    model = chip_smoke.extra_heads_init(build_model(cfg, device="cpu"))
    witness = copy.deepcopy(model).double()
    witness.compute_dtype = torch.float64
    c_loss, c_grad, c_dets, _, _ = chip_smoke.extra_heads_run(model, cfg, batch, True)
    w_loss, w_grad, w_dets, _, _ = chip_smoke.extra_heads_run(witness, cfg, batch, True)
    assert all(p.grad.dtype == torch.float64 for p in witness.parameters() if p.requires_grad)
    assert w_dets.boxes.dtype == torch.float64
    assert set(c_loss) == set(w_loss) and c_loss != w_loss
    for k, w in w_loss.items():
        assert abs(c_loss[k] - w) <= 1e-5 * abs(w), k
    for k, w in w_grad.items():
        assert float((c_grad[k] - w).norm() / w.norm()) <= 1e-3, k
    n, box_err, score_err = chip_smoke.detection_errors("float32 vs float64", w_dets, c_dets)
    assert n >= 10 and box_err <= 1e-2 and score_err <= 1e-4
