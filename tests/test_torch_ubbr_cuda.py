"""The box corrector's path through the RoIAlign kernels on a card against the
same path through the kernels' plain versions on the same card.

Needs a CUDA card (marker ``cuda``) and skips without one. The file imports no
JAX, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_ubbr_cuda.py

A narrow cascade UBBR model (``chip_smoke.corrector_inputs``: 3 stages,
BoxOnlyLayersCascade, POOLER_IMPL pallas) at float32 with TF32 off, from
calibrated weights: one training step's stage loop from the same sampled
slots of RBG proposals, with K2 forward and K3 backward (3 launches each) and with
the plain versions patched in for the wrappers (no launch): stage losses to
rel 1e-5, the FPN feature gradients to rel L2 1e-5 (the plain backward's
``index_add_`` sums in another order); then reg-only inference (3 K2
launches) against the plain pool, boxes within 1e-4 px.
"""
import pytest
import torch

import chip_smoke
from lvc_tpu_torch.modeling.meta_arch.build import build_model
from lvc_tpu_torch.ops import roi_align as ra
from lvc_tpu_torch.tools.train_net_reg import reg_only_model


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU form")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


class _PlainForward:
    launches = 0

    def __call__(self, levels, taps):
        return ra.roi_align_taps_plain(levels, taps, True)


class _PlainBackward:
    launches = 0

    def __call__(self, level_shapes, taps, gout):
        return [g.to(gout.dtype) for g in ra.roi_align_taps_plain_backward(level_shapes, taps, gout)]


def _run(model, batch, sampled):
    """Stage losses and the FPN features' gradients of one training
    forward, then the reg-only boxes, with the K2/K3 launches of each."""
    model.train()
    gt = {"boxes": batch["gt_boxes"], "classes": batch["gt_classes"], "valid": batch["gt_valid"]}
    ra.roi_align_paired.launches = ra.roi_align_paired_bwd.launches = 0
    features = model.backbone(model.model_images(batch))
    losses = model.roi_heads.cascade_losses(features, sampled, gt, batch["image_size"])
    names = list(model.roi_heads.in_features)
    grads = torch.autograd.grad(sum(losses.values()), [features[f] for f in names])
    train_n = ra.roi_align_paired.launches, ra.roi_align_paired_bwd.launches
    model.eval()
    ra.roi_align_paired.launches = 0
    cands = batch["gt_boxes"] + 3.0 * torch.sin(torch.arange(batch["gt_boxes"].numel(), device=batch["gt_boxes"].device)
                                                 ).reshape(batch["gt_boxes"].shape)
    out = reg_only_model(chip_smoke.corrector_cfg("cuda"), model)(dict(batch, gt_boxes=cands))
    return ({k: float(v.detach()) for k, v in losses.items()}, [g.double() for g in grads], out,
            train_n, ra.roi_align_paired.launches)


@pytest.mark.cuda
def test_corrector_kernels_match_the_plain_pool_on_card(cuda_device, monkeypatch):
    cpu, batch, _, sampled = chip_smoke.corrector_inputs()
    model = build_model(chip_smoke.corrector_cfg("cuda"))
    model.load_state_dict(cpu.state_dict())
    batch = {k: v.to(cuda_device) for k, v in batch.items()}
    sampled = type(sampled)(*(t.to(cuda_device) for t in sampled))

    k_loss, k_grads, k_out, k_train_n, k_reg_n = _run(model, batch, sampled)
    monkeypatch.setattr(ra, "roi_align_paired", _PlainForward())
    monkeypatch.setattr(ra, "roi_align_paired_bwd", _PlainBackward())
    p_loss, p_grads, p_out, p_train_n, p_reg_n = _run(model, batch, sampled)

    assert k_train_n == (3, 3) and k_reg_n == 3
    assert p_train_n == (0, 0) and p_reg_n == 0
    assert set(k_loss) == set(p_loss) == {f"loss_box_reg_stage{k}" for k in range(3)}
    for k, v in p_loss.items():
        assert v > 0 and k_loss[k] == pytest.approx(v, rel=1e-5), k
    for g, w in zip(k_grads, p_grads):
        assert float((g - w).norm() / w.norm().clamp(min=1e-30)) < 1e-5
    assert sum(float(w.abs().sum()) for w in p_grads) > 0
    assert torch.equal(k_out.valid, p_out.valid) and int(p_out.valid.sum()) >= 4
    assert float((k_out.boxes - p_out.boxes)[p_out.valid].abs().max()) < 1e-4
