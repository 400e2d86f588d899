"""RetinaNet, the semantic FPN and Panoptic FPN on a card: the narrow models
against the CPU and a float64 witness, Panoptic FPN's pools, and the
Cityscapes evaluators from the card's tensors.

Needs a CUDA card (marker ``cuda``) and skips without one. The file imports no
JAX, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_dense_cuda.py

- ``chip_smoke.dense_reference_check`` (phase 39a) for each model: float32
  with TF32 off on the card and on the CPU, each held to its float64
  witness (losses, gradients, detections, masks, semantic logits within
  ``chip_smoke.witness_limit`` of the CPU's own distance); K2/K3 2/2 a step
  and 0/2 an eval forward for Panoptic FPN, none for the others.
- The narrow Panoptic FPN's pools with ``pallas_fast`` (K1 at P=7 and P=14)
  and in a ``pallas_train`` step (K2, K3), on the path's own tensors, against
  their plain versions (``chip_smoke.check_recorded_pool``).
- ``chip_smoke.cityscapes_check`` (phase 39b): oracle boxes AP 100, moved
  3 px inside ``CITYSCAPES_SHIFTED_AP``, oracle labelIds mIoU 100.
"""
import pytest
import torch

import chip_smoke


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU form")
    chip_smoke.tf32_off()
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["retinanet", "semantic", "panoptic"])
def test_dense_card_and_cpu_match_float64(cuda_device, kind):
    chip_smoke.dense_reference_check("[card test]", kinds=(kind,))


@pytest.mark.cuda
def test_panoptic_pools_match_plain(cuda_device):
    from lvc_tpu_torch.engine.train_loop import make_train_step
    from lvc_tpu_torch.modeling.meta_arch.build import build_model
    from lvc_tpu_torch.solver.build import build_lr_schedule, build_optimizer

    batch = chip_smoke.dense_batch(2, 256, 384, 6, seed=1, device="cuda", num_classes=5, sem_classes=7, n_gt=(2, 6),
                                   size=(16, 200))
    for impl in ("pallas_fast", "pallas_train"):
        cfg = chip_smoke.dense_reference_cfg("panoptic", "cuda")
        cfg.MODEL.ROI_HEADS.POOLER_IMPL = impl
        model = build_model(cfg)
        chip_smoke.calibrated_init(model, seed=0)
        with chip_smoke.PoolRecorder() as rec:
            if impl == "pallas_fast":
                model(batch)
            else:
                opt = build_optimizer(cfg, model.train())
                make_train_step(model, opt, build_lr_schedule(cfg, opt))(batch, torch.Generator().manual_seed(0))
        want = [2, 0, 0] if impl == "pallas_fast" else [0, 2, 2]
        assert [len(rec.band), len(rec.fwd), len(rec.bwd)] == want
        assert sorted(c[1].rows.shape[1] for c in rec.band + rec.fwd) == [7, 14]
        chip_smoke.check_recorded_pool(f"narrow Panoptic FPN {impl}", rec, "[card test]")


@pytest.mark.cuda
def test_cityscapes_evaluators_from_card(cuda_device):
    chip_smoke.cityscapes_check("[card test]")
