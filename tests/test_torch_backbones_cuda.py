"""The alternative backbones and the rotated heads on a card: the narrow
Swin-FPN, ResNet-D (with the CLIP optimizer), DCN v1 and v2 detectors and
the narrow ``RROIHeads`` against the CPU and a float64 witness, and the
narrow Swin-FPN's serving pools against their plain versions.

Needs a CUDA card (marker ``cuda``) and skips without one. The file imports no
JAX, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_backbones_cuda.py

- ``chip_smoke.variant_reference_check`` (phase 44) for each detector:
  float32 with TF32 off on the card and on the CPU, each held to its float64
  witness (losses, gradients, detections within ``chip_smoke.witness_limit``
  of the CPU's own distance); K2/K3 1/1 a step and K2 1 an eval forward.
- ``chip_smoke.rroi_reference_check`` (phase 44b): the same for ``RROIHeads``
  (losses, the gradients of every parameter and of the features, 5-dim
  detections); no kernel.
- A narrow bf16 Swin-FPN serving forward with POOLER_IMPL pallas_fast and
  with pallas on the card: K1 and K2 on the forward's own tensors against
  their plain versions (``chip_smoke.check_recorded_pool``).
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
@pytest.mark.parametrize("kind", ["swin", "resnet_d", "dcn", "dcn_v2"])
def test_variant_card_and_cpu_match_float64(cuda_device, kind):
    chip_smoke.variant_reference_check("[card test]", kinds=(kind,), rotated=False)


@pytest.mark.cuda
def test_rroi_heads_card_and_cpu_match_float64(cuda_device):
    chip_smoke.rroi_reference_check("[card test]")


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["pallas_fast", "pallas"])
def test_swin_serving_pools_match_plain(cuda_device, impl):
    from lvc_tpu_torch.modeling.meta_arch.build import build_model
    from lvc_tpu_torch.utils.init import damped_init

    cfg = chip_smoke.variant_reference_cfg("swin", "cuda")
    cfg.MODEL.ROI_HEADS.POOLER_IMPL = impl
    cfg.MODEL.DTYPE = "bfloat16"
    model = damped_init(build_model(cfg), seed=0)
    batch = chip_smoke.train_batch(2, 128, 192, 4, seed=3, device="cuda", num_classes=5, n_gt=(3, 3),
                                   size=(24, 100))
    rec = chip_smoke.PoolRecorder()
    with rec, torch.no_grad():
        model({k: batch[k] for k in ("image", "image_size")})
    assert len(rec.band if impl == "pallas_fast" else rec.fwd) == 1
    chip_smoke.check_recorded_pool(f"swin serving {impl} (narrow, bf16)", rec, "[card test]")
