"""The VOC evaluator on card detections and the context detector's step on a
card.

Needs a CUDA card (marker ``cuda``) and skips without one. The file imports no
JAX, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_voc_cuda.py

- ``chip_smoke.voc_card_evaluation``: a narrow detector's detections made
  on the card over a seeded VOC 2007 test split against the same model's on
  the CPU (validity and class equal, boxes 1e-3 px, scores 1e-4), one K2
  launch a batch, and ``PascalVOCDetectionEvaluator`` fed the card's
  tensors within 0.1 AP points of the CPU's results.
- ``chip_smoke.context_reference_check`` (phase 31): one train step of a
  narrow ``GeneralizedRCNN_Context`` at float32 with TF32 off on the card
  and on the CPU (losses rel 1e-4, gradients rel L2 1e-4, ``image_scores``
  1e-5, K2/K3 1/1), then K2 and K3 on the card step's own tensors against
  their plain versions (``chip_smoke.check_recorded_pool``: K2 bit-equal,
  K3 within 1e-5 of the sum of absolute terms, two calls bit-equal).
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
def test_voc_evaluator_on_card_detections(cuda_device):
    chip_smoke.voc_card_evaluation("[card test]")


@pytest.mark.cuda
def test_context_step_card_matches_cpu_and_kernels_match_plain(cuda_device):
    chip_smoke.context_reference_check("[card test]")
