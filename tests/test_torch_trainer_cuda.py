"""The port's ``DefaultTrainer`` on a card against the same trainer on the CPU.

Needs a CUDA card (marker ``cuda``) and skips without one. The file imports no
JAX, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_trainer_cuda.py

It runs ``chip_smoke.trainer_reference_check``: a narrow R-50-FPN trained 3
iterations at float32 with POOLER_IMPL pallas_train (K2 and K3 on the card,
their plain versions on the CPU) on a seeded mini COCO tree, then evaluated;
the losses, the ``metrics.json`` rows, the result rows and the AP agree within
the tolerances that function states.
"""
import pytest
import torch

import chip_smoke


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU form")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_trainer_on_card_matches_cpu(cuda_device):
    chip_smoke.trainer_reference_check(f"[{torch.cuda.get_device_name(0)}]")
