"""The extra ROI heads and the single-level P=14 pools on a card.

Needs a CUDA card (marker ``cuda``) and skips without one. The file imports no
JAX, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_extra_heads_cuda.py

- ``chip_smoke.extra_heads_reference_check`` (phase 25): each extra head,
  the debug inference and the C4 model (on three batches) at float32 with
  TF32 off, on the card and on the CPU, both against a float64 witness on
  the CPU: the card's losses, gradients, boxes and scores within
  ``chip_smoke.witness_limit`` of the CPU's own distance (10x for losses
  and detections, 100x for gradients, at least rel 1e-4, rel L2 1e-4,
  1e-3 px and 1e-4), the K1/K2/K3 launches of each run, and the kernels on
  the C4 runs' own P=14 tensors against their plain versions.
- K1 (band form), K2 and K3 on one res4 level of a 2 x 832x1344 canvas
  (52 x 84, C=1024) at P=14, float32 and bf16, on boxes up to the whole
  canvas and wider than the paired window, against their plain versions on
  the card (``chip_smoke.check_recorded_pool``: K2 bit-equal, K1 and K3
  within 1e-5 of the sum of absolute terms, plus 1 bf16 ulp in bf16).
"""
import pytest
import torch

import chip_smoke
from lvc_tpu_torch.ops import roi_align as ra


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU form")
    chip_smoke.tf32_off()
    return torch.device("cuda")


@pytest.mark.cuda
def test_extra_heads_card_match_cpu(cuda_device):
    chip_smoke.extra_heads_reference_check("[card test]")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bf16"])
def test_single_level_p14_kernels_match_plain(cuda_device, dtype):
    g = torch.Generator(device="cuda").manual_seed(0)
    B, R = 2, 256
    level = torch.randn(B, 1024, 52, 84, generator=g, device="cuda").to(dtype) \
        .contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
    xy = torch.rand(B, R, 2, generator=g, device="cuda") * torch.tensor([1344.0, 832.0], device="cuda")
    wh = torch.exp(torch.rand(B, R, 2, generator=g, device="cuda") * 5.0) * 8  # 8 .. ~1190 px
    boxes = torch.cat([xy - wh / 2, xy + wh / 2], -1)
    boxes[..., 0::2] = boxes[..., 0::2].clamp(0, 1344)
    boxes[..., 1::2] = boxes[..., 1::2].clamp(0, 832)
    boxes[:, :3] = torch.tensor([[0.0, 0.0, 1344.0, 832.0], [0.0, 780.0, 1344.0, 832.0], [5.0, 0.0, 30.0, 832.0]],
                                device="cuda")
    assert int(((boxes[..., 2] - boxes[..., 0]) / 16 > 46).sum()) >= 6  # wider than the paired window
    kw = dict(output_size=14, sampling_ratio=0, max_grid=2, min_level=4)
    gout = torch.randn(B, R, 14, 14, 1024, generator=g, device="cuda").to(dtype)
    with chip_smoke.PoolRecorder() as rec:
        ra.pool_band([level], boxes, (16,), **kw)
        ra.pool_paired([level], boxes, (16,), **kw)
        x = level.detach().requires_grad_()
        out = ra.pool_paired_train([x], boxes, (16,), **kw)
        torch.autograd.grad(out, [x], gout)
    assert [len(rec.band), len(rec.fwd), len(rec.bwd)] == [1, 2, 1]
    chip_smoke.check_recorded_pool(f"single-level P=14 C=1024 {dtype}", rec, "[card test]")
