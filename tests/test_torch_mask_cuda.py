"""Mask R-CNN and Keypoint R-CNN on a card: the P=14 FPN pools and the
narrow models against the CPU.

Needs a CUDA card (marker ``cuda``) and skips without one. The file imports no
JAX, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_mask_cuda.py

- K1 (the ``pallas_fast`` patch form with its level bump), K2 and K3 at P=14
  on the four FPN levels of a 4 x 832x1344 canvas (p2-p5, C=256), float32
  and bf16, on boxes from 8 px to the whole canvas, against their plain
  versions on the card (``chip_smoke.check_recorded_pool``: K2 bit-equal,
  K1 and K3 within 1e-5 of the sum of absolute terms, plus 1 bf16 ulp in
  bf16).
- ``chip_smoke.task_heads_phase`` (phase 35): the narrow Mask R-CNN and
  Keypoint R-CNN at float32 with TF32 off on the card and on the CPU, both
  held against a float64 witness on the CPU (losses, gradients, detections,
  masks and keypoints within ``chip_smoke.witness_limit`` of the CPU's own
  distance), and segm evaluation from the card's tensors (oracle masks'
  AP floor, the 3-px shift's AP range, card rows against the CPU's RLE IoU
  >= 0.99).
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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bf16"])
def test_fpn_p14_kernels_match_plain(cuda_device, dtype):
    g = torch.Generator(device="cuda").manual_seed(1)
    B, R, C = 4, 256, 256
    levels = [torch.randn(B, C, h, w, generator=g, device="cuda").to(dtype)
              .contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
              for h, w in chip_smoke.MAIN_SHAPES]
    xy = torch.rand(B, R, 2, generator=g, device="cuda") * torch.tensor([1344.0, 832.0], device="cuda")
    wh = torch.exp(torch.rand(B, R, 2, generator=g, device="cuda") * 5.0) * 8  # 8 .. ~1190 px
    boxes = torch.cat([xy - wh / 2, xy + wh / 2], -1)
    boxes[..., 0::2] = boxes[..., 0::2].clamp(0, 1344)
    boxes[..., 1::2] = boxes[..., 1::2].clamp(0, 832)
    boxes[:, :3] = torch.tensor([[0.0, 0.0, 1344.0, 832.0], [0.0, 780.0, 1344.0, 832.0], [600.0, 400.0, 612.0, 411.0]],
                                device="cuda")
    kw = dict(output_size=14, sampling_ratio=0, max_grid=2, min_level=2)
    gout = torch.randn(B, R, 14, 14, C, generator=g, device="cuda").to(dtype)
    with chip_smoke.PoolRecorder() as rec:
        ra.pool_band(levels, boxes, chip_smoke.STRIDES, patch=True, **kw)
        ra.pool_paired(levels, boxes, chip_smoke.STRIDES, **kw)
        xs = [f.detach().requires_grad_() for f in levels]
        out = ra.pool_paired_train(xs, boxes, chip_smoke.STRIDES, **kw)
        torch.autograd.grad(out, xs, gout)
    assert [len(rec.band), len(rec.fwd), len(rec.bwd)] == [1, 2, 1]
    assert {taps.lvl.unique().numel() for _, taps in rec.fwd} == {4}  # every FPN level holds boxes
    chip_smoke.check_recorded_pool(f"FPN P=14 C=256 {dtype}", rec, "[card test]")


@pytest.mark.cuda
def test_mask_keypoint_card_match_cpu_and_segm_eval(cuda_device):
    chip_smoke.task_heads_phase("[card test]")
