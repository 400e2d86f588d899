"""The port's CUDA kernels against their plain versions, on a card.

Every test here needs a CUDA card (marker ``cuda``) and skips without one.
The file imports no JAX, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py

The kernels sum in their plain version's order and forbid FMA contraction,
so they must agree bit for bit, in float32 and in bf16.
"""
import pytest
import torch

from lvc_tpu_torch.ops import roi_align as tra
from test_torch_roi_cases import CASES


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU form")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernels_match_plain_on_card(cuda_device, case, dtype):
    feats, boxes, strides = CASES[case]()
    dt = getattr(torch, dtype)
    tfeats = [torch.from_numpy(f).to(cuda_device, dt) for f in feats]
    tboxes = torch.from_numpy(boxes).to(cuda_device)
    shapes = [f.shape[1:3] for f in feats]
    B = feats[0].shape[0]
    band = tra.band_taps(tra.tiled_prep_band(shapes, B, tboxes, strides, dtype=dt), shapes, B, 32, True)
    paired = tra.paired_taps(tra.tiled_prep_2d(shapes, B, tboxes, strides, dtype=dt), shapes, 48)
    for kernel, taps in [(tra.roi_align_band, band), (tra.roi_align_paired, paired)]:
        before = kernel.launches
        got = kernel(tfeats, taps)
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
        want = tra.roi_align_taps_plain(tfeats, taps, kernel.paired)
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_taps_on_card_equal_cpu(cuda_device, case):
    """The preps on the card give the CPU's rows, columns and weights bit for
    bit. (A division by a Python scalar on CUDA is a multiply by its
    reciprocal, 1 ulp off; the preps divide by device tensors instead.)"""
    feats, boxes, strides = CASES[case]()
    shapes = [f.shape[1:3] for f in feats]
    B = feats[0].shape[0]
    cpu_b, gpu_b = torch.from_numpy(boxes), torch.from_numpy(boxes).to(cuda_device)
    for make in (
        lambda bx: tra.band_taps(tra.tiled_prep_band(shapes, B, bx, strides), shapes, B, 32, True),
        lambda bx: tra.band_taps(tra.tiled_prep_band(shapes, B, bx, strides, patch=False), shapes, B, 32, False),
        lambda bx: tra.paired_taps(tra.tiled_prep_2d(shapes, B, bx, strides), shapes, 48),
    ):
        want, got = make(cpu_b), make(gpu_b)
        for name in want._fields:
            assert torch.equal(getattr(got, name).cpu(), getattr(want, name)), name


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["pallas_fast", "pallas_band", "pallas"])
def test_pools_on_card_match_cpu(cuda_device, impl):
    """The whole pool (torch prep + kernel) on the card against the same pool
    on the CPU (prep + plain version), float32: the preps agree bit for bit
    (test above) and the kernel sums in the plain version's order, so the
    outputs agree to 1e-6."""
    feats, boxes, strides = CASES["pyramid"]()
    cpu = [torch.from_numpy(f) for f in feats]
    gpu = [f.to(cuda_device) for f in cpu]
    b = torch.from_numpy(boxes)
    if impl == "pallas":
        want, got = tra.pool_paired(cpu, b, strides), tra.pool_paired(gpu, b.to(cuda_device), strides)
    else:
        patch = impl == "pallas_fast"
        want = tra.pool_band(cpu, b, strides, patch=patch)
        got = tra.pool_band(gpu, b.to(cuda_device), strides, patch=patch)
    torch.testing.assert_close(got.cpu(), want, atol=1e-6, rtol=0)


def test_cuda_tensor_never_takes_the_plain_version(monkeypatch):
    """A CUDA tensor launches the kernel or raises: with no library to load,
    the wrapper raises instead of falling back to torch ops."""
    from lvc_tpu_torch.ops import _build

    feats, boxes, strides = CASES["pyramid"]()
    shapes = [f.shape[1:3] for f in feats]
    taps = tra.paired_taps(tra.tiled_prep_2d(shapes, 2, torch.from_numpy(boxes), strides), shapes, 48)

    class FakeCuda:
        type = "cuda"

    def refuse(name="roi_align_fwd"):
        raise RuntimeError("no kernel library")

    monkeypatch.setattr(_build, "load_library", refuse)
    levels = [torch.from_numpy(f) for f in feats]
    monkeypatch.setattr(tra.RoiAlignKernel, "_check", staticmethod(lambda levels, taps: None))
    fake = [_DeviceView(f, FakeCuda()) for f in levels]
    with pytest.raises(RuntimeError, match="no kernel library"):
        tra.roi_align_paired(fake, taps)


class _DeviceView:
    """A CPU tensor stand-in that reports a CUDA device."""

    def __init__(self, t, device):
        self._t, self.device = t, device

    def __getattr__(self, name):
        return getattr(self._t, name)
