"""The port's CUDA kernels against their plain versions, on a card.

Every test here needs a CUDA card (marker ``cuda``) and skips without one.
The file imports no JAX, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py

The forward kernels (K1, K2) sum in their plain version's order and forbid
FMA contraction, so they must agree bit for bit, in float32 and in bf16. The
backward kernel (K3) adds with float32 atomics in no fixed order, so each
accumulator element must be within 1e-5 * S of the plain backward, where S
is the plain backward run on |gout| and |weights| (the absolute sum of the
element's contributions); after the cast to bf16, within 1 bf16 ulp of the
plain version's cast plus that float32 tolerance (a sum that cancels to near
0 has an ulp below the float32 error). The attention kernel is held to its
plain version as its test says.
"""
import numpy as np
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


def _paired(feats, boxes, strides, dtype, device):
    shapes = [f.shape[1:3] for f in feats]
    prep = tra.tiled_prep_2d(shapes, feats[0].shape[0], torch.from_numpy(boxes).to(device), strides, dtype=dtype)
    return tra.paired_taps(prep, shapes, 48)


def _abs_sum(level_shapes, taps, gout):
    """S: the plain backward on |gout| and |weights|."""
    return tra.roi_align_taps_plain_backward(
        level_shapes, taps._replace(wy=taps.wy.abs(), wx=taps.wx.abs()), gout.abs()
    )


def _bf16_ulp(x):
    return torch.exp2(torch.floor(torch.log2(x.abs().clamp(min=2.0 ** -126))) - 7)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_backward_kernel_matches_plain_on_card(cuda_device, case, dtype):
    feats, boxes, strides = CASES[case]()
    dt = getattr(torch, dtype)
    taps = _paired(feats, boxes, strides, dt, cuda_device)
    n, P, _ = taps.rows.shape
    level_shapes = [f.shape for f in feats]
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    gout = torch.randn(n, P, P, feats[0].shape[-1], generator=gen, device=cuda_device).to(dt)
    before = tra.roi_align_paired_bwd.launches
    got = tra.roi_align_paired_bwd(level_shapes, taps, gout)
    torch.cuda.synchronize()
    assert tra.roi_align_paired_bwd.launches == before + 1
    want = tra.roi_align_taps_plain_backward(level_shapes, taps, gout)
    for g, w, s in zip(got, want, _abs_sum(level_shapes, taps, gout)):
        assert g.dtype == torch.float32 and g.shape == w.shape
        assert bool(((g - w).abs() <= 1e-5 * s).all())
        cast, ref = g.to(torch.bfloat16).float(), w.to(torch.bfloat16).float()
        assert bool(((cast - ref).abs() <= _bf16_ulp(ref) + 1e-5 * s).all())


@pytest.mark.cuda
def test_train_pool_on_card_matches_cpu(cuda_device):
    """The autograd Function (K2 forward, K3 backward) on the card against
    the same Function on the CPU (plain versions), float32: the forward to
    1e-6, the feature grads to 1e-5 * S."""
    feats, boxes, strides = CASES["pyramid"]()
    gout = torch.from_numpy(np.random.RandomState(1).randn(*boxes.shape[:2], 7, 7, feats[0].shape[-1]).astype(np.float32))
    res = {}
    for dev in ("cpu", cuda_device):
        levels = [torch.from_numpy(f).to(dev).requires_grad_() for f in feats]
        out = tra.pool_paired_train(levels, torch.from_numpy(boxes).to(dev), strides)
        grads = torch.autograd.grad(out, levels, gout.to(dev))
        res[str(dev)] = out.detach().cpu(), [g.cpu() for g in grads]
    before = _launches()
    levels = [torch.from_numpy(f).to(cuda_device).requires_grad_() for f in feats]
    tra.pool_paired_train(levels, torch.from_numpy(boxes).to(cuda_device), strides).sum().backward()
    torch.cuda.synchronize()
    assert _launches() == (before[0] + 1, before[1] + 1)
    (want_out, want_g), (got_out, got_g) = res["cpu"], res[str(cuda_device)]
    torch.testing.assert_close(got_out, want_out, atol=1e-6, rtol=0)
    taps = _paired(feats, boxes, strides, torch.float32, "cpu")
    S = _abs_sum([f.shape for f in feats], taps, gout.reshape(-1, 7, 7, gout.shape[-1]))
    for g, w, s in zip(got_g, want_g, S):
        assert bool(((g - w).abs() <= 1e-5 * s).all())


def _launches():
    return tra.roi_align_paired.launches, tra.roi_align_paired_bwd.launches


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


def test_cuda_gout_never_takes_the_plain_backward(monkeypatch):
    """The backward wrapper too: a CUDA gout launches K3 or raises."""
    from lvc_tpu_torch.ops import _build

    feats, boxes, strides = CASES["pyramid"]()
    taps = _paired(feats, boxes, strides, torch.float32, "cpu")
    gout = torch.zeros(taps.rows.shape[0], 7, 7, feats[0].shape[-1])

    class FakeCuda:
        type = "cuda"

    def refuse(name="roi_align_bwd"):
        raise RuntimeError("no kernel library")

    monkeypatch.setattr(_build, "load_library", refuse)
    monkeypatch.setattr(tra.RoiAlignBackwardKernel, "_check", staticmethod(lambda *a: None))
    with pytest.raises(RuntimeError, match="no kernel library"):
        tra.roi_align_paired_bwd([f.shape for f in feats], taps, _DeviceView(gout, FakeCuda()))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["mild", "peaked"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N", [785, 768], ids=["tail", "aligned"])
def test_flash_attention_matches_plain_on_card(cuda_device, N, dtype, case):
    """The attention kernel against its plain version on the qkv Linear's
    output layout: float32 within 1e-5 max abs; bf16 within 2 bf16 ulps of
    the largest |out| of each (batch, head) (the kernel casts exp(s - running
    max) to bf16, the plain version exp(s - max)). "peaked" is
    ``chip_smoke.peaked``: logits that span tens, with the running max
    jumping late in the row."""
    from chip_smoke import peaked
    from lvc_tpu_torch.ops.attention import flash_attention, flash_attention_plain

    B, H, d = 2, 6, 64
    g = torch.Generator(device=cuda_device).manual_seed(N)
    qkv = (torch.randn(B, N, 3 * H * d, generator=g, device=cuda_device) * 0.5).view(B, N, 3, H, d)
    if case == "peaked":
        qkv = peaked(qkv)
    qkv = qkv.to(getattr(torch, dtype))
    before = flash_attention.launches
    got = flash_attention(qkv, d ** -0.5)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert got.shape == (B, N, H * d) and got.dtype == qkv.dtype
    want = flash_attention_plain(qkv, d ** -0.5).float()
    err = (got.float() - want).abs()
    if dtype == "float32":
        assert float(err.max()) <= 1e-5
    else:
        mx = want.abs().view(B, N, H, d).amax(dim=(1, 3))
        ulp = torch.exp2(torch.floor(torch.log2(mx)) - 7)
        assert bool((err.view(B, N, H, d).amax(dim=(1, 3)) <= 2 * ulp).all())


def test_cuda_qkv_never_takes_the_plain_attention(monkeypatch):
    """A CUDA qkv launches the attention kernel or raises."""
    from lvc_tpu_torch.ops import _build
    from lvc_tpu_torch.ops.attention import flash_attention

    class FakeCuda:
        type = "cuda"

    def refuse(name="flash_attention_fwd"):
        raise RuntimeError("no kernel library")

    monkeypatch.setattr(_build, "load_library", refuse)
    qkv = _DeviceView(torch.zeros(1, 8, 3, 2, 64), FakeCuda())
    with pytest.raises(RuntimeError, match="no kernel library"):
        flash_attention(qkv, 0.125)
