"""The port's CUDA kernels against their plain versions, on a card.

Every test here needs a CUDA card (marker ``cuda``) and skips without one.
The file imports no JAX, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py

The forward kernels (K1, K2) sum in their plain version's order and forbid
FMA contraction, so they must agree bit for bit, in float32 and in bf16. The
backward kernel (K3) returns the gradients in gout's dtype. Against the plain
backward on the card (whose index_add_ adds in no fixed order): float32
within 1e-5 * S, where S is the plain backward run on |gout| and |weights|
(the absolute sum of the element's contributions); bf16 within 1 bf16 ulp of
the plain version's cast plus that float32 tolerance (a sum that cancels to
near 0 has an ulp below the float32 error). K3 sums in the plain version's
CPU order, so in float32 it equals the plain version run on the CPU bit for
bit, and two calls give the same bits. The attention kernel is held to its
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


def _edges():
    """Three images on two levels whose sides are not multiples of the
    backward kernel's 8 x 32 tiles; boxes on tile borders and over the last
    rows and columns, on both levels; 8 boxes per image (n = 24)."""
    rng = np.random.RandomState(17)
    B, C = 3, 32
    feats = [rng.rand(B, h, w, C).astype(np.float32) for h, w in [(44, 76), (22, 38)]]
    boxes = np.array([
        [0.0, 0.0, 130.0, 34.0], [120.0, 26.0, 140.0, 38.0], [240.0, 150.0, 304.0, 176.0],
        [290.0, 160.0, 304.0, 176.0], [0.0, 168.0, 60.0, 176.0], [126.0, 0.0, 130.0, 176.0],
        [70.0, 20.0, 300.0, 170.0], [60.0, 60.0, 60.0, 60.0],
    ], np.float32)
    boxes = np.stack([boxes + rng.uniform(-1.0, 1.0, boxes.shape).astype(np.float32) * (b > 0)
                      for b in range(B)]).clip(0.0, [304.0, 176.0, 304.0, 176.0]).astype(np.float32)
    return feats, boxes, (4, 8)


def _single_level():
    feats, boxes, strides = CASES["wide"]()
    return feats[:1], boxes, strides[:1]


BACKWARD_CASES = {**CASES, "edges": _edges, "single_level": _single_level}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(BACKWARD_CASES))
def test_backward_kernel_matches_plain_on_card(cuda_device, case, dtype):
    feats, boxes, strides = BACKWARD_CASES[case]()
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
        assert g.dtype == dt and g.shape == w.shape
        if dt == torch.float32:
            assert bool(((g - w).abs() <= 1e-5 * s).all())
        else:
            ref = w.to(torch.bfloat16).float()
            assert bool(((g.float() - ref).abs() <= _bf16_ulp(ref) + 1e-5 * s).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(BACKWARD_CASES))
def test_backward_kernel_is_deterministic_and_keeps_the_cpu_order(cuda_device, case, dtype):
    """Two calls give the same bits, and the result is the plain version's
    float32 sums on the CPU (same terms, same order), cast once to gout's
    dtype, bit for bit; levels no box reaches come back as zeros."""
    feats, boxes, strides = BACKWARD_CASES[case]()
    dt = getattr(torch, dtype)
    taps = _paired(feats, boxes, strides, dt, cuda_device)
    n, P, _ = taps.rows.shape
    level_shapes = [f.shape for f in feats]
    gout = torch.from_numpy(np.random.RandomState(2).randn(n, P, P, feats[0].shape[-1]).astype(np.float32)).to(dt)
    first = tra.roi_align_paired_bwd(level_shapes, taps, gout.to(cuda_device))
    second = tra.roi_align_paired_bwd(level_shapes, taps, gout.to(cuda_device))
    cpu = tra.roi_align_taps_plain_backward(level_shapes, tra.RoiTaps(*[t.cpu() for t in taps]), gout)
    bits = torch.int32 if dt == torch.float32 else torch.int16
    for a, b, w in zip(first, second, cpu):
        assert torch.equal(a.view(bits), b.view(bits))
        assert torch.equal(a.cpu().view(bits), w.to(dt).view(bits))
        if not bool(w.any()):
            assert not bool(a.any())
    assert any(not bool(w.any()) for w in cpu) == (case == "pyramid")


@pytest.mark.cuda
def test_kernels_take_a_window_over_the_default_shared_memory(cuda_device):
    """P = 14 (56 row and 56 column taps a box): the forward's window needs
    more than its default 48 KB, and K3 ballots its taps in two words."""
    feats, boxes, strides = CASES["pyramid"]()
    shapes = [f.shape[1:3] for f in feats]
    levels = [torch.from_numpy(f).to(cuda_device) for f in feats]
    taps = tra.paired_taps(tra.tiled_prep_2d(
        shapes, feats[0].shape[0], torch.from_numpy(boxes).to(cuda_device), strides, output_size=14), shapes, 48)
    assert taps.rows.shape[1] * taps.rows.shape[2] == 56
    got = tra.roi_align_paired(levels, taps)
    assert torch.equal(got, tra.roi_align_taps_plain(levels, taps, paired=True))
    n = taps.rows.shape[0]
    gout = torch.from_numpy(np.random.RandomState(3).randn(n, 14, 14, feats[0].shape[-1]).astype(np.float32))
    grads = tra.roi_align_paired_bwd([f.shape for f in feats], taps, gout.to(cuda_device))
    want = tra.roi_align_taps_plain_backward([f.shape for f in feats], tra.RoiTaps(*[t.cpu() for t in taps]), gout)
    for a, w in zip(grads, want):
        assert torch.equal(a.cpu().view(torch.int32), w.view(torch.int32))


@pytest.mark.cuda
def test_forward_rejects_a_window_over_its_shared_memory(cuda_device):
    """P = 16 with 8 row and 8 column taps: the largest window would need
    more shared memory than a block has, so the kernel's launcher refuses it
    (cudaErrorInvalidValue) and the wrapper raises; nothing is launched."""
    n, P, NR, NT, C = 2, 16, 8, 8, 32
    levels = [torch.zeros(1, 40, 40, C, device=cuda_device)]
    z = lambda *s, dt=torch.int32: torch.zeros(*s, dtype=dt, device=cuda_device)
    taps = tra.RoiTaps(z(n), z(n), z(n, dt=torch.float32) + 1, z(n, P, NR), z(n, P, NR, dt=torch.float32),
                       z(n, P, NT), z(n, P, NT, dt=torch.float32))
    before = tra.roi_align_paired.launches
    with pytest.raises(RuntimeError, match="CUDA error 1 at launch"):
        tra.roi_align_paired(levels, taps)
    torch.cuda.synchronize()
    assert tra.roi_align_paired.launches == before


@pytest.mark.parametrize("shape", [(2, 0, 8, 16), (2, 8, 0, 16)], ids=["no_rows", "no_columns"])
def test_backward_rejects_an_empty_level(shape):
    """K3 tiles every level: a level with no rows or no columns is refused
    before any launch, on any device."""
    feats, boxes, strides = CASES["pyramid"]()
    taps = _paired(feats, boxes, strides, torch.float32, "cpu")
    gout = torch.zeros(taps.rows.shape[0], 7, 7, 16)
    with pytest.raises(ValueError, match="empty"):
        tra.roi_align_paired_bwd([(2, 32, 48, 16), shape], taps, gout)


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


def _qkv_on_card(B, N, H, d, case, dtype, layout, device, seed):
    """(B, N, 3, H, d) qkv with N(0, 0.25) entries, peaked or not
    (``chip_smoke.peaked``), in ``dtype``: "packed" is the qkv Linear's
    output viewed in place; "strided" reads q, k, v out of a wider
    (B, 3, N, H * d + 64) buffer at element 64, so every stride differs from
    the packed one."""
    from chip_smoke import peaked

    g = torch.Generator(device=device).manual_seed(seed)
    qkv = (torch.randn(B, N, 3 * H * d, generator=g, device=device) * 0.5).view(B, N, 3, H, d)
    if case == "peaked":
        qkv = peaked(qkv)
    if layout == "packed":
        return qkv.to(dtype)
    buf = torch.zeros(B, 3, N, H * d + 64, dtype=dtype, device=device)
    view = buf[..., 64:64 + H * d].unflatten(-1, (H, d)).transpose(1, 2)
    view.copy_(qkv)
    return view


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["packed", "strided"])
@pytest.mark.parametrize("case", ["mild", "peaked"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N", [1, 17, 63, 64, 65, 128, 768, 785, 1300])
def test_flash_attention_matches_plain_on_card(cuda_device, N, dtype, case, layout):
    """The attention kernel against its plain version at the tile edges (64
    keys and 64 queries per tile: N of 1, 17, 63, 64, 65, 128, 768 = 12
    tiles, 785 = 12 tiles + 17, and 1300, past the JAX package's switch to
    the einsum form at 1280, which the port's kernel keeps), on the qkv
    Linear's layout and on a strided one: float32 within 1e-5 max abs; bf16
    within 2 bf16 ulps of the largest |out| of each (batch, head) (the kernel
    casts exp(s - running max) to bf16, the plain version exp(s - max)).
    "peaked" is ``chip_smoke.peaked``: logits that span tens, with the
    running max jumping late in the row."""
    from lvc_tpu_torch.ops.attention import flash_attention, flash_attention_plain

    B, H, d = 2, 6, 64
    qkv = _qkv_on_card(B, N, H, d, case, getattr(torch, dtype), layout, cuda_device, seed=N)
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


def _fused_inputs(M, K, N, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(M, K, generator=g, device=device).to(torch.bfloat16)
    w = (torch.randn(N, K, generator=g, device=device) * K ** -0.5).to(torch.bfloat16)
    scale = torch.rand(N, generator=g, device=device) + 0.5
    shift = torch.randn(N, generator=g, device=device)
    res = torch.randn(M, N, generator=g, device=device).to(torch.bfloat16)
    return x, w.t(), scale, shift, res


def _fused_within_tolerance(got, want, x, w_kn, scale, shift, res):
    """1 bf16 ulp of the plain result plus 1e-5 * S per element, S =
    |x| @ |w| * |scale| + |shift| + |res| (``chip_smoke.fused_error``)."""
    S = (x.float().abs() @ w_kn.float().abs()) * scale.abs() + shift.abs() + res.float().abs()
    err = (got.float() - want.float()).abs()
    return bool((err <= _bf16_ulp(want.float()) + 1e-5 * S).all())


# (M, K, N): ragged M (1, 63, 1,000, 8,736 + 5), K 64 and 1,024, N 256 and
# 2,048, and 128 x 256 tile counts that are (132, 264) and are not (1, 69,
# 1,092, 552) a multiple of the H100's 132 SMs, which the persistent grid walks
FUSED_CASES = {
    "m1": (1, 64, 256),
    "m63": (63, 64, 256),
    "ragged": (1000, 64, 256),
    "m8741": (8736 + 5, 64, 256),
    "res4_conv3": (34944, 256, 1024),
    "res5_conv3": (8736, 512, 2048),
    "k1024_n2048": (1000, 1024, 2048),
    "lateral_p4": (34944, 1024, 256),
    "tiles132": (132 * 128, 64, 256),
    "tiles264": (66 * 128, 128, 1024),
    "k_n_tails": (4096, 72, 264),
}


@pytest.mark.cuda
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("shape", list(FUSED_CASES.values()), ids=list(FUSED_CASES))
def test_fused_matmul_matches_plain_on_card(cuda_device, shape, relu):
    """The fused GEMM kernel against its plain version: 1 bf16 ulp + 1e-5 * S
    per element (the float32 sums run in other orders; where a sum cancels
    towards 0 they differ by more than the small result's own ulp)."""
    from lvc_tpu_torch.ops.fused_matmul import matmul_affine_residual, matmul_affine_residual_plain

    args = _fused_inputs(*shape, cuda_device)
    before = matmul_affine_residual.launches
    got = matmul_affine_residual(*args, relu=relu)
    torch.cuda.synchronize()
    assert matmul_affine_residual.launches == before + 1
    assert got.shape == (shape[0], shape[2]) and got.dtype == torch.bfloat16
    assert _fused_within_tolerance(got, matmul_affine_residual_plain(*args, relu=relu), *args)


@pytest.mark.cuda
def test_fused_matmul_back_to_back_shapes_on_card(cuda_device):
    """Launches in a row on different shapes over the same buffers (rows of
    one x and residual, a narrower weight): each output is right, so no
    launch reuses another's tensor maps."""
    from lvc_tpu_torch.ops.fused_matmul import matmul_affine_residual, matmul_affine_residual_plain

    x, w_kn, scale, shift, res = _fused_inputs(4096, 256, 512, cuda_device, seed=3)
    calls = [(4096, 512), (1000, 512), (4096, 256), (4096, 512), (1, 512), (1000, 256)]
    for rows, n in calls:
        # a narrower weight and residual are copies: the kernel takes them contiguous
        w = w_kn if n == 512 else w_kn[:, :n].t().contiguous().t()
        r = res[:rows] if n == 512 else res[:rows, :n].contiguous()
        args = (x[:rows], w, scale[:n], shift[:n], r)
        got = matmul_affine_residual(*args, relu=True)
        torch.cuda.synchronize()
        assert got.shape == (rows, n)
        assert _fused_within_tolerance(got, matmul_affine_residual_plain(*args, relu=True), *args), (rows, n)


@pytest.mark.cuda
def test_fused_function_on_card_matches_cpu(cuda_device):
    """MatmulAffineResidualFn on the card (kernel forward, cuBLAS bf16
    products in the backward) against the same Function on the CPU (plain
    forward, CPU products) from the same bf16 inputs: the output within the
    kernel's tolerance, each gradient within rel L2 5e-3 (bf16 results of
    float32 sums in other orders: about 1e-3)."""
    from lvc_tpu_torch.ops.fused_matmul import MatmulAffineResidualFn

    cpu_args = _fused_inputs(4096, 256, 512, "cpu", seed=1)
    cot = torch.randn(4096, 512, generator=torch.Generator().manual_seed(2))
    out = {}
    for dev in ("cpu", cuda_device):
        ts = [t.detach().to(dev).requires_grad_() for t in cpu_args]
        y = MatmulAffineResidualFn.apply(*ts, True)
        (y.float() * cot.to(dev)).sum().backward()
        out[str(dev)] = y.detach().cpu(), [t.grad.cpu() for t in ts]
    (y_c, g_c), (y_g, g_g) = out["cpu"], out[str(cuda_device)]
    assert _fused_within_tolerance(y_g, y_c, *cpu_args)
    for name, a, b in zip(("dx", "dw", "dscale", "dshift", "dres"), g_g, g_c):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        rel = float((a.double() - b.double()).norm() / b.double().norm())
        assert rel <= 5e-3, (name, rel)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_cuda_x_never_takes_the_plain_fused_matmul(monkeypatch, dtype):
    """A CUDA x launches the fused kernel or raises: a bf16 one with no
    library to load raises, and a float32 one, which the kernel does not
    take, raises before the library is asked for."""
    from lvc_tpu_torch.ops import _build
    from lvc_tpu_torch.ops.fused_matmul import matmul_affine_residual

    class FakeCuda:
        type = "cuda"

    def refuse(name="fused_matmul"):
        raise RuntimeError("no kernel library")

    monkeypatch.setattr(_build, "load_library", refuse)
    dt = getattr(torch, dtype)
    x = _DeviceView(torch.zeros(16, 64, dtype=dt), FakeCuda())
    w, res = torch.zeros(32, 64, dtype=dt).t(), torch.zeros(16, 32, dtype=dt)
    with pytest.raises(RuntimeError if dtype == "bfloat16" else TypeError):
        matmul_affine_residual(x, w, torch.ones(32), torch.zeros(32), res)
