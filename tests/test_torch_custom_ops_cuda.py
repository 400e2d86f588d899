"""The custom ops of the hand kernels on a card (marker ``cuda``; skipped
without one). The file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_custom_ops_cuda.py

Each op called on CUDA tensors launches its kernel (the wrapper's count goes
up by one) and is held against the kernel's plain version with the kernel's
own tolerance (``test_torch_kernels_cuda.py``): K1 and K2 bit for bit, the
fused GEMM 1 bf16 ulp + 1e-5 * S, the attention 1e-5 (float32) or 2 bf16
ulps of each (batch, head)'s largest output. The narrow detector exported on
the card with ``pallas_fast`` launches K1 from the exported program and its
detections equal the eager forward's on the card bit for bit. Each op, and a
loaded fused program, refuses on the card what its kernel does not take (a
layout or a dtype that a trace's guards let through) before any launch.
"""
import os

import pytest
import torch

from lvc_tpu_torch.export import export_model, load_exported, save_exported
from lvc_tpu_torch.ops import attention, fused_matmul
from lvc_tpu_torch.ops import roi_align as ra
from test_torch_kernels_cuda import _fused_inputs, _fused_within_tolerance, cuda_device  # noqa: F401
from test_torch_roi_cases import CASES

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kernel", ["roi_align_band", "roi_align_paired"])
def test_roi_align_ops_on_card(cuda_device, kernel, dtype):
    feats, boxes, strides = CASES["pyramid"]()
    dt = getattr(torch, dtype)
    levels = [torch.from_numpy(f).to(cuda_device, dt) for f in feats]
    tboxes = torch.from_numpy(boxes).to(cuda_device)
    shapes = [f.shape[1:3] for f in feats]
    B = feats[0].shape[0]
    wrapper = getattr(ra, kernel)
    if wrapper.paired:
        taps = ra.paired_taps(ra.tiled_prep_2d(shapes, B, tboxes, strides, dtype=dt), shapes, 48)
    else:
        taps = ra.band_taps(ra.tiled_prep_band(shapes, B, tboxes, strides, dtype=dt), shapes, B, 32, True)
    before = wrapper.launches
    got = getattr(torch.ops.lvc_tpu_torch, wrapper.symbol)(levels, *taps)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    assert torch.equal(got, ra.roi_align_taps_plain(levels, taps, wrapper.paired))


def test_fused_matmul_op_on_card(cuda_device):
    args = _fused_inputs(4096, 256, 512, cuda_device, seed=5)
    before = fused_matmul.matmul_affine_residual.launches
    got = torch.ops.lvc_tpu_torch.matmul_affine_residual(*args, True)
    torch.cuda.synchronize()
    assert fused_matmul.matmul_affine_residual.launches == before + 1
    assert _fused_within_tolerance(got, fused_matmul.matmul_affine_residual_plain(*args, relu=True), *args)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_op_on_card(cuda_device, dtype):
    B, N, H, d = 4, 197, 6, 64
    g = torch.Generator(device=cuda_device).manual_seed(0)
    qkv = torch.randn(B, N, 3, H, d, generator=g, device=cuda_device).to(getattr(torch, dtype))
    before = attention.flash_attention.launches
    got = torch.ops.lvc_tpu_torch.flash_attention_fwd(qkv, d ** -0.5)
    torch.cuda.synchronize()
    assert attention.flash_attention.launches == before + 1
    want = attention.flash_attention_plain(qkv, d ** -0.5).float()
    err = (got.float() - want).abs()
    if dtype == "float32":
        assert float(err.max()) <= 1e-5
    else:
        mx = want.abs().view(B, N, H, d).amax(dim=(1, 3))
        ulp = torch.exp2(torch.floor(torch.log2(mx)) - 7)
        assert bool((err.view(B, N, H, d).amax(dim=(1, 3)) <= 2 * ulp).all())


def _roi_args(device, kernel, dtype=torch.float32):
    feats, boxes, strides = CASES["pyramid"]()
    levels = [torch.from_numpy(f).to(device, dtype) for f in feats]
    tboxes = torch.from_numpy(boxes).to(device)
    shapes = [f.shape[1:3] for f in feats]
    B = feats[0].shape[0]
    if kernel.paired:
        taps = ra.paired_taps(ra.tiled_prep_2d(shapes, B, tboxes, strides), shapes, 48)
    else:
        taps = ra.band_taps(ra.tiled_prep_band(shapes, B, tboxes, strides), shapes, B, 32, True)
    return levels, taps


def _nhwc_in_nchw_memory(f):
    """The same (B, H, W, C) values, laid out NCHW: not contiguous."""
    return f.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)


def _bad_roi(kernel_name, what):
    def make(device):
        kernel = getattr(ra, kernel_name)
        levels, taps = _roi_args(device, kernel)
        if what == "strided_level":
            levels[1] = _nhwc_in_nchw_memory(levels[1])
        elif what == "float16_levels":
            levels = [f.half() for f in levels]
        elif what == "strided_taps":
            n, P, NR = taps.wy.shape
            wy = taps.wy.new_empty((n, 2 * P, NR))[:, ::2]  # the same values, every other row
            wy.copy_(taps.wy)
            taps = taps._replace(wy=wy)
        return getattr(torch.ops.lvc_tpu_torch, kernel.symbol), (levels, *taps), kernel
    return make


def _bad_fused(what):
    def make(device):
        x, w_kn, scale, shift, res = _fused_inputs(256, 64, 128, device, seed=1)
        if what == "w_contiguous":
            w_kn = w_kn.contiguous()
        elif what == "x_float32":
            x = x.float()
        elif what == "residual_strided":
            res = res.t().contiguous().t()
        return torch.ops.lvc_tpu_torch.matmul_affine_residual, (x, w_kn, scale, shift, res, True), \
            fused_matmul.matmul_affine_residual
    return make


def _bad_attention(what):
    def make(device):
        qkv = torch.randn(2, 33, 3, 4, 64, device=device)
        if what == "head_strided":
            qkv = torch.randn(2, 33, 3, 64, 4, device=device).transpose(-1, -2)
        elif what == "token_stride":
            qkv = torch.randn(2, 33, 3 * 4 * 64 + 2, device=device)[:, :, :-2].unflatten(2, (3, 4, 64))
        elif what == "float16":
            qkv = qkv.half()
        return torch.ops.lvc_tpu_torch.flash_attention_fwd, (qkv, 0.125), attention.flash_attention
    return make


@pytest.mark.parametrize(
    "make, error",
    [
        (_bad_roi("roi_align_band", "strided_level"), ValueError),
        (_bad_roi("roi_align_band", "float16_levels"), TypeError),
        (_bad_roi("roi_align_paired", "strided_level"), ValueError),
        (_bad_roi("roi_align_paired", "float16_levels"), TypeError),
        (_bad_roi("roi_align_paired", "strided_taps"), ValueError),
        (_bad_fused("w_contiguous"), ValueError),
        (_bad_fused("x_float32"), TypeError),
        (_bad_fused("residual_strided"), ValueError),
        (_bad_attention("head_strided"), ValueError),
        (_bad_attention("token_stride"), ValueError),
        (_bad_attention("float16"), TypeError),
    ],
    ids=["band_strided_level", "band_float16", "paired_strided_level", "paired_float16", "paired_strided_taps",
         "fused_w_contiguous", "fused_x_float32", "fused_residual_strided", "attention_head_strided",
         "attention_token_stride", "attention_float16"],
)
def test_ops_reject_what_the_kernel_does_not_take_on_card(cuda_device, make, error):
    op, args, wrapper = make(cuda_device)
    before = wrapper.launches
    with pytest.raises(error):
        op(*args)
    assert wrapper.launches == before


def test_loaded_fused_program_checks_its_inputs_on_card(cuda_device, tmp_path):
    """A program exported with w the transpose of a contiguous (N, K) weight
    and given a contiguous (K, N) w of the same shape and dtype at run time
    (which the program's guards let through) raises instead of launching on
    the wrong layout; given the traced layout it launches and matches."""

    class Fused(torch.nn.Module):
        def forward(self, args):
            return fused_matmul.matmul_affine_residual(*args)

    args = _fused_inputs(512, 64, 256, cuda_device, seed=2)
    path = os.path.join(tmp_path, "fused.pt2")
    save_exported(export_model(Fused(), args), path)
    program = load_exported(path).module()
    kernel = fused_matmul.matmul_affine_residual
    before = kernel.launches
    x, w_kn, scale, shift, res = args
    with pytest.raises(ValueError, match="contiguous"):
        program((x, w_kn.contiguous(), scale, shift, res))
    assert kernel.launches == before
    got = program(args)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert torch.equal(got, kernel(*args))


def test_exported_detector_launches_k1_on_card(cuda_device):
    from lvc_tpu_torch.config import get_cfg
    from lvc_tpu_torch.modeling.meta_arch.build import build_model
    from lvc_tpu_torch.utils.init import damped_init

    cfg = get_cfg()
    cfg.merge_from_file("configs/Base-RCNN-FPN.yaml")
    cfg.MODEL.RESNETS.RES2_OUT_CHANNELS = 64
    cfg.MODEL.RESNETS.WIDTH_PER_GROUP = 16
    cfg.MODEL.FPN.OUT_CHANNELS = 64
    cfg.MODEL.ROI_HEADS.POOLER_IMPL = "pallas_fast"
    model = damped_init(build_model(cfg, device=cuda_device))
    g = torch.Generator().manual_seed(3)
    batch = {"image": (torch.rand(2, 256, 384, 3, generator=g) * 255).to(cuda_device),
             "image_size": torch.tensor([[256, 384], [200, 300]], dtype=torch.int32, device=cuda_device)}
    ep = export_model(model, batch)
    want = model(batch)._asdict()
    before = ra.roi_align_band.launches
    got = ep.module()(batch)
    torch.cuda.synchronize()
    assert ra.roi_align_band.launches == before + 1
    for k, v in got.items():
        assert torch.equal(v, want[k]), k
