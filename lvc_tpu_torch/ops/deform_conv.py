"""Deformable convolution v1/v2 as a bilinear gather plus a matmul, in torch
ops.

Counterpart of ``lvc_tpu/ops/deform_conv.py`` (_bilinear_sample:24,
deform_conv2d:49, DeformConv:92). JAX computes it in plain XLA (no
``pallas_call``), and so does the port: the sample positions (the k-grid
plus the learned offsets) are read with a vectorised bilinear gather, and
the (N*Ho*Wo, K*K*C) x (K*K*C, F) contraction is one matmul. Autograd gives
the backward.

What JAX does, and so what this does:

- a sample is zeroed only outside (-1, H) x (-1, W); inside, its position
  is clipped into [0, H-1] x [0, W-1] first, so a sample in (-1, 0) takes
  row 0 at full weight (detectron2's DCN weighs the missing corner as 0);
- the clip is ``minimum(maximum(y, 0), H-1)``, whose gradient at a tie is
  0.5, as ``jnp.clip``'s (``torch.clamp``'s is 1): with the zero-initialised
  offsets every edge tap sits exactly on row 0 or H-1;
- offsets are (dy, dx) interleaved per tap, tap-major; DCNv2's modulation is
  ``2 * sigmoid`` of the last K*K channels (detectron2: ``sigmoid``);
- the sample positions are float32, so under bf16 the gathered values, the
  modulation and the contraction run in float32 (flax promotes the bf16
  values by the float32 weights), and the result is cast to the input's
  dtype.
"""
from __future__ import annotations

from typing import Optional

import torch

from lvc_tpu_torch.modeling.layers import get_norm


def _clip(v: torch.Tensor, hi: float) -> torch.Tensor:
    """``jnp.clip(v, 0, hi)``, ties splitting the gradient as JAX does."""
    return torch.minimum(torch.maximum(v, v.new_zeros(())), v.new_full((), hi))


def _bilinear_sample(img: torch.Tensor, y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """img (N, H, W, C); y, x (N, ...) float sample positions -> (N, ..., C)
    float32 (or float64), zero outside."""
    N, H, W, C = img.shape
    inside = (y > -1.0) & (y < H) & (x > -1.0) & (x < W)
    y = _clip(y, H - 1.0)
    x = _clip(x, W - 1.0)
    y0 = torch.floor(y).long()
    x0 = torch.floor(x).long()
    y1 = torch.clamp(y0 + 1, max=H - 1)
    x1 = torch.clamp(x0 + 1, max=W - 1)
    fy = (y - y0)[..., None]
    fx = (x - x0)[..., None]
    base = torch.arange(N, device=img.device).view((N,) + (1,) * (y.dim() - 1)) * (H * W)
    flat = img.reshape(N * H * W, C)

    def at(yy, xx):
        return flat[base + yy * W + xx].to(fy.dtype)

    out = (
        at(y0, x0) * (1 - fy) * (1 - fx)
        + at(y0, x1) * (1 - fy) * fx
        + at(y1, x0) * fy * (1 - fx)
        + at(y1, x1) * fy * fx
    )
    return torch.where(inside[..., None], out, torch.zeros((), dtype=out.dtype, device=out.device))


def deform_conv2d(
    x: torch.Tensor,  # (N, C, H, W)
    offsets: torch.Tensor,  # (N, 2*K*K, Ho, Wo), (dy, dx) interleaved per tap
    weight: torch.Tensor,  # (F, C, K, K)
    stride: int = 1,
    padding: int = 1,
    dilation: int = 1,
    mask: Optional[torch.Tensor] = None,  # (N, K*K, Ho, Wo) modulation (DCNv2)
) -> torch.Tensor:
    """Deformable conv forward -> (N, F, Ho, Wo) in ``x``'s dtype, where
    Ho = (H + 2*padding - dilation*(K-1) - 1)//stride + 1."""
    N, C, H, W = x.shape
    F_, K = weight.shape[0], weight.shape[-1]
    Ho = (H + 2 * padding - dilation * (K - 1) - 1) // stride + 1
    Wo = (W + 2 * padding - dilation * (K - 1) - 1) // stride + 1
    pos = torch.float64 if x.dtype == torch.float64 else torch.float32
    dev = x.device
    oy = torch.arange(Ho, dtype=pos, device=dev) * stride - padding
    ox = torch.arange(Wo, dtype=pos, device=dev) * stride - padding
    kk = torch.arange(K, dtype=pos, device=dev) * dilation
    base_y = (oy[:, None, None, None] + kk[None, None, :, None]).expand(Ho, Wo, K, K).reshape(Ho, Wo, K * K)
    base_x = (ox[None, :, None, None] + kk[None, None, None, :]).expand(Ho, Wo, K, K).reshape(Ho, Wo, K * K)
    off = offsets.permute(0, 2, 3, 1).reshape(N, Ho, Wo, K * K, 2)
    sy = base_y[None] + off[..., 0]
    sx = base_x[None] + off[..., 1]
    vals = _bilinear_sample(x.permute(0, 2, 3, 1), sy, sx)  # (N, Ho, Wo, K*K, C)
    if mask is not None:
        vals = vals * mask.permute(0, 2, 3, 1)[..., None]
    cols = vals.reshape(N, Ho, Wo, K * K * C)
    w = weight.to(x.dtype).to(cols.dtype).permute(2, 3, 1, 0).reshape(K * K * C, F_)
    return (cols @ w).to(x.dtype).permute(0, 3, 1, 2)


class DeformConv(torch.nn.Module):
    """The deformable 3x3 of detectron2's ``DeformBottleneckBlock``: a
    ``weight`` (F, C, K, K) with no bias and the block's ``norm`` after it;
    the offsets (and DCNv2's modulation) come from the block's
    ``conv2_offset``."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3, stride: int = 1,
                 padding: int = 1, dilation: int = 1, norm: str = ""):
        super().__init__()
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.weight = torch.nn.Parameter(torch.empty(out_channels, in_channels, kernel_size, kernel_size))
        torch.nn.init.kaiming_normal_(self.weight, mode="fan_out", nonlinearity="relu")
        self.norm = get_norm(norm, out_channels)

    def forward(self, x: torch.Tensor, offsets: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        out = deform_conv2d(x, offsets, self.weight, self.stride, self.padding, self.dilation, mask)
        return out if self.norm is None else self.norm(out)
