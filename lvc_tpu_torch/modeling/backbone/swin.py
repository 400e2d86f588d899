"""Swin Transformer backbone (PyTorch).

Counterpart of ``lvc_tpu/modeling/backbone/swin.py`` (SWIN_CONFIGS:18,
window_partition:25, window_reverse:32, relative_position_index:38,
WindowAttention:46, SwinBlock:79, PatchMerging:126, SwinTransformer:142,
build_swin_fpn_backbone:183). The stage outputs are ``res2``..``res5``
(strides 4..32), NCHW, so the FPN takes them as it takes a ResNet's. Inside,
the blocks work on (B, H, W, C) tokens.

What the JAX module does, and so what this one does:

- the patch embedding is flax's ``nn.Conv`` with its default ``"SAME"``
  padding: ``ceil(H / p)`` rows, the padding split ``total // 2`` on the low
  side and the rest on the high side (a plain ``Conv2d(k=p, s=p)`` agrees
  only where H and W are multiples of p);
- each block pads its tokens to the window after ``norm1`` (zeros at the
  bottom and right), rolls by ``-shift`` and back by ``+shift``; the shift
  mask is built on the padded grid (-100 between tokens of different
  regions); an unshifted block attends to the padded tokens unmasked;
- ``PatchMerging`` pads an odd H or W at the bottom or right and
  concatenates (even, even), (odd, even), (even, odd), (odd, odd);
- there is no drop path, no absolute position embedding, no frozen stage,
  no ``QK_SCALE`` and the qkv bias is always on: JAX reads only
  ``SWIN_SIZE``, ``WINDOW_SIZE``, ``PATCH_SIZE``, ``MLP_RATIO`` and
  ``OUT_INDICES`` (``swin.py:185-197``).

Every layer runs in its input's dtype with its parameters cast to it, as
flax's ``Dense``/``LayerNorm`` do when the step casts the parameters to
bf16: the matmuls, the -100 mask, the bias table and the softmax in bf16
under bf16 serving and AMP; the LayerNorm statistics and affine in float32
(flax's ``_compute_stats`` promotes them), the result in the input's dtype.

The state dict uses the public Swin names (``patch_embed.proj``,
``patch_embed.norm``, ``layers.{i}.blocks.{j}.{norm1, attn.qkv, attn.proj,
attn.relative_position_bias_table, norm2, mlp.fc1, mlp.fc2}``,
``layers.{i}.downsample.{norm, reduction}``, ``norm{i}``); the relative
position index and the shift masks are computed, not stored.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

SWIN_CONFIGS = {
    "tiny": dict(embed_dim=96, depths=(2, 2, 6, 2), num_heads=(3, 6, 12, 24)),
    "small": dict(embed_dim=96, depths=(2, 2, 18, 2), num_heads=(3, 6, 12, 24)),
    "base": dict(embed_dim=128, depths=(2, 2, 18, 2), num_heads=(4, 8, 16, 32)),
}


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * nH * nW, ws * ws, C); H and W divisible by ws."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // ws, ws, W // ws, ws, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, C)


def window_reverse(windows: torch.Tensor, ws: int, H: int, W: int) -> torch.Tensor:
    B = windows.shape[0] // ((H // ws) * (W // ws))
    x = windows.reshape(B, H // ws, W // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, -1)


def relative_position_index(ws: int) -> np.ndarray:
    """(ws*ws, ws*ws) index into the (2ws-1)^2-row bias table."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0) + ws - 1
    return (rel[..., 0] * (2 * ws - 1) + rel[..., 1]).astype(np.int64)


def shift_mask(Hp: int, Wp: int, ws: int, shift: int) -> np.ndarray:
    """(nW, ws*ws, ws*ws) float32: -100 between tokens of different regions
    of the rolled, padded grid, 0 within one (``_attn_mask``, swin.py:113)."""
    img = np.zeros((1, Hp, Wp, 1), np.float32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[:, hs, wsl] = cnt
            cnt += 1
    win = window_partition(torch.from_numpy(img), ws).reshape(-1, ws * ws).numpy()
    diff = win[:, None, :] - win[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


def _linear(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    bias = None if layer.bias is None else layer.bias.to(x.dtype)
    return F.linear(x, layer.weight.to(x.dtype), bias)


class LayerNorm(nn.LayerNorm):
    """flax's ``nn.LayerNorm(epsilon=1e-5)``: statistics and affine in
    float32, the parameters seen in the input's dtype (bf16 under AMP), the
    result in the input's dtype."""

    def __init__(self, dim: int):
        super().__init__(dim, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, self.normalized_shape, self.weight.to(x.dtype), self.bias.to(x.dtype), self.eps)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(torch.zeros((2 * window_size - 1) ** 2, num_heads))
        nn.init.normal_(self.relative_position_bias_table, std=0.02)
        self.register_buffer(
            "relative_position_index", torch.from_numpy(relative_position_index(window_size).reshape(-1)),
            persistent=False,
        )

    def forward(self, x: torch.Tensor, mask: torch.Tensor = None) -> torch.Tensor:
        Bn, N, C = x.shape
        H = self.num_heads
        hd = C // H
        qkv = _linear(self.qkv, x).reshape(Bn, N, 3, H, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        attn = (q @ k.transpose(-2, -1)) * (hd ** -0.5)
        bias = self.relative_position_bias_table.to(x.dtype)[self.relative_position_index]
        attn = attn + bias.reshape(N, N, H).permute(2, 0, 1)[None]
        if mask is not None:
            nw = mask.shape[0]
            attn = (attn.reshape(Bn // nw, nw, H, N, N) + mask[None, :, None]).reshape(Bn, H, N, N)
        attn = torch.softmax(attn, dim=-1)
        out = (attn @ v).transpose(1, 2).reshape(Bn, N, C)
        return _linear(self.proj, out)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _linear(self.fc2, F.gelu(_linear(self.fc1, x)))


class SwinBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int = 7, shift: int = 0, mlp_ratio: float = 4.0):
        super().__init__()
        self.window_size = window_size
        self.shift = shift
        self.norm1 = LayerNorm(dim)
        self.attn = WindowAttention(dim, num_heads, window_size)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self._masks: Dict = {}

    def _attn_mask(self, Hp: int, Wp: int, like: torch.Tensor) -> torch.Tensor:
        key = (Hp, Wp, like.device, like.dtype)
        if key not in self._masks:
            m = shift_mask(Hp, Wp, self.window_size, self.shift)
            self._masks[key] = torch.from_numpy(m).to(device=like.device, dtype=like.dtype)
        return self._masks[key]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        ws, s = self.window_size, self.shift
        pad_h, pad_w = (-H) % ws, (-W) % ws
        y = F.pad(self.norm1(x), (0, 0, 0, pad_w, 0, pad_h))
        Hp, Wp = H + pad_h, W + pad_w
        mask = None
        if s:
            y = torch.roll(y, shifts=(-s, -s), dims=(1, 2))
            mask = self._attn_mask(Hp, Wp, y)
        y = window_reverse(self.attn(window_partition(y, ws), mask), ws, Hp, Wp)
        if s:
            y = torch.roll(y, shifts=(s, s), dims=(1, 2))
        x = x + y[:, :H, :W]
        return x + self.mlp(self.norm2(x))


class PatchMerging(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.norm = LayerNorm(4 * dim)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        H, W = x.shape[1:3]
        x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
        return _linear(self.reduction, self.norm(x))


class SwinStage(nn.Module):
    def __init__(self, dim, depth, num_heads, window_size, mlp_ratio, downsample: bool):
        super().__init__()
        self.blocks = nn.ModuleList(
            SwinBlock(dim, num_heads, window_size, 0 if b % 2 == 0 else window_size // 2, mlp_ratio)
            for b in range(depth)
        )
        self.downsample = PatchMerging(dim) if downsample else None


class PatchEmbed(nn.Module):
    """``patch x patch`` conv at stride ``patch`` with flax's SAME padding,
    then a LayerNorm."""

    def __init__(self, patch_size: int, embed_dim: int):
        super().__init__()
        self.patch_size = patch_size
        self.proj = nn.Conv2d(3, embed_dim, kernel_size=patch_size, stride=patch_size)
        self.norm = LayerNorm(embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 3, H, W) -> (B, ceil(H/p), ceil(W/p), C) tokens."""
        p = self.patch_size
        pads = []
        for n in (x.shape[3], x.shape[2]):  # F.pad lists the last dim first
            total = max((-(-n // p) - 1) * p + p - n, 0)
            pads += [total // 2, total - total // 2]
        x = F.pad(x, pads)
        x = F.conv2d(x, self.proj.weight.to(x.dtype), self.proj.bias.to(x.dtype), stride=p)
        return self.norm(x.permute(0, 2, 3, 1))


class SwinTransformer(nn.Module):
    """NCHW image -> ``{"res2": stride 4, ..., "res5": stride 32}`` (the
    stages of ``out_indices``), NCHW."""

    def __init__(
        self,
        embed_dim: int = 96,
        depths: Sequence[int] = (2, 2, 6, 2),
        num_heads: Sequence[int] = (3, 6, 12, 24),
        window_size: int = 7,
        patch_size: int = 4,
        mlp_ratio: float = 4.0,
        out_indices: Sequence[int] = (0, 1, 2, 3),
    ):
        super().__init__()
        self.out_indices = tuple(out_indices)
        self.patch_embed = PatchEmbed(patch_size, embed_dim)
        self.layers = nn.ModuleList(
            SwinStage(embed_dim * 2 ** i, d, num_heads[i], window_size, mlp_ratio, i < len(depths) - 1)
            for i, d in enumerate(depths)
        )
        for i in self.out_indices:
            self.add_module(f"norm{i}", LayerNorm(embed_dim * 2 ** i))

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = self.patch_embed(x)
        out = {}
        for i, stage in enumerate(self.layers):
            for block in stage.blocks:
                x = block(x)
            if i in self.out_indices:
                out[f"res{i + 2}"] = getattr(self, f"norm{i}")(x).permute(0, 3, 1, 2)
            if stage.downsample is not None:
                x = stage.downsample(x)
        return out


def swin_out_channels(cfg) -> Dict[str, int]:
    """Each stage's output channels: ``embed_dim * 2**i`` for res{i+2}."""
    embed = SWIN_CONFIGS[cfg.MODEL.SWIN.SWIN_SIZE]["embed_dim"]
    return {f"res{i + 2}": embed * 2 ** i for i in range(4)}


def build_swin(cfg) -> SwinTransformer:
    """The bottom-up of ``build_swin_fpn_backbone`` (swin.py:183-195)."""
    s = cfg.MODEL.SWIN
    params = SWIN_CONFIGS[s.SWIN_SIZE]
    return SwinTransformer(
        embed_dim=params["embed_dim"],
        depths=tuple(params["depths"]),
        num_heads=tuple(params["num_heads"]),
        window_size=s.WINDOW_SIZE,
        patch_size=s.PATCH_SIZE,
        mlp_ratio=s.MLP_RATIO,
        out_indices=tuple(s.OUT_INDICES),
    )
