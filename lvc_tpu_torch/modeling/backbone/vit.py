"""Vision Transformer (DINO ViT-S/8 and ViT-S/16) for the label verifier.

Counterpart of ``lvc_tpu/modeling/backbone/vit.py``: patch embed, CLS token
and position embedding, pre-LN blocks with fused qkv, final LayerNorm, the
CLS embedding of each crop as its descriptor. The modules carry DINO's own
torch parameter names (``patch_embed.proj``, ``cls_token``, ``pos_embed``,
``blocks.{i}.norm1/attn.qkv/attn.proj/norm2/mlp.fc1/mlp.fc2``, ``norm``), so a
DINO checkpoint loads with ``load_state_dict`` once its ``head.*`` keys are
dropped (``load_dino_state_dict``).

The JAX dtype flow, with the compute dtype an attribute of the model rather
than a process global: the Linears (flax ``Dense(dtype=dt)``) compute in the
compute dtype, so their outputs are in it; LayerNorm and the patch-embed
convolution carry no dtype and run in float32, so the residual stream stays
float32; softmax logits and sums are float32 (``ops/attention.py``); GELU is
exact (erf); LayerNorm eps is 1e-6. Parameters stay float32.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from lvc_tpu_torch.ops.attention import flash_attention
from lvc_tpu_torch.utils.tracing import span


def _linear(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """flax ``Dense(dtype=dtype)``: input, kernel and bias cast to ``dtype``."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        with span("mlp"):
            return _linear(self.fc2, F.gelu(_linear(self.fc1, x, dtype)), dtype)


class Attention(nn.Module):
    """The Hopper kernel on CUDA tensors, its plain version on CPU tensors
    (``flash_attention`` decides by device)."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        with span("attention"):
            B, N, C = x.shape
            H = self.num_heads
            qkv = _linear(self.qkv, x, dtype).view(B, N, 3, H, C // H)
            out = flash_attention(qkv, (C // H) ** -0.5)
            return _linear(self.proj, out, dtype)


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        x = x + self.attn(self.norm1(x), dtype)
        return x + self.mlp(self.norm2(x), dtype)


class PatchEmbed(nn.Module):
    def __init__(self, patch_size: int, embed_dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, embed_dim, patch_size, stride=patch_size)


class VisionTransformer(nn.Module):
    """(B, H, W, 3) float32 pixels, already normalised -> CLS embeddings
    (B, embed_dim) in float32."""

    def __init__(
        self,
        patch_size: int = 8,
        embed_dim: int = 384,
        depth: int = 12,
        num_heads: int = 6,
        mlp_ratio: float = 4.0,
        img_size: int = 224,
        compute_dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.patch_size = patch_size
        self.embed_dim = embed_dim
        self.compute_dtype = compute_dtype
        self.side = img_size // patch_size
        self.patch_embed = PatchEmbed(patch_size, embed_dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, self.side ** 2 + 1, embed_dim))
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, mlp_ratio) for _ in range(depth)
        )
        self.norm = nn.LayerNorm(embed_dim, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B = x.shape[0]
        C = self.embed_dim
        with span("patch_embed"):
            x = self.patch_embed.proj(x.permute(0, 3, 1, 2))  # (B, C, h, w)
            h, w = x.shape[2:]
            x = x.flatten(2).transpose(1, 2)  # (B, h*w, C), row-major over (h, w)
            pos_cls, pos_patch = self.pos_embed[:, :1], self.pos_embed[:, 1:]
            if h * w != self.side ** 2:
                # jax.image.resize(..., "bicubic"): Keys a=-0.5 with
                # antialiasing when it shrinks, which is torch's antialias path
                grid = pos_patch.reshape(1, self.side, self.side, C).permute(0, 3, 1, 2)
                grid = F.interpolate(grid, size=(h, w), mode="bicubic", align_corners=False, antialias=True)
                pos_patch = grid.permute(0, 2, 3, 1).reshape(1, h * w, C)
            x = torch.cat([self.cls_token.expand(B, 1, C), x], dim=1)
            x = x + torch.cat([pos_cls, pos_patch], dim=1)
        for blk in self.blocks:
            x = blk(x, self.compute_dtype)
        return self.norm(x)[:, 0]


def dino_vits8(compute_dtype: torch.dtype = torch.float32) -> VisionTransformer:
    return VisionTransformer(8, 384, 12, 6, compute_dtype=compute_dtype)


def dino_vits16(compute_dtype: torch.dtype = torch.float32) -> VisionTransformer:
    return VisionTransformer(16, 384, 12, 6, compute_dtype=compute_dtype)


def random_init(model: VisionTransformer, seed: int = 0) -> VisionTransformer:
    """Seeded weights in the spirit of DINO's init: N(0, 0.02) Linear, patch
    and position weights, zero biases and CLS token, LayerNorm 1 and 0. Drawn
    on the CPU from a ``torch.Generator``, so every device gets the same."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in model.named_parameters():
            if name.endswith("bias") or name == "cls_token":
                new = torch.zeros(t.shape)
            elif ".norm" in name or name.startswith("norm"):
                new = torch.ones(t.shape)
            else:
                new = torch.randn(t.shape, generator=gen) * 0.02
            t.copy_(new)
    return model


def load_dino_state_dict(model: VisionTransformer, state_dict: Dict[str, torch.Tensor]) -> VisionTransformer:
    """Load a DINO checkpoint's state dict; its projection head (``head.*``)
    is not used for descriptors and is dropped."""
    sd = {k: v for k, v in state_dict.items() if not k.startswith("head.")}
    model.load_state_dict(sd)
    return model
