"""Multi-head attention of the DINO verifier: the Hopper flash-attention
kernel's wrapper and its plain PyTorch version.

Counterpart of ``lvc_tpu/modeling/backbone/vit.py::_flash_mha`` (:33), which
runs the library Pallas TPU kernel
``jax.experimental.pallas.ops.tpu.flash_attention`` (called at ``vit.py:80``)
as one full-sequence block per (batch, head). Both functions here take the
qkv Linear's output viewed as (B, N, 3, H, d) and return (B, N, H*d) in its
dtype, and compute, per (batch, head),

    s = (q . k^T in float32) * scale;  p = exp(s - rowmax(s))
    out = (p cast to the input dtype) . v, accumulated in float32, / rowsum(p)

which is the TPU kernel's body with one block (logits and sums in float32,
``p.astype(v.dtype)`` before P.V, division by l). In float32 it equals the
einsum branch of ``vit.py`` (:127-131) to about 1e-7. In bf16 the kernel's
online softmax casts exp(s - running max), the TPU kernel and the plain
version exp(s - max): they agree to about one bf16 ulp of the largest output
of each (batch, head), not bit for bit.

The JAX package sends N past 1280 to the einsum form, because the TPU
kernel's full-sequence block outgrows VMEM there; the Hopper kernel streams
keys through shared memory and takes every N, so the port keeps it at every N.
"""
from __future__ import annotations

import torch

__all__ = ["flash_attention", "flash_attention_plain"]


def flash_attention_plain(qkv: torch.Tensor, scale: float) -> torch.Tensor:
    """(B, N, 3, H, d) -> (B, N, H*d): the kernel's function in torch ops."""
    B, N, _, H, d = qkv.shape
    q, k, v = (t.transpose(1, 2).float() for t in qkv.unbind(2))  # (B, H, N, d)
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    out = torch.matmul(p.to(qkv.dtype).float(), v) / p.sum(dim=-1, keepdim=True)
    return out.to(qkv.dtype).transpose(1, 2).reshape(B, N, H * d)


class FlashAttention:
    """Wrapper of ``csrc/flash_attention_fwd.cu``.

    On CPU tensors it returns the plain version. On CUDA tensors it launches
    the kernel (building it on first use) or raises; ``launches`` counts the
    launches and nothing else. The kernel reads q, k and v in place through
    the strides of ``qkv`` (head dim 64, contiguous; every stride a multiple of
    16 bytes, the tensor 16-byte aligned) and writes (B, N, H*d)."""

    HEAD_DIM = 64

    def __init__(self):
        self.launches = 0

    def __call__(self, qkv: torch.Tensor, scale: float) -> torch.Tensor:
        if qkv.dim() != 5 or qkv.shape[2] != 3:
            raise ValueError(f"qkv must be (B, N, 3, H, d), got {tuple(qkv.shape)}")
        if qkv.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"flash attention: dtype {qkv.dtype}")
        if qkv.device.type == "cpu":
            return flash_attention_plain(qkv, scale)
        if qkv.device.type != "cuda":
            raise RuntimeError(f"flash attention: unsupported device {qkv.device}")
        B, N, _, H, d = qkv.shape
        sb, sn, s3, sh, sd = qkv.stride()
        if d != self.HEAD_DIM or sd != 1:
            raise ValueError(f"kernel needs head dim {self.HEAD_DIM}, contiguous; got d={d}, stride {sd}")
        # 16-byte cp.async chunks: 4 float32 or 8 bf16 elements
        isz = qkv.element_size()
        if any(s * isz % 16 for s in (sb, sn, s3, sh)) or qkv.data_ptr() % 16:
            raise ValueError(
                f"kernel needs strides of multiples of 16 bytes and 16-byte alignment: {qkv.stride()} x {isz} bytes"
            )
        if B * H > 65535:
            raise ValueError(f"kernel takes B*H <= 65535, got {B * H}")
        from lvc_tpu_torch.ops import _build

        lib = _build.load_library("flash_attention_fwd")
        out = torch.empty((B, N, H * d), dtype=qkv.dtype, device=qkv.device)
        if N == 0 or B == 0:
            return out
        base = qkv.data_ptr()
        err = lib.flash_attention_fwd(
            base, base + s3 * isz, base + 2 * s3 * isz, sb, sn, sh, B, N, H, d, float(scale),
            out.data_ptr(), 1 if qkv.dtype == torch.bfloat16 else 0,
            torch.cuda.current_stream(qkv.device).cuda_stream,
        )
        if err != 0:
            raise RuntimeError(f"flash_attention_fwd: CUDA error {err} at launch")
        self.launches += 1
        return out


flash_attention = FlashAttention()
