"""The fused 1x1-conv GEMM with an affine, residual and ReLU epilogue: the
Hopper kernel's wrapper, its plain PyTorch version, its autograd Function and
the NHWC entry point.

Counterpart of ``lvc_tpu/ops/fused_matmul.py``: ``matmul_affine_residual``
(:46, body ``_kernel`` :37, ``pl.pallas_call`` :76), the custom-VJP
``matmul_affine_residual_trainable`` (:108-146) and ``conv1x1_affine_residual``
(:149). All of them compute

    y = relu((x @ w) * scale + shift + residual)

with x (M, K), w (K, N), scale and shift (N,) float32 and residual (M, N): the
product accumulated in float32, the epilogue in float32, one cast to the
residual's dtype at the end. On the backbone this is the bottleneck tail
(``conv3`` with its folded FrozenBN, ReLU on) and the FPN lateral with its
top-down add (scale ones, shift the conv bias, no ReLU).

The kernel reads the weight as (N, K) with K contiguous, the layout of the
port's conv weight (N, K, 1, 1): ``matmul_affine_residual`` takes the JAX
package's (K, N) and hands the kernel its transpose, which is a view when w is
itself the transpose of a contiguous (N, K) weight, as the callers pass it.
"""
from __future__ import annotations

import torch

__all__ = [
    "matmul_affine_residual",
    "matmul_affine_residual_plain",
    "MatmulAffineResidualFn",
    "conv1x1_affine_residual",
]


def matmul_affine_residual_plain(
    x: torch.Tensor,
    w: torch.Tensor,
    scale: torch.Tensor,
    shift: torch.Tensor,
    residual: torch.Tensor,
    relu: bool = True,
) -> torch.Tensor:
    """The kernel's function in torch ops (``_kernel``, fused_matmul.py:37-42):
    one float32 product, the epilogue in float32, one cast."""
    y = x.float() @ w.float()
    y = y * scale.float() + shift.float() + residual.float()
    if relu:
        y = torch.clamp_min(y, 0.0)
    return y.to(residual.dtype)


class MatmulAffineResidual:
    """Wrapper of ``csrc/fused_matmul.cu``.

    On CPU tensors it returns the plain version. On CUDA tensors it launches
    the kernel (building it on first use) or raises; ``launches`` counts the
    launches and nothing else. The kernel takes bf16 x (M, K), w (K, N) whose
    transpose is contiguous, residual (M, N), all contiguous and 16-byte
    aligned, K and N multiples of 8, and scale and shift 8-byte aligned where
    they are float32 on x's device; it never copies x or the residual."""

    def __init__(self):
        self.launches = 0

    def __call__(
        self,
        x: torch.Tensor,
        w: torch.Tensor,
        scale: torch.Tensor,
        shift: torch.Tensor,
        residual: torch.Tensor,
        relu: bool = True,
    ) -> torch.Tensor:
        if x.dim() != 2 or w.dim() != 2:
            raise ValueError(f"x and w must be 2-D, got {tuple(x.shape)} and {tuple(w.shape)}")
        M, K = x.shape
        N = w.shape[1]
        if w.shape[0] != K or tuple(residual.shape) != (M, N):
            raise ValueError(f"shapes x {tuple(x.shape)}, w {tuple(w.shape)}, residual {tuple(residual.shape)}")
        if tuple(scale.shape) != (N,) or tuple(shift.shape) != (N,):
            raise ValueError(f"scale and shift must be ({N},), got {tuple(scale.shape)}, {tuple(shift.shape)}")
        if x.device.type == "cpu":
            return matmul_affine_residual_plain(x, w, scale, shift, residual, relu)
        if x.device.type != "cuda":
            raise RuntimeError(f"fused matmul: unsupported device {x.device}")
        if not (x.dtype == w.dtype == residual.dtype == torch.bfloat16):
            raise TypeError(f"fused matmul kernel takes bf16 x, w, residual; got {x.dtype}, {w.dtype}, {residual.dtype}")
        if K % 8 or N % 8:
            raise ValueError(f"kernel needs K and N multiples of 8, got K={K}, N={N}")
        wt = w.t()
        if not (x.is_contiguous() and residual.is_contiguous() and wt.is_contiguous()):
            raise ValueError(
                f"kernel needs contiguous x {x.stride()}, residual {residual.stride()} and w.t() {wt.stride()}"
            )
        if any(t.data_ptr() % 16 for t in (x, wt, residual)):
            raise ValueError("kernel needs 16-byte aligned x, w and residual")
        # the kernel reads scale and shift in pairs (float2); a float32
        # contiguous tensor on the card is handed over as it is
        for t in (scale, shift):
            if t.device == x.device and t.dtype == torch.float32 and t.is_contiguous() and t.data_ptr() % 8:
                raise ValueError("kernel needs 8-byte aligned float32 scale and shift")
        from lvc_tpu_torch.ops import _build

        lib = _build.load_library("fused_matmul")
        scale = scale.to(device=x.device, dtype=torch.float32).contiguous()
        shift = shift.to(device=x.device, dtype=torch.float32).contiguous()
        out = torch.empty((M, N), dtype=residual.dtype, device=x.device)
        if M == 0:
            return out
        err = lib.matmul_affine_residual(
            x.data_ptr(), wt.data_ptr(), scale.data_ptr(), shift.data_ptr(), residual.data_ptr(),
            out.data_ptr(), M, N, K, 1 if relu else 0,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
        if err != 0:
            raise RuntimeError(f"matmul_affine_residual: CUDA error {err} at launch")
        self.launches += 1
        return out


matmul_affine_residual = MatmulAffineResidual()


class MatmulAffineResidualFn(torch.autograd.Function):
    """``matmul_affine_residual_trainable`` (fused_matmul.py:108-146): the
    kernel forward, and ``_trainable_bwd``'s backward in torch ops. The
    backward recovers the pre-affine product from the saved output, so it
    needs no second forward GEMM:

        dz = g * 1{y > 0} (with the ReLU);  dx = (dz*scale) @ w^T;
        dw = x^T @ (dz*scale);  dscale = sum(dz * (y - shift - res) / scale);
        dshift = sum(dz);  dres = dz

    with 0 in dscale where scale is exactly 0. The two products go to
    ``torch.matmul`` in the operands' dtype (float32 accumulation on the
    card's tensor cores) and come back in it. The incoming gradient keeps
    its dtype (bf16 on the AMP path): masking it is exact, and the products
    with ``scale`` and the sums promote to float32, so this is JAX's float32
    arithmetic with fewer passes over memory."""

    @staticmethod
    def forward(ctx, x, w, scale, shift, residual, relu: bool = True):
        y = matmul_affine_residual(x, w, scale, shift, residual, relu)
        ctx.relu, ctx.res_dtype = relu, residual.dtype
        ctx.save_for_backward(x, w, scale, shift, residual if ctx.needs_input_grad[2] else None, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, w, scale, shift, residual, y = ctx.saved_tensors
        if ctx.relu:
            g = torch.where(y > 0, g, torch.zeros((), dtype=g.dtype, device=g.device))
        dx = dw = dscale = dshift = dres = None
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
            gs = (g * scale.float()).to(x.dtype)  # float32 product, one cast
            if ctx.needs_input_grad[0]:
                dx = torch.matmul(gs, w.t().to(x.dtype)).to(x.dtype)
            if ctx.needs_input_grad[1]:
                dw = torch.matmul(x.t(), gs).to(w.dtype)
        if ctx.needs_input_grad[2]:
            zero = scale == 0
            safe = torch.where(zero, torch.ones_like(scale), scale).float()
            dot = (y.float() - shift.float() - residual.float()) / safe
            dscale = torch.where(zero, torch.zeros_like(scale), (g.float() * dot).sum(0).to(scale.dtype))
        if ctx.needs_input_grad[3]:
            dshift = g.sum(0, dtype=torch.float32).to(shift.dtype)
        if ctx.needs_input_grad[4]:
            dres = g.to(ctx.res_dtype)
        return dx, dw, dscale, dshift, dres, None


def conv1x1_affine_residual(
    x: torch.Tensor,
    kernel: torch.Tensor,
    scale: torch.Tensor,
    shift: torch.Tensor,
    residual: torch.Tensor,
    relu: bool = True,
    trainable: bool = False,
) -> torch.Tensor:
    """NHWC entry point, the JAX package's layout: x (B, H, W, K), kernel
    (1, 1, K, N) or (K, N), residual (B, H, W, N) -> (B, H, W, N) contiguous.
    The port's channels_last NCHW tensors give x and residual as
    ``permute(0, 2, 3, 1)`` views; they are flattened with ``view``, never
    copied. ``trainable`` routes through ``MatmulAffineResidualFn``."""
    if kernel.dim() == 4:
        if tuple(kernel.shape[:2]) != (1, 1):
            raise ValueError(f"kernel must be (1, 1, K, N), got {tuple(kernel.shape)}")
        kernel = kernel[0, 0]
    B, H, W, K = x.shape
    N = kernel.shape[1]
    x2d, res2d = _rows(x, K), _rows(residual, N)
    if trainable:
        out = MatmulAffineResidualFn.apply(x2d, kernel, scale, shift, res2d, relu)
    else:
        out = matmul_affine_residual(x2d, kernel, scale, shift, res2d, relu)
    return out.view(B, H, W, N)


def _rows(t: torch.Tensor, cols: int) -> torch.Tensor:
    """(..., cols) -> (rows, cols): a view on the card, where a copy would be a
    hidden pass over device memory (it raises instead); on the CPU, whose
    plain version takes any layout, a reshape."""
    return t.reshape(-1, cols) if t.device.type == "cpu" else t.view(-1, cols)
