"""The port's attention (``lvc_tpu_torch/ops/attention.py``) against the JAX
package's ``_flash_mha`` running the library Pallas TPU flash kernel in
interpret mode on the CPU (``pltpu.force_tpu_interpret_mode``), at the test
shape of ``tests/test_vit_flash_ci.py`` and at the verifier's full sequence.

Each shape also runs on a peaked qkv (``chip_smoke.peaked``), whose logits
span tens. Tolerances: float32 1e-5 max abs (measured about 1e-7); bf16,
from the same bf16 inputs, 2 bf16 ulps of the largest |out| of each (batch,
head) (measured 1 ulp). The TPU kernel and the plain version both cast exp(s - max) to bf16
before P.V, but sum P.V in different orders, and near-zero outputs differ by
many of their own ulps, so a per-element ulp bound cannot hold.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from chip_smoke import peaked
from lvc_tpu.modeling.backbone.vit import _flash_mha
from lvc_tpu_torch.ops.attention import flash_attention, flash_attention_plain

SHAPES = [(2, 85, 6, 64), (1, 785, 6, 64)]
CASES = ["mild", "peaked"]  # peaked: logits that span tens (chip_smoke.peaked)


def _qkv(shape, seed=0, case="mild"):
    B, N, H, d = shape
    qkv = np.random.RandomState(seed).randn(B, N, 3, H, d).astype(np.float32) * 0.5
    return peaked(qkv) if case == "peaked" else qkv


def _jax_flash(qkv: np.ndarray, dtype) -> np.ndarray:
    d = qkv.shape[-1]
    # jitted: eager interpret-mode calls can deadlock against the next
    # eagerly dispatched op
    with pltpu.force_tpu_interpret_mode():
        out = jax.jit(lambda x: _flash_mha(x, d ** -0.5))(jnp.asarray(qkv, dtype))
        return np.asarray(out.astype(jnp.float32))


def bf16_ulp_of_max(out: np.ndarray, shape) -> np.ndarray:
    """(B, H): one bf16 ulp of the largest |out| of each (batch, head)."""
    B, N, H, d = shape
    mx = np.abs(out.reshape(B, N, H, d)).max(axis=(1, 3))
    return 2.0 ** (np.floor(np.log2(mx)) - 7)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_matches_jax_flash_f32(shape, case):
    qkv = _qkv(shape, case=case)
    want = _jax_flash(qkv, jnp.float32)
    got = flash_attention_plain(torch.from_numpy(qkv), shape[-1] ** -0.5).numpy()
    assert got.shape == want.shape == (shape[0], shape[1], shape[2] * shape[3])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_matches_jax_flash_bf16(shape, case):
    qkv = _qkv(shape, seed=1, case=case)
    want = _jax_flash(qkv, jnp.bfloat16)
    got = flash_attention_plain(torch.from_numpy(qkv).to(torch.bfloat16), shape[-1] ** -0.5)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    B, N, H, d = shape
    err = np.abs(got - want).reshape(B, N, H, d).max(axis=(1, 3))
    assert (err <= 2 * bf16_ulp_of_max(want, shape)).all(), err / bf16_ulp_of_max(want, shape)


def test_plain_equals_softmax_attention_f32():
    """At float32 the TPU kernel's function is the einsum branch's
    (``vit.py:127-131``): dense softmax attention."""
    shape = (2, 37, 2, 64)
    qkv = torch.from_numpy(_qkv(shape, seed=2))
    q, k, v = (t.transpose(1, 2) for t in qkv.unbind(2))
    ref = torch.softmax(q @ k.transpose(-1, -2) * 0.125, dim=-1) @ v
    got = flash_attention_plain(qkv, 0.125)
    torch.testing.assert_close(got, ref.transpose(1, 2).reshape(2, 37, 128), rtol=0, atol=1e-6)


def test_wrapper_takes_the_plain_version_on_cpu():
    qkv = torch.from_numpy(_qkv((1, 20, 2, 64)))
    before = flash_attention.launches
    torch.testing.assert_close(flash_attention(qkv, 0.125), flash_attention_plain(qkv, 0.125), rtol=0, atol=0)
    assert flash_attention.launches == before


class _OnCard:
    """A CPU tensor that reports a CUDA device, so the wrapper's checks of
    what the kernel takes run here (each raises before a library is asked
    for)."""

    class device:
        type = "cuda"

    def __init__(self, t):
        self._t = t

    def __getattr__(self, name):
        return getattr(self._t, name)


def _bf16_packed(extra=0, offset=0):
    """(1, 4, 3, 2, 64) bf16 qkv viewed from a (1, 4, 384 + extra) buffer at
    element ``offset``: token stride 384 + extra elements."""
    buf = torch.zeros(1, 4, 384 + extra + offset, dtype=torch.bfloat16)
    return buf[:, :, offset:offset + 384].unflatten(2, (3, 2, 64))


@pytest.mark.parametrize(
    "qkv, error",
    [
        (torch.zeros(1, 4, 2, 2, 64), ValueError),  # not (B, N, 3, H, d)
        (torch.zeros(1, 4, 3, 2, 64, dtype=torch.float16), TypeError),
        (torch.zeros(1, 4, 3, 2, 64, device="meta"), RuntimeError),  # neither the CPU nor a card
        # on the card: head dim 64, contiguous; 16-byte strides and alignment
        (_OnCard(torch.zeros(1, 4, 3, 2, 32)), ValueError),
        (_OnCard(torch.zeros(1, 4, 3, 64, 2).transpose(-1, -2)), ValueError),
        (_OnCard(_bf16_packed(extra=4)), ValueError),  # token stride 776 bytes
        (_OnCard(_bf16_packed(offset=4)), ValueError),  # 8-byte aligned
        (_OnCard(torch.zeros(1, 4, 3 * 128 + 2)[:, :, 2:].unflatten(2, (3, 2, 64))), ValueError),
        (_OnCard(torch.zeros(1, 4, 3, 2, 64).expand(65536, 4, 3, 2, 64)), ValueError),  # B*H > 65535
    ],
    ids=["shape", "dtype", "device", "head_dim", "d_stride", "bf16_token_stride", "bf16_offset",
         "f32_offset", "grid"],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(qkv, error):
    with pytest.raises(error):
        flash_attention(qkv, 0.125)


def _tf32(a: torch.Tensor) -> torch.Tensor:
    """float32 -> TF32 (10-bit mantissa), rounding to nearest with ties away
    from zero, as the kernel's ``cvt.rna.tf32.f32``."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _matmul_3xtf32(a, b):
    """a @ b as the float32 kernel computes it: each operand split as big =
    tf32(x) plus small = tf32(x - big), and the three products small.big +
    big.small + big.big summed in float32."""
    ab, bb = _tf32(a), _tf32(b)
    as_, bs = _tf32(a - ab), _tf32(b - bb)
    return (as_ @ bb + ab @ bs) + ab @ bb


def _attention(qkv, scale, matmul):
    q, k, v = (t.transpose(1, 2) for t in qkv.unbind(2))
    s = matmul(q, k.transpose(-1, -2)) * scale
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return matmul(p, v) / p.sum(dim=-1, keepdim=True)


def test_tf32_split_meets_float32_tolerance():
    """The float32 kernel's route, emulated in torch on the CPU: three TF32
    passes for QK^T and for PV (p split too) are within the float32
    tolerance, 1e-5, of float64 attention on the peaked qkv at the
    verifier's sequence length; a single TF32 pass is not (it is off by
    about 3e-3). The card's tensor cores truncate their float32 sums, which
    this emulation does not model; chip_smoke.py holds the kernel itself
    against float64 on the same input."""
    qkv = torch.from_numpy(_qkv((2, 785, 6, 64), case="peaked"))
    scale = 64 ** -0.5
    q, k, v = (t.transpose(1, 2).double() for t in qkv.unbind(2))
    exact = torch.softmax(q @ k.transpose(-1, -2) * scale, dim=-1) @ v
    split = float((_attention(qkv, scale, _matmul_3xtf32).double() - exact).abs().max())
    single = float((_attention(qkv, scale, lambda a, b: _tf32(a) @ _tf32(b)).double() - exact).abs().max())
    assert split <= 1e-5, split
    assert single > 1e-5 * 100, single
