"""The port's fused 1x1-conv GEMM (``lvc_tpu_torch/ops/fused_matmul.py``)
and ``Conv2d``'s fused branch against the JAX package's
(``lvc_tpu/ops/fused_matmul.py``: the Pallas kernel in interpret mode on the
CPU, jitted; eager interpret-mode calls can deadlock).

Tolerances:
- float32, plain against the Pallas kernel: atol 2e-6, rtol 1e-6, as
  tests/test_fused_matmul.py holds the kernel against numpy;
- bf16, from the same bf16 inputs: per element, 1 bf16 ulp of the JAX result
  plus 1e-5 * S, S the element's absolute sum |x| @ |w| * |scale| + |shift| +
  |res|. Both accumulate the exact products of bf16 values in float32, in
  other orders, and cast once: they differ by 1 ulp where the float32 values
  fall on two sides of a bf16 rounding boundary, and where the sum cancels
  towards 0, by the float32 summation error, many of the small result's own
  ulps (measured: 4 ulps of a 2.7e-6 result whose terms are O(1), 6e-8
  apart). A wrong epilogue or product is off by O(S);
- gradients of ``MatmulAffineResidualFn`` against ``jax.grad`` of
  ``matmul_affine_residual_trainable`` in float32: atol 2e-4, rtol 2e-5, as
  tests/test_fused_matmul.py holds that VJP against the unfused composition.

The JAX gate also asks for the TPU backend; the tests that run JAX's fused
``Conv2d`` spoof ``jax.default_backend`` and run the kernel in interpret
mode, as tests/test_fused_matmul.py does (``jax_fused``). Nothing in the JAX
package changes.
"""
import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import lvc_tpu.ops.fused_matmul as jfm
from lvc_tpu.modeling.layers import Conv2d as JaxConv2d
from lvc_tpu.modeling.layers import compute_dtype_scope

import lvc_tpu_torch.ops.fused_matmul as tfm
from lvc_tpu_torch.modeling.layers import Conv2d
from lvc_tpu_torch.ops.fused_matmul import (
    MatmulAffineResidualFn,
    conv1x1_affine_residual,
    matmul_affine_residual,
    matmul_affine_residual_plain,
)


@contextlib.contextmanager
def jax_fused(monkeypatch, calls=None):
    """JAX's fused branch on the CPU: the TPU gate spoofed, the Pallas kernel
    in interpret mode; each traced call appended to ``calls``."""
    orig = jfm.conv1x1_affine_residual

    def interpret(*a, **k):
        if calls is not None:
            calls.append(a[0].shape)
        return orig(*a, **{**k, "interpret": True})

    with monkeypatch.context() as m:
        m.setattr(jax, "default_backend", lambda: "tpu")
        m.setattr(jfm, "conv1x1_affine_residual", interpret)
        m.setenv("LVC_TPU_FUSED_RESIDUAL", "1")
        yield


def bf16_ulp(x: np.ndarray) -> np.ndarray:
    mag = np.maximum(np.abs(x.astype(np.float32)), 2.0 ** -126)
    return np.exp2(np.floor(np.log2(mag)) - 7)


def _bf16(a: np.ndarray) -> np.ndarray:
    """a rounded to bf16, back as float32."""
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _inputs(M, K, N, seed=0):
    rng = np.random.RandomState(seed)
    return (
        rng.randn(M, K).astype(np.float32),
        (rng.randn(K, N) * K ** -0.5).astype(np.float32),
        (rng.rand(N) + 0.5).astype(np.float32),
        rng.randn(N).astype(np.float32),
        rng.randn(M, N).astype(np.float32),
    )


def _jax(args, relu, dtype):
    x, w, scale, shift, res = args
    out = jfm.matmul_affine_residual(
        jnp.asarray(x, dtype), jnp.asarray(w, dtype), jnp.asarray(scale), jnp.asarray(shift),
        jnp.asarray(res, dtype), relu=relu, interpret=True,
    )
    return np.asarray(out.astype(jnp.float32))


def _torch(args, dtype=torch.float32):
    x, w, scale, shift, res = (torch.from_numpy(a) for a in args)
    return x.to(dtype), w.to(dtype), scale, shift, res.to(dtype)


def abs_sum(x, w, scale, shift, res) -> np.ndarray:
    """S: the element's absolute sum |x| @ |w| * |scale| + |shift| + |res|
    of bf16-rounded operands, in float64."""
    x, w, res = (np.abs(_bf16(a)).astype(np.float64) for a in (x, w, res))
    return x @ w * np.abs(scale) + np.abs(shift) + res


def _assert_within_ulp(got: np.ndarray, want: np.ndarray, S: np.ndarray):
    err = np.abs(got - want)
    assert (err <= bf16_ulp(want) + 1e-5 * S).all(), (err.max(), float((err / S).max()))


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("M", [512, 700])  # aligned and ragged, as the JAX test
def test_plain_matches_jax_kernel_f32(M, relu):
    args = _inputs(M, 64, 256)
    want = _jax(args, relu, jnp.float32)
    got = matmul_affine_residual_plain(*_torch(args), relu=relu)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6, rtol=1e-6)
    # the wrapper takes the plain version on CPU tensors
    before = matmul_affine_residual.launches
    assert torch.equal(matmul_affine_residual(*_torch(args), relu=relu), got)
    assert matmul_affine_residual.launches == before


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("shape", [(700, 64, 256), (2048, 256, 1024)], ids=lambda s: "x".join(map(str, s)))
def test_plain_matches_jax_kernel_bf16(shape, relu):
    args = _inputs(*shape, seed=1)
    want = _jax(args, relu, jnp.bfloat16)
    got = matmul_affine_residual_plain(*_torch(args, torch.bfloat16), relu=relu)
    assert got.dtype == torch.bfloat16
    _assert_within_ulp(got.float().numpy(), want, abs_sum(*args))


def test_conv1x1_nhwc_matches_jax_bf16():
    rng = np.random.RandomState(2)
    B, H, W, K, N = 2, 10, 14, 128, 256
    x = rng.randn(B, H, W, K).astype(np.float32)
    k = (rng.randn(1, 1, K, N) * 0.05).astype(np.float32)
    scale = (rng.rand(N) + 0.5).astype(np.float32)
    shift = rng.randn(N).astype(np.float32)
    res = rng.randn(B, H, W, N).astype(np.float32)
    want = jax.jit(functools.partial(jfm.conv1x1_affine_residual, interpret=True))(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16), jnp.asarray(scale),
        jnp.asarray(shift), jnp.asarray(res, jnp.bfloat16),
    )
    # the port's tensors: channels_last NCHW, handed over as NHWC views
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    rt = torch.from_numpy(res).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    got = conv1x1_affine_residual(
        xt.bfloat16().permute(0, 2, 3, 1), torch.from_numpy(k).bfloat16(), torch.from_numpy(scale),
        torch.from_numpy(shift), rt.bfloat16().permute(0, 2, 3, 1),
    )
    assert got.shape == (B, H, W, N) and got.dtype == torch.bfloat16 and got.is_contiguous()
    S = abs_sum(x.reshape(-1, K), k[0, 0], scale, shift, res.reshape(-1, N)).reshape(B, H, W, N)
    _assert_within_ulp(got.float().numpy(), np.asarray(want.astype(jnp.float32)), S)


def _grads_jax(args, cot, relu):
    def loss(x, w, scale, shift, res):
        y = jfm.matmul_affine_residual_trainable(x, w, scale, shift, res, relu, True)
        return jnp.sum(y * cot)

    return jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3, 4)))(*(jnp.asarray(a) for a in args))


def _grads_torch(args, cot, relu):
    ts = [torch.from_numpy(a).requires_grad_() for a in args]
    y = MatmulAffineResidualFn.apply(*ts, relu)
    (y * torch.from_numpy(cot)).sum().backward()
    return [t.grad for t in ts]


@pytest.mark.parametrize("relu", [True, False])
def test_function_grads_match_jax_trainable(relu):
    args = _inputs(96, 32, 128, seed=3)
    args = args[:3] + (args[3] * 0.3,) + args[4:]
    cot = np.random.RandomState(4).randn(96, 128).astype(np.float32)
    want = _grads_jax(args, cot, relu)
    got = _grads_torch(args, cot, relu)
    for name, g, w in zip(("dx", "dw", "dscale", "dshift", "dres"), got, want):
        assert g.shape == tuple(w.shape), name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-4, rtol=2e-5, err_msg=name)


def test_function_zero_scale_channel_gives_zero_dscale():
    """A zero folded scale (zero-gamma BN) leaves the pre-affine product
    unrecoverable: its dscale is 0, not NaN, as in JAX (:131-140)."""
    args = _inputs(64, 32, 64, seed=5)
    args[2][[3, 17]] = 0.0
    cot = np.random.RandomState(6).randn(64, 64).astype(np.float32)
    got = _grads_torch(args, cot, True)
    want = _grads_jax(args, cot, True)
    assert all(bool(torch.isfinite(g).all()) for g in got)
    assert float(got[2][3]) == 0.0 and float(got[2][17]) == 0.0
    for name, g, w in zip(("dx", "dw", "dscale", "dshift", "dres"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-4, rtol=2e-5, err_msg=name)


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


def _card_args(M=16, K=64, N=32, dtype=torch.bfloat16):
    x = torch.zeros(M, K, dtype=dtype)
    w = torch.zeros(N, K, dtype=dtype).t()  # (K, N), the transpose of a contiguous (N, K)
    return x, w, torch.ones(N), torch.zeros(N), torch.zeros(M, N, dtype=dtype)


def _with(i, value, args=None):
    args = list(_card_args() if args is None else args)
    args[i] = value
    return args


@pytest.mark.parametrize(
    "args, error",
    [
        (_with(0, torch.zeros(2, 16, 64, dtype=torch.bfloat16)), ValueError),  # x not 2-D
        (_with(4, torch.zeros(16, 40, dtype=torch.bfloat16)), ValueError),  # residual (M, N)
        (_with(2, torch.ones(31)), ValueError),  # scale (N,)
        (_with(0, torch.zeros(16, 64, dtype=torch.bfloat16, device="meta")), RuntimeError),
        # on the card: bf16, K and N multiples of 8, contiguous, 16-byte aligned
        (_with(0, _OnCard(torch.zeros(16, 64)), _card_args(dtype=torch.float32)), TypeError),
        (_with(0, _OnCard(torch.zeros(16, 60, dtype=torch.bfloat16)), _card_args(K=60)), ValueError),
        (_with(0, _OnCard(torch.zeros(16, 64, dtype=torch.bfloat16)), _card_args(N=36)), ValueError),
        (_with(0, _OnCard(torch.zeros(64, 16, dtype=torch.bfloat16).t())), ValueError),  # x strided
        (_with(0, _OnCard(torch.zeros(16, 64, dtype=torch.bfloat16)), _with(1, torch.zeros(64, 32, dtype=torch.bfloat16))),
         ValueError),  # w (K, N) contiguous: its transpose is not
        (_with(0, _OnCard(torch.zeros(16 * 64 + 4, dtype=torch.bfloat16)[4:].view(16, 64))), ValueError),  # 8-byte aligned
        (_with(0, _OnCard(torch.zeros(16, 64, dtype=torch.bfloat16)),
               _with(4, torch.zeros(16 * 32 + 4, dtype=torch.bfloat16)[4:].view(16, 32))), ValueError),
        # scale and shift, read in pairs: 8-byte aligned where handed over as they are
        (_with(0, _OnCard(torch.zeros(16, 64, dtype=torch.bfloat16)), _with(2, _OnCard(torch.ones(33)[1:]))),
         ValueError),
        (_with(0, _OnCard(torch.zeros(16, 64, dtype=torch.bfloat16)), _with(3, _OnCard(torch.zeros(33)[1:]))),
         ValueError),
    ],
    ids=["x_rank", "residual_shape", "scale_shape", "device", "dtype", "k_mod_8", "n_mod_8", "x_strided",
         "w_layout", "x_offset", "residual_offset", "scale_offset", "shift_offset"],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(args, error):
    with pytest.raises(error):
        matmul_affine_residual(*args)


def _conv(kind):
    """A port Conv2d of each kind the gate looks at, channels_last, with a
    non-trivial FrozenBN fold."""
    kw = dict(conv3=dict(kernel_size=1, bias=False, norm="FrozenBN", activation=F.relu),
              lateral=dict(kernel_size=1, bias=True),
              conv3x3=dict(kernel_size=3, padding=1, bias=False, norm="FrozenBN", activation=F.relu),
              stride2=dict(kernel_size=1, stride=2, bias=False, norm="FrozenBN"),
              bn_with_bias=dict(kernel_size=1, bias=True, norm="FrozenBN", activation=F.relu))[kind]
    conv = Conv2d(16, 32, **kw)
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for t in conv.state_dict().values():
            t.copy_(torch.rand(t.shape, generator=g) + 0.5 if t.dim() == 1 else torch.randn(t.shape, generator=g) * 0.2)
    return conv.to(memory_format=torch.channels_last)


def spy_fused(monkeypatch):
    """The ``trainable`` flag of every call of the port's
    ``conv1x1_affine_residual``. Each call must hand over x and the residual
    as contiguous NHWC views of channels_last tensors, which the kernel's
    wrapper takes without a copy (on the card it raises on anything else)."""
    calls = []
    orig = tfm.conv1x1_affine_residual

    def spy(*a, **k):
        x, res = a[0], a[4]
        assert x.is_contiguous() and res.is_contiguous(), (x.stride(), res.stride())
        calls.append(k.get("trainable"))
        return orig(*a, **k)

    monkeypatch.setattr(tfm, "conv1x1_affine_residual", spy)
    return calls


@pytest.mark.parametrize("kind", ["conv3", "lateral"])
def test_gate_routes_bf16_1x1_with_residual(monkeypatch, kind):
    calls = spy_fused(monkeypatch)
    conv = _conv(kind)
    x = torch.randn(2, 16, 6, 7).bfloat16().contiguous(memory_format=torch.channels_last)
    r = torch.randn(2, 32, 6, 7).bfloat16().contiguous(memory_format=torch.channels_last)
    monkeypatch.setenv("LVC_TPU_FUSED_RESIDUAL", "0")
    with torch.no_grad():
        unfused = conv(x, residual=r)
    assert calls == []
    monkeypatch.setenv("LVC_TPU_FUSED_RESIDUAL", "1")
    with torch.no_grad():
        fused = conv(x, residual=r)
    assert calls == [False]  # serving, no_grad: the wrapper itself
    conv(x, residual=r)
    assert calls == [False, True]  # autograd records: the Function
    assert fused.dtype == torch.bfloat16 and fused.is_contiguous(memory_format=torch.channels_last)
    # fused and unfused differ by the unfused form's bf16 roundings
    err = (fused.float() - unfused.float()).abs().max() / unfused.float().abs().max()
    assert float(err) < 2e-2


@pytest.mark.parametrize("case", ["unset", "float32", "conv3x3", "stride2", "bn_with_bias", "no_residual"])
def test_gate_does_not_route(monkeypatch, case):
    calls = spy_fused(monkeypatch)
    monkeypatch.setenv("LVC_TPU_FUSED_RESIDUAL", "0" if case == "unset" else "1")
    conv = _conv(case if case in ("conv3x3", "stride2", "bn_with_bias") else "conv3")
    dtype = torch.float32 if case == "float32" else torch.bfloat16
    x = torch.randn(2, 16, 6, 8).to(dtype).contiguous(memory_format=torch.channels_last)
    r = torch.randn(2, 32, 3 if case == "stride2" else 6, 4 if case == "stride2" else 8).to(dtype)
    with torch.no_grad():
        conv(x, residual=None if case == "no_residual" else r.contiguous(memory_format=torch.channels_last))
    assert calls == []


@pytest.mark.parametrize("kind", ["conv3", "lateral"])
def test_fused_conv_matches_jax_fused_conv(monkeypatch, kind):
    """A fused port Conv2d against JAX's fused Conv2d on the same weights and
    bf16 inputs: 1 bf16 ulp per element."""
    conv = _conv(kind)
    rng = np.random.RandomState(7)
    x = rng.randn(2, 6, 7, 16).astype(np.float32)
    r = rng.randn(2, 6, 7, 32).astype(np.float32)
    sd = {k: v.numpy() for k, v in conv.state_dict().items()}
    kernel = sd["weight"].transpose(2, 3, 1, 0)  # (N, K, 1, 1) -> (1, 1, K, N)
    if kind == "conv3":
        jconv = JaxConv2d(32, kernel_size=1, use_bias=False, norm="FrozenBN", activation=jax.nn.relu)
        variables = {
            "params": {"conv": {"kernel": kernel},
                       "FrozenBatchNorm_0": {"weight": sd["norm.weight"], "bias": sd["norm.bias"]}},
            "batch_stats": {"FrozenBatchNorm_0": {"running_mean": sd["norm.running_mean"],
                                                  "running_var": sd["norm.running_var"]}},
        }
    else:
        jconv = JaxConv2d(32, kernel_size=1, use_bias=True)
        variables = {"params": {"conv": {"kernel": kernel, "bias": sd["bias"]}}}
    calls = []
    with jax_fused(monkeypatch, calls), compute_dtype_scope(jnp.bfloat16):
        want = jax.jit(lambda v, a, b: jconv.apply(v, a, residual=b))(
            variables, jnp.asarray(x, jnp.bfloat16), jnp.asarray(r, jnp.bfloat16))
    assert len(calls) == 1
    monkeypatch.setenv("LVC_TPU_FUSED_RESIDUAL", "1")
    to_port = lambda a: torch.from_numpy(a).bfloat16().permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        got = conv(to_port(x), residual=to_port(r))
    scale, shift = conv.norm.folded() if kind == "conv3" else (torch.ones(32), conv.bias)
    S = abs_sum(x.reshape(-1, 16), kernel[0, 0], scale.detach().numpy(), shift.detach().numpy(),
                r.reshape(-1, 32)).reshape(r.shape)
    _assert_within_ulp(got.permute(0, 2, 3, 1).float().numpy(), np.asarray(want.astype(jnp.float32)), S)


def test_from_flax_loads_the_same_weights_fused_or_not(monkeypatch):
    """The fused branch adds and renames no parameter or buffer: the JAX
    variables load strictly into a model built with the variable set or
    unset, and give the same state_dict."""
    from lvc_tpu.config import get_cfg as jax_get_cfg
    from lvc_tpu.modeling.meta_arch.build import build_model as jax_build_model
    from lvc_tpu.utils.init import materialize_variables
    from lvc_tpu_torch.checkpoint.convert import from_flax
    from lvc_tpu_torch.config import get_cfg
    from lvc_tpu_torch.modeling.meta_arch.build import build_model

    def narrow(cfg):
        cfg.merge_from_file("configs/Base-RCNN-FPN.yaml")
        cfg.MODEL.RESNETS.RES2_OUT_CHANNELS = 64
        cfg.MODEL.RESNETS.WIDTH_PER_GROUP = 16
        cfg.MODEL.FPN.OUT_CHANNELS = 64
        return cfg

    batch = {"image": jnp.zeros((1, 64, 64, 3)), "image_size": jnp.asarray([[64, 64]], np.int32)}
    jmodel = jax_build_model(narrow(jax_get_cfg()))
    shapes = jax.eval_shape(functools.partial(jmodel.init, train=False), {"params": jax.random.PRNGKey(0)}, batch)
    state = from_flax(materialize_variables(shapes, seed=0, conv_init="he"))
    loaded = []
    for flag in ("0", "1"):
        monkeypatch.setenv("LVC_TPU_FUSED_RESIDUAL", flag)
        model = build_model(narrow(get_cfg()), device="cpu")
        model.load_state_dict(state, strict=True)
        loaded.append(model.state_dict())
    assert loaded[0].keys() == loaded[1].keys() == state.keys()
    assert all(torch.equal(loaded[0][k], loaded[1][k]) for k in state)
