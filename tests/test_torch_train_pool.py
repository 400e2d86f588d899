"""The port's training pool (``pool_paired_train``: K2 forward, K3 backward,
here their plain versions on the CPU) against the JAX package.

- Forward and feature gradients against
  ``batched_multilevel_roi_align_pallas_train_ml`` (``POOLER_IMPL``
  pallas_train), whose forward (``..._pallas_paired_ml``) and backward
  (``_roi_align_ml_bwd_impl``) run in interpret mode for the module's
  duration, on the two cases of tests/test_roi_align.py's train-pool tests:
  "corner" (B=2, R=12, C=256, five levels from 64x96, boxes hugging the last
  image's bottom-right corner: the clamped windows) and "tiny" (B=1, R=6,
  C=96, two levels smaller than the window). f32, rtol/atol 1e-5.
- The backward of ``pallas_train_flat`` and the single-level fallback of
  ``pallas_train``, ``_roi_align_paired_bwd_impl(interpret=True)``, on the
  tiny case's two levels and on its first level alone. f32, rtol/atol 1e-5.
- The plain backward against torch autograd of the plain forward in
  float64 (rtol 1e-5, atol 1e-6: the plain backward sums in float32).
- bf16 features: the forward and the gradients come back bf16, the
  gradients within 1 bf16 ulp of the float32 result on the same values.

The JAX side is computed once per module: interpret mode takes minutes.
"""
import functools

import numpy as np
import pytest

import jax.numpy as jnp
import jax
import torch

import lvc_tpu.ops.roi_align as jra
from lvc_tpu_torch.modeling.roi_heads.roi_heads import StandardROIHeads
from lvc_tpu_torch.ops import roi_align as tra
from test_torch_roi_cases import CASES


def _corner():
    rng = np.random.RandomState(13)
    B, R, C = 2, 12, 256
    feats, (h, w) = [], (64, 96)
    for _ in range(5):
        feats.append(rng.rand(B, h, w, C).astype(np.float32))
        h, w = (h + 1) // 2, (w + 1) // 2
    s = rng.uniform(8, 250, (B, R))
    ar = rng.uniform(0.5, 2.0, (B, R))
    bw, bh = s * np.sqrt(ar), s / np.sqrt(ar)
    x0 = rng.uniform(0, 1, (B, R)) * (384 - bw)
    y0 = rng.uniform(0, 1, (B, R)) * (256 - bh)
    x0[-1, :3] = 384 - bw[-1, :3]
    y0[-1, :3] = 256 - bh[-1, :3]
    boxes = np.stack([x0, y0, x0 + bw, y0 + bh], -1).astype(np.float32)
    gout = rng.rand(B, R, 7, 7, C).astype(np.float32)
    return feats, boxes, (4, 8, 16, 32, 64), gout


def _tiny():
    rng = np.random.RandomState(5)
    B, R, C = 1, 6, 96
    feats, (h, w) = [], (16, 24)
    for _ in range(2):
        feats.append(rng.rand(B, h, w, C).astype(np.float32))
        h, w = (h + 1) // 2, (w + 1) // 2
    x0, y0 = rng.uniform(0, 30, (B, R)), rng.uniform(0, 20, (B, R))
    bw, bh = rng.uniform(6, 30, (B, R)), rng.uniform(6, 20, (B, R))
    boxes = np.stack([x0, y0, x0 + bw, y0 + bh], -1).astype(np.float32)
    gout = rng.rand(B, R, 7, 7, C).astype(np.float32)
    return feats, boxes, (4, 8), gout


TRAIN_CASES = {"corner": _corner, "tiny": _tiny}
POOL_ARGS = (7, 0, 2, None, 224, 4, 48)  # output_size .. tile, as the ROI heads pass them


@pytest.fixture(scope="module")
def jax_train_ml():
    """case -> (forward, feature grads) of the JAX pallas_train pool."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for name in ("batched_multilevel_roi_align_pallas_paired_ml", "_roi_align_ml_bwd_impl"):
            mp.setattr(jra, name, functools.partial(getattr(jra, name), interpret=True))
        for case, make in TRAIN_CASES.items():
            feats, boxes, strides, gout = make()
            fwd, vjp = jax.vjp(
                lambda fs: jra.batched_multilevel_roi_align_pallas_train_ml(
                    fs, jnp.asarray(boxes), strides
                ),
                tuple(jnp.asarray(f) for f in feats),
            )
            (grads,) = vjp(jnp.asarray(gout))
            out[case] = np.asarray(fwd), [np.asarray(g) for g in grads]
    return out


def _port(feats, boxes, strides, gout, dtype=torch.float32):
    levels = [torch.from_numpy(f).to(dtype).requires_grad_() for f in feats]
    out = tra.pool_paired_train(levels, torch.from_numpy(boxes), strides)
    grads = torch.autograd.grad(out, levels, torch.from_numpy(gout).to(dtype).reshape(out.shape))
    return out.detach(), grads


def _launches():
    return tra.roi_align_paired.launches, tra.roi_align_paired_bwd.launches


@pytest.mark.parametrize("case", sorted(TRAIN_CASES))
def test_train_pool_matches_jax_pallas_train(jax_train_ml, case):
    want_out, want_grads = jax_train_ml[case]
    before = _launches()
    out, grads = _port(*TRAIN_CASES[case]())
    assert _launches() == before  # CPU tensors take the plain versions
    np.testing.assert_allclose(out.numpy(), want_out, rtol=1e-5, atol=1e-5)
    assert len(grads) == len(want_grads)
    for got, want in zip(grads, want_grads):
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("levels", [1, 2], ids=["single_level", "flat"])
def test_train_pool_backward_matches_jax_flat_backward(levels):
    feats, boxes, strides, gout = _tiny()
    feats, strides = feats[:levels], strides[:levels]
    want = jra._roi_align_paired_bwd_impl(
        [jnp.asarray(f) for f in feats], jnp.asarray(boxes), strides, *POOL_ARGS,
        jnp.asarray(gout), interpret=True,
    )
    _, grads = _port(feats, boxes, strides, gout)
    assert len(grads) == levels
    for got, w in zip(grads, want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_backward_is_the_transpose_of_the_plain_forward(case):
    feats, boxes, strides = CASES[case]()
    shapes = [f.shape[1:3] for f in feats]
    taps = tra.paired_taps(tra.tiled_prep_2d(shapes, feats[0].shape[0], torch.from_numpy(boxes), strides), shapes, 48)
    t64 = taps._replace(wy=taps.wy.double(), wx=taps.wx.double(), inv=taps.inv.double())
    levels = [torch.from_numpy(f).double().requires_grad_() for f in feats]
    out = tra.roi_align_taps_plain(levels, t64, paired=True)
    gout = torch.from_numpy(np.random.RandomState(0).rand(*out.shape))
    want = torch.autograd.grad(out, levels, gout, allow_unused=True)
    got = tra.roi_align_taps_plain_backward([f.shape for f in feats], taps, gout.float())
    for g, w, f in zip(got, want, levels):
        assert g.dtype == torch.float32
        w = torch.zeros_like(f) if w is None else w
        np.testing.assert_allclose(g.double().numpy(), w.numpy(), rtol=1e-5, atol=1e-6)
    assert any(float(g.abs().sum()) > 0 for g in got)


def test_bf16_grads_within_one_ulp_of_f32():
    """bf16 features: the grads are the float32 accumulation of the same taps
    (the prep rounds the x weights to the feature dtype, as in JAX) and the
    same bf16 gout, cast to bf16."""
    feats, boxes, strides, gout = _corner()
    out16, g16 = _port(feats, boxes, strides, gout, torch.bfloat16)
    shapes = [f.shape[1:3] for f in feats]
    prep = tra.tiled_prep_2d(shapes, feats[0].shape[0], torch.from_numpy(boxes), strides, dtype=torch.bfloat16)
    g32 = tra.roi_align_taps_plain_backward(
        [f.shape for f in feats], tra.paired_taps(prep, shapes, 48),
        torch.from_numpy(gout).bfloat16().reshape(-1, 7, 7, gout.shape[-1]),
    )
    assert out16.dtype == torch.bfloat16
    for a, b in zip(g16, g32):
        assert a.dtype == torch.bfloat16
        ulp = torch.exp2(torch.floor(torch.log2(b.abs().clamp(min=2.0 ** -126))) - 7)
        assert bool(((a.float() - b).abs() <= ulp).all())


def test_train_pool_dispatch(monkeypatch):
    """Training: auto -> pallas_train on CUDA and exact off it; every other
    pallas* -> the train pool; pallas_train_flat stays the train pool."""
    calls = []
    for name in ("pool_paired_train", "pool_paired", "pool_band", "batched_multilevel_roi_align"):
        monkeypatch.setattr(tra, name, lambda *a, _n=name, **k: calls.append(_n))
    feats = {f"p{i}": torch.zeros(1, 8, 4, 4).contiguous(memory_format=torch.channels_last)
             for i in range(2, 6)}
    boxes = torch.zeros(1, 3, 4)
    cases = [("auto", "batched_multilevel_roi_align"), ("exact", "batched_multilevel_roi_align")] + [
        (impl, "pool_paired_train")
        for impl in ("pallas", "pallas_fast", "pallas_band", "pallas_train", "pallas_train_flat")
    ]
    for impl, want in cases:
        heads = StandardROIHeads(
            ("p2", "p3", "p4", "p5"), {"p2": 4, "p3": 8, "p4": 16, "p5": 32}, 8,
            num_classes=3, fc_dim=16, pooler_impl=impl,
        ).train()
        calls.clear()
        heads.pool(feats, boxes)
        assert calls == [want], impl
