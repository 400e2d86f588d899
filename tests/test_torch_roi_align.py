"""The port's RoIAlign (preps, plain versions of K1/K2, exact gather) against
the JAX package on the CPU. (The CUDA kernels against their plain versions:
tests/test_torch_kernels_cuda.py.)

Two input sets from tests/test_torch_roi_cases.py, made with numpy from a seed:
- "pyramid": B=2, four levels from 32x48 (strides 4-32), C=64, random boxes
  plus canvas-sized, corner-hugging and degenerate ones (the cases of
  tests/test_roi_align.py::test_pallas_patch_ml_bit_identical_to_band). Its
  p4/p5 are narrower than the tile and B*H of p5 is below it: the padded-level
  path.
- "wide": B=1, two unpadded levels 64x128 and 32x64 (strides 4, 8), C=96,
  with boxes too wide for the coarsest level's window (the window clamp and
  the t_low clamp: the far samples collapse onto the last window column, as
  in JAX), some at the bottom edge (the patch-row clamp).
Tolerances: preps are exact in their ints and to 1e-6 in their floats; pools
at float32 to atol 1e-5 (the kernels' sums run in another order than the
interpret-mode dots).
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

import lvc_tpu.ops.roi_align as jra
from lvc_tpu_torch.ops import roi_align as tra
from test_torch_roi_cases import CASES, _pyramid


def _shapes(feats):
    return [f.shape[1:3] for f in feats]


def _close(a, b, atol):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64), atol=atol, rtol=0)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("patch", [True, False], ids=["patch", "flat2d"])
def test_band_prep_matches_jax(case, patch):
    feats, boxes, strides = CASES[case]()
    kw = dict(row_pad=32, per_level=True, no_pad=True) if patch else {}
    j = jra._tiled_prep_band(
        [jnp.asarray(f) for f in feats], jnp.asarray(boxes), strides, 7, 0, 2, None, 224, 4, 32, **kw
    )
    t = tra.tiled_prep_band(_shapes(feats), feats[0].shape[0], torch.from_numpy(boxes), strides,
                            tile=32, patch=patch)
    for name, jv, tv in [("band_starts", j[1], t.band_starts), ("x_start", j[2], t.x_start),
                         ("levels", j[8], t.levels)]:
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv), err_msg=name)
    for name, jv, tv in [("Wx", j[3], t.Wx), ("Wy4", j[4], t.Wy4), ("count", j[5], t.count)]:
        _close(tv.numpy(), jv, 1e-6)
    if patch:
        # JAX's per-level refs: padded levels are (H + tile) rows per image
        rows = [f.shape[0] // feats[0].shape[0] for f in j[0]]
        assert tuple(rows) == t.rows_per_image


@pytest.mark.parametrize("case", sorted(CASES))
def test_paired_prep_matches_jax(case):
    feats, boxes, strides = CASES[case]()
    j = jra._tiled_prep_2d(
        [jnp.asarray(f) for f in feats], jnp.asarray(boxes), strides, 7, 0, 2, None, 224, 4, 48
    )
    t = tra.tiled_prep_2d(_shapes(feats), feats[0].shape[0], torch.from_numpy(boxes), strides, tile=48)
    np.testing.assert_array_equal(t.row_starts.numpy(), np.asarray(j[1]))
    np.testing.assert_array_equal(t.x_start.numpy(), np.asarray(j[2]))
    for jv, tv in [(j[3], t.Wx), (j[4], t.wy), (j[5], t.count)]:
        _close(tv.numpy(), jv, 1e-6)


def _launches():
    return tra.roi_align_band.launches, tra.roi_align_paired.launches


@pytest.mark.parametrize(
    "case,jax_fn,port",
    [
        ("pyramid", "batched_multilevel_roi_align_pallas_patch_ml", "band"),
        ("wide", "batched_multilevel_roi_align_pallas_patch_ml", "band"),
        ("pyramid", "batched_multilevel_roi_align_pallas_fast", "band_flat2d"),
        ("pyramid", "batched_multilevel_roi_align_pallas_paired", "paired"),
        ("wide", "batched_multilevel_roi_align_pallas_paired", "paired"),
    ],
)
def test_plain_kernels_match_jax_interpret(case, jax_fn, port):
    feats, boxes, strides = CASES[case]()
    want = getattr(jra, jax_fn)(
        [jnp.asarray(f) for f in feats], jnp.asarray(boxes), strides, interpret=True
    )
    tfeats = [torch.from_numpy(f) for f in feats]
    before = _launches()
    if port == "paired":
        got = tra.pool_paired(tfeats, torch.from_numpy(boxes), strides)
    else:
        got = tra.pool_band(tfeats, torch.from_numpy(boxes), strides, patch=(port == "band"))
    assert _launches() == before  # a CPU call takes the plain version
    assert got.shape == want.shape
    _close(got.numpy(), want, 1e-5)


@pytest.mark.parametrize("case", sorted(CASES))
def test_exact_gather_matches_jax(case):
    feats, boxes, strides = CASES[case]()
    want = jra.batched_multilevel_roi_align([jnp.asarray(f) for f in feats], jnp.asarray(boxes), strides)
    got = tra.batched_multilevel_roi_align([torch.from_numpy(f) for f in feats], torch.from_numpy(boxes), strides)
    # 2e-5: on "wide" JAX's own float32 reduction is 1.2e-5 away from a
    # float64 sum of its own samples and weights, where the port is within 1e-7
    _close(got.numpy(), want, 2e-5)


def test_wrapper_rejects_bad_inputs():
    feats, boxes, strides = _pyramid()
    tfeats = [torch.from_numpy(f) for f in feats]
    shapes = _shapes(feats)
    prep = tra.tiled_prep_2d(shapes, 2, torch.from_numpy(boxes), strides)
    taps = tra.paired_taps(prep, shapes, 48)
    with pytest.raises(ValueError, match="contiguous"):
        tra.roi_align_paired([f.transpose(1, 2) for f in tfeats], taps)
    with pytest.raises(ValueError, match="taps.rows"):
        tra.roi_align_paired(tfeats, taps._replace(rows=taps.rows.long()))
    with pytest.raises(TypeError):
        tra.roi_align_paired([f.double() for f in tfeats], taps)
