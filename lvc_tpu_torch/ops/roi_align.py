"""Multi-level RoIAlign: the exact torch gather, the preps of the two serving
pools, their plain versions and the wrappers of their Hopper kernels, and the
training pool (K2 forward, K3 backward, as one ``torch.autograd.Function``).

Counterpart of ``lvc_tpu/ops/roi_align.py``. Layouts are the JAX package's:
features are per-level (B, H, W, C) and boxes (B, R, 4); the pools return
(B, R, P, P, C) in the feature dtype.

Both serving pools compute, per box n and output cell (py, px),

    out[n, py, px, c] = inv[n] * sum_t wx[n, px, t] *
                        sum_r wy[n, py, r] * F_lvl(n)[rows[n, py, r], xs[n] + tcol[n, px, t], c]

from rows, columns and weights that a torch prep computes exactly as the JAX
prep does (``_tiled_prep_band`` :1167 and ``_tiled_prep_2d`` :840). Only the
rows differ:

- band (``pallas_fast``/``pallas_band``, kernel K1): the 4-row band of each
  output row, read at ``min(rel + rb, PR - 1)`` inside the box's patch as at
  ``roi_align.py:1906``, weights ``Wy4``;
- paired (``pallas``, kernel K2): the two corner rows of each of the G grid
  rows, weights ``wy``.

The x weights are the JAX ``WxB`` (``Wx`` summed over the grid, in the
feature dtype, as at ``roi_align.py:2058``), compressed into at most 2G
(column, weight) taps per output column.

Semantics that must hold (and the tests that pin them, in
``tests/test_torch_roi_align.py``): the level bump
``need = ceil(log2(max(fp / (tile - 4), 1)))`` clipped to the coarsest level;
``x1 = max(x1, x0)``; ``t_low`` clamped to ``tile - 1`` in the patch form and
``tile - 2`` otherwise (an over-wide box on p5 collapses its far samples onto
the last window column, which is the JAX behaviour, not a bug); ``d`` clipped
to [0, 2]; the window clamp into unpadded levels; and zero padding of levels
narrower than the tile. A read that JAX makes from pad zeros is a row of -1
or a column past the level's width here, and contributes exactly zero. A
zero-weight read that JAX makes from another level's rows is clamped into
the box's own level instead, so a NaN elsewhere cannot leak in through 0*NaN.
"""
from __future__ import annotations

import math
from typing import List, NamedTuple, Sequence, Tuple

import torch

__all__ = [
    "assign_boxes_to_levels",
    "batched_multilevel_roi_align",
    "roi_align_band",
    "roi_align_paired",
    "roi_align_paired_bwd",
    "pool_band",
    "pool_paired",
    "pool_paired_train",
]


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` as IEEE division on every device. PyTorch's CUDA kernel
    divides by a Python scalar as a multiply by its reciprocal, up to 1 ulp
    off the quotient that the CPU and XLA compute; a 1-ulp sample position
    moves every bilinear weight by the ulp of the coordinate."""
    return x / x.new_full((), d)


def assign_boxes_to_levels(
    boxes: torch.Tensor,
    min_level: int,
    max_level: int,
    canonical_box_size: int = 224,
    canonical_level: int = 4,
) -> torch.Tensor:
    """FPN paper Eqn. (1): offsets from ``min_level`` in [0, max - min]."""
    box_area = (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])
    box_sizes = torch.sqrt(box_area.clamp(min=0.0))
    lvl = torch.floor(canonical_level + torch.log2(_div(box_sizes, canonical_box_size) + 1e-8))
    lvl = lvl.clamp(min_level, max_level)
    return (lvl - min_level).to(torch.int32)


def _f32(values, device) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.float32, device=device)


def _i32(values, device) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.int32, device=device)


# ---------------------------------------------------------------------------
# The exact point gather (``batched_multilevel_roi_align``, XLA in JAX)
# ---------------------------------------------------------------------------


def _bilinear_params(y, x, height, width):
    """Edge rules of ROIAlign_cpu.cpp:56-97: flat offsets (4, ...) within the
    level plane and weights (4, ...)."""
    inside = (y >= -1.0) & (y <= height) & (x >= -1.0) & (x <= width)
    y = y.clamp(min=0.0)
    x = x.clamp(min=0.0)
    y_low = torch.floor(y).to(torch.int32)
    x_low = torch.floor(x).to(torch.int32)
    h_i = height.to(torch.int32)
    w_i = width.to(torch.int32)
    y_capped = y_low >= h_i - 1
    x_capped = x_low >= w_i - 1
    y_low = torch.where(y_capped, h_i - 1, y_low)
    x_low = torch.where(x_capped, w_i - 1, x_low)
    y = torch.where(y_capped, y_low.to(y.dtype), y)
    x = torch.where(x_capped, x_low.to(x.dtype), x)
    y_high = torch.where(y_capped, y_low, y_low + 1)
    x_high = torch.where(x_capped, x_low, x_low + 1)
    ly = y - y_low
    lx = x - x_low
    hy = 1.0 - ly
    hx = 1.0 - lx
    w = torch.stack([hy * hx, hy * lx, ly * hx, ly * lx])
    w = torch.where(inside[None], w, torch.zeros_like(w))
    pos = torch.stack(
        [y_low * w_i + x_low, y_low * w_i + x_high, y_high * w_i + x_low, y_high * w_i + x_high]
    )
    return pos, w


def batched_multilevel_roi_align(
    features: Sequence[torch.Tensor],  # per-level (B, H, W, C)
    boxes: torch.Tensor,  # (B, R, 4)
    strides: Tuple[int, ...],
    output_size: int = 7,
    sampling_ratio: int = 0,
    max_grid: int = 2,
    min_level: int | None = None,
    canonical_box_size: int = 224,
    canonical_level: int = 4,
    chunk: int = 256,
) -> torch.Tensor:
    """Exact RoIAlign by point gather (``POOLER_IMPL="exact"``): aligned=True,
    adaptive grid capped at ``max_grid``, sum in float32. (B, R, P, P, C)."""
    B, R = boxes.shape[:2]
    P = output_size
    C = features[0].shape[-1]
    dtype = features[0].dtype
    device = boxes.device
    if min_level is None:
        min_level = int(math.log2(strides[0]))
    level_shapes = [tuple(f.shape[1:3]) for f in features]
    sizes = [h * w for h, w in level_shapes]
    sum_hw = sum(sizes)
    flat = torch.cat([f.reshape(B, -1, C) for f in features], dim=1).reshape(B * sum_hw, C)
    offsets = [0]
    for s in sizes[:-1]:
        offsets.append(offsets[-1] + s)

    all_boxes = boxes.reshape(B * R, 4).float()
    n = B * R
    L = len(level_shapes)
    if L > 1:
        levels = assign_boxes_to_levels(
            all_boxes, min_level, min_level + L - 1, canonical_box_size, canonical_level
        ).long()
    else:
        levels = torch.zeros(n, dtype=torch.long, device=device)
    scale = _f32([1.0 / s for s in strides], device)[levels]
    h_l = _f32([h for h, _ in level_shapes], device)[levels]
    w_l = _f32([w for _, w in level_shapes], device)[levels]
    img_idx = torch.arange(B, device=device).repeat_interleave(R)
    off_l = _i32(offsets, device)[levels] + (img_idx * sum_hw).to(torch.int32)

    x0 = all_boxes[:, 0] * scale - 0.5
    y0 = all_boxes[:, 1] * scale - 0.5
    x1 = all_boxes[:, 2] * scale - 0.5
    y1 = all_boxes[:, 3] * scale - 0.5
    bin_w = _div(x1 - x0, P)
    bin_h = _div(y1 - y0, P)
    if sampling_ratio > 0:
        G = sampling_ratio
        grid_h = torch.full_like(bin_h, G)
        grid_w = torch.full_like(bin_w, G)
    else:
        G = max_grid
        grid_h = torch.ceil(bin_h).clamp(1, G)
        grid_w = torch.ceil(bin_w).clamp(1, G)
    count = torch.clamp(grid_h * grid_w, min=1.0)
    ph = torch.arange(P, dtype=torch.float32, device=device)
    g = torch.arange(G, dtype=torch.float32, device=device)
    yy = (
        y0[:, None, None]
        + ph[None, :, None] * bin_h[:, None, None]
        + (g[None, None, :] + 0.5) * bin_h[:, None, None] / grid_h[:, None, None]
    )
    xx = (
        x0[:, None, None]
        + ph[None, :, None] * bin_w[:, None, None]
        + (g[None, None, :] + 0.5) * bin_w[:, None, None] / grid_w[:, None, None]
    )
    mask_y = g[None, None, :] < grid_h[:, None, None]
    mask_x = g[None, None, :] < grid_w[:, None, None]
    shape = (n, P, P, G, G)
    y_full = yy[:, :, None, :, None].expand(shape)
    x_full = xx[:, None, :, None, :].expand(shape)
    active = (mask_y[:, :, None, :, None] & mask_x[:, None, :, None, :]).expand(shape)
    hh = h_l[:, None, None, None, None]
    ww = w_l[:, None, None, None, None]
    pos, w = _bilinear_params(y_full, x_full, hh, ww)
    w = torch.where(active[None], w, torch.zeros_like(w))
    pos = pos + off_l[None, :, None, None, None, None]

    out = torch.empty((n, P, P, C), dtype=dtype, device=device)
    for s in range(0, n, chunk):
        p = pos[:, s : s + chunk].long()
        vals = flat[p.reshape(-1)].reshape(p.shape + (C,)).float()
        weighted = vals * w[:, s : s + chunk, ..., None]
        out[s : s + chunk] = (
            weighted.sum(dim=(0, 4, 5)) / count[s : s + chunk, None, None, None]
        ).to(dtype)
    return out.reshape(B, R, P, P, C)


# ---------------------------------------------------------------------------
# Preps: torch copies of ``_tiled_prep_band`` and ``_tiled_prep_2d``
# ---------------------------------------------------------------------------


class _Samples(NamedTuple):
    levels: torch.Tensor  # (n,) int64 level of each box after the bump
    img_idx: torch.Tensor  # (n,) int64
    count: torch.Tensor  # (n,) f32 samples per bin
    G: int
    x_low: torch.Tensor  # (n, P, G) int32 and its fraction, inside and grid masks
    lx: torch.Tensor
    x_ok: torch.Tensor
    y_low: torch.Tensor
    ly: torch.Tensor
    y_ok: torch.Tensor


def _samples(
    level_shapes, B, boxes, strides, P, sampling_ratio, max_grid, min_level,
    canonical_box_size, canonical_level, tile,
) -> _Samples:
    """The sample grid and bilinear corners that both JAX preps compute
    (``roi_align.py:1251-1326`` and ``:884-948``), with the level bump."""
    device = boxes.device
    G = max_grid if sampling_ratio <= 0 else sampling_ratio
    if min_level is None:
        min_level = int(math.log2(strides[0]))
    n = boxes.shape[0] * boxes.shape[1]
    all_boxes = boxes.reshape(n, 4).float()
    img_idx = torch.arange(B, device=device).repeat_interleave(n // B)
    L = len(level_shapes)
    if L > 1:
        levels = assign_boxes_to_levels(
            all_boxes, min_level, min_level + L - 1, canonical_box_size, canonical_level
        ).long()
        # level bump: a box whose footprint on its level exceeds tile - 4
        # pools on a coarser level, clipped to the coarsest
        budget = float(tile - 4)
        max_side = torch.maximum(
            all_boxes[:, 2] - all_boxes[:, 0], all_boxes[:, 3] - all_boxes[:, 1]
        )
        fp = max_side / _f32([float(s) for s in strides], device)[levels]
        need = torch.ceil(torch.log2(torch.clamp(_div(fp, budget), min=1.0))).long()
        levels = torch.clamp(levels + need, max=L - 1)
    else:
        levels = torch.zeros(n, dtype=torch.long, device=device)

    scale = _f32([1.0 / s for s in strides], device)[levels]
    h_l = _f32([h for h, _ in level_shapes], device)[levels]
    w_l = _f32([w for _, w in level_shapes], device)[levels]
    x0 = all_boxes[:, 0] * scale - 0.5
    y0 = all_boxes[:, 1] * scale - 0.5
    # degenerate boxes are empty: the window math needs non-decreasing samples
    x1 = torch.maximum(all_boxes[:, 2] * scale - 0.5, x0)
    y1 = torch.maximum(all_boxes[:, 3] * scale - 0.5, y0)
    bin_w = _div(x1 - x0, P)
    bin_h = _div(y1 - y0, P)
    if sampling_ratio > 0:
        grid_w = torch.full_like(bin_w, G)
        grid_h = torch.full_like(bin_h, G)
    else:
        grid_w = torch.ceil(bin_w).clamp(1, G)
        grid_h = torch.ceil(bin_h).clamp(1, G)
    count = torch.clamp(grid_h * grid_w, min=1.0)
    p_ar = torch.arange(P, dtype=torch.float32, device=device)
    g_ar = torch.arange(G, dtype=torch.float32, device=device)

    def axis(o0, bin_sz, grid, size):
        pos = (
            o0[:, None, None]
            + p_ar[None, :, None] * bin_sz[:, None, None]
            + (g_ar[None, None, :] + 0.5) * bin_sz[:, None, None] / grid[:, None, None]
        )
        valid = g_ar[None, None, :] < grid[:, None, None]
        inside = (pos >= -1.0) & (pos <= size[:, None, None])
        v = pos.clamp(min=0.0)
        low = torch.floor(v).to(torch.int32)
        sz = size.to(torch.int32)[:, None, None]
        capped = low >= sz - 1
        low = torch.where(capped, sz - 1, low)
        frac = torch.where(capped, torch.zeros_like(v), v - low)
        return low, frac, inside & valid

    x_low, lx, x_ok = axis(x0, bin_w, grid_w, w_l)
    y_low, ly, y_ok = axis(y0, bin_h, grid_h, h_l)
    return _Samples(levels, img_idx, count, G, x_low, lx, x_ok, y_low, ly, y_ok)


def _x_weights(s: _Samples, x_start, t_cap: int, tile: int, dtype):
    """``t_low`` and the one-hot x-interpolation matrix Wx (n, P*G, tile),
    rounded to the feature dtype as in JAX."""
    n, P, G = s.x_low.shape
    t_low = torch.clamp(s.x_low - x_start[:, None, None], 0, t_cap)
    zero = torch.zeros_like(s.lx)
    wx0 = torch.where(s.x_ok, 1.0 - s.lx, zero).reshape(n, P * G, 1)
    wx1 = torch.where(s.x_ok, s.lx, zero).reshape(n, P * G, 1)
    t_iota = torch.arange(tile, dtype=torch.int32, device=t_low.device)
    t_f = t_low.reshape(n, P * G, 1)
    Wx = (wx0 * (t_iota == t_f) + wx1 * (t_iota == t_f + 1)).to(dtype)
    return t_low, Wx


class BandPrep(NamedTuple):
    """What ``_tiled_prep_band`` returns, minus the staged ``flat2d`` (the
    port reads the levels in place), plus the level layout of JAX's refs."""

    band_starts: torch.Tensor  # (n, P) int32 rows in JAX's per-level layout
    x_start: torch.Tensor  # (n,) int32
    Wx: torch.Tensor  # (n, P*G, tile) feature dtype
    Wy4: torch.Tensor  # (n, P, 4) f32
    count: torch.Tensor  # (n,) f32
    G: int
    levels: torch.Tensor  # (n,) int64
    t_low: torch.Tensor  # (n, P, G) int32
    rows_per_image: Tuple[int, ...]  # per level; H, or H + pad rows


def tiled_prep_band(
    level_shapes, B, boxes, strides, output_size=7, sampling_ratio=0, max_grid=2,
    min_level=None, canonical_box_size=224, canonical_level=4, tile=32,
    patch=True, dtype=torch.float32,
) -> BandPrep:
    """Torch copy of ``_tiled_prep_band``. ``patch=True`` is the patch form of
    ``..._pallas_patch_ml`` (``row_pad=tile, per_level=True, no_pad=True``);
    ``patch=False`` the flat2d form of ``..._pallas_fast`` (``row_pad=4``)."""
    P = output_size
    s = _samples(
        level_shapes, B, boxes, strides, P, sampling_ratio, max_grid, min_level,
        canonical_box_size, canonical_level, tile,
    )
    device = boxes.device
    if patch:
        # zero-copy levels keep their extent; levels too small for a window
        # are zero-padded by (tile rows, tile cols) per image (:1212-1216)
        padded = tuple(w < tile or B * h < tile for h, w in level_shapes)
        rows_pi = tuple(h + tile if p else h for (h, _), p in zip(level_shapes, padded))
        w_eff = _i32([w + tile if p else w for (_, w), p in zip(level_shapes, padded)], device)
        row_off = s.img_idx * torch.tensor(rows_pi, device=device)[s.levels]
        # window clamped into the (possibly unpadded) level (:1329-1336)
        x_start = torch.minimum(s.x_low[:, 0, 0].clamp(min=0), w_eff[s.levels] - tile)
        t_cap = tile - 1
    else:
        sum_h = sum(h for h, _ in level_shapes)
        rows_pi = (sum_h,) * len(level_shapes)
        offsets = [0]
        for h, _ in level_shapes[:-1]:
            offsets.append(offsets[-1] + h)
        row_off = torch.tensor(offsets, device=device)[s.levels] + s.img_idx * sum_h
        x_start = s.x_low[:, 0, 0]
        t_cap = tile - 2
    t_low, Wx = _x_weights(s, x_start, t_cap, tile, dtype)

    # 4-row band per output row from the gy=0 corner row; the 2G corner
    # weights scatter one-hot over the band slots d and d + 1, d in [0, 2]
    band0 = s.y_low[:, :, 0]
    d = torch.clamp(s.y_low - band0[:, :, None], 0, 2)
    zero = torch.zeros_like(s.ly)
    wy0 = torch.where(s.y_ok, 1.0 - s.ly, zero)
    wy1 = torch.where(s.y_ok, s.ly, zero)
    rb = torch.arange(4, dtype=torch.int32, device=device)
    Wy4 = (wy0[..., None] * (rb == d[..., None])).sum(2) + (
        wy1[..., None] * (rb == (d + 1)[..., None])
    ).sum(2)
    band_starts = (row_off[:, None] + band0).to(torch.int32)
    return BandPrep(
        band_starts, x_start.to(torch.int32), Wx, Wy4.float(), s.count, s.G,
        s.levels, t_low, rows_per_image=rows_pi,
    )


class PairedPrep(NamedTuple):
    """What ``_tiled_prep_2d`` returns, minus ``flat2d``."""

    row_starts: torch.Tensor  # (n, P*G) int32 rows in JAX's flat2d layout
    x_start: torch.Tensor  # (n,) int32
    Wx: torch.Tensor  # (n, P*G, tile) feature dtype
    wy: torch.Tensor  # (n, P*G, 2) f32
    count: torch.Tensor  # (n,) f32
    G: int
    levels: torch.Tensor
    t_low: torch.Tensor
    y_low: torch.Tensor  # (n, P, G) int32 level-local corner row


def tiled_prep_2d(
    level_shapes, B, boxes, strides, output_size=7, sampling_ratio=0, max_grid=2,
    min_level=None, canonical_box_size=224, canonical_level=4, tile=48,
    dtype=torch.float32,
) -> PairedPrep:
    """Torch copy of ``_tiled_prep_2d`` (the paired pool's prep)."""
    P = output_size
    s = _samples(
        level_shapes, B, boxes, strides, P, sampling_ratio, max_grid, min_level,
        canonical_box_size, canonical_level, tile,
    )
    n = s.levels.shape[0]
    device = boxes.device
    sum_h = sum(h for h, _ in level_shapes)
    offsets = [0]
    for h, _ in level_shapes[:-1]:
        offsets.append(offsets[-1] + h)
    row_off = torch.tensor(offsets, device=device)[s.levels] + s.img_idx * sum_h
    x_start = s.x_low[:, 0, 0]
    t_low, Wx = _x_weights(s, x_start, tile - 2, tile, dtype)
    # row y_low + 1 of the pair may be a pad or next-level row in JAX's
    # flat2d; its weight is then 0 (a capped corner has frac 0)
    row_starts = (row_off[:, None, None] + s.y_low).reshape(n, -1).to(torch.int32)
    zero = torch.zeros_like(s.ly)
    wy = torch.stack(
        [torch.where(s.y_ok, 1.0 - s.ly, zero), torch.where(s.y_ok, s.ly, zero)], dim=-1
    ).reshape(n, -1, 2)
    return PairedPrep(
        row_starts, x_start.to(torch.int32), Wx, wy, s.count, s.G, s.levels, t_low, s.y_low
    )


# ---------------------------------------------------------------------------
# Kernel inputs: rows, columns and weights
# ---------------------------------------------------------------------------


class RoiTaps(NamedTuple):
    """The inputs both kernels take, on the features' device."""

    lvl: torch.Tensor  # (n,) int32 level of each box
    xs: torch.Tensor  # (n,) int32 window start column
    inv: torch.Tensor  # (n,) f32 1 / sample count
    rows: torch.Tensor  # (n, P, NR) int32 row in the level's B*H rows, -1 = zero
    wy: torch.Tensor  # (n, P, NR) f32
    tcol: torch.Tensor  # (n, P, NT) int32 column offset from xs
    wx: torch.Tensor  # (n, P, NT) f32


def _taps(Wx, t_low, G: int, tile: int):
    """Compress WxB = sum_g Wx (the JAX kernels' dense (n, P, tile) x weights)
    into its <= 2G nonzero (column, weight) taps per output column. A column
    hit by two grid samples keeps one tap carrying the summed weight."""
    n, P, _ = t_low.shape
    WxB = Wx.reshape(n, P, G, tile).sum(dim=2).float()
    cols = torch.stack([t_low, t_low + 1], dim=-1).reshape(n, P, 2 * G)
    in_tile = cols < tile
    first = torch.ones_like(in_tile)
    for k in range(1, 2 * G):
        first[..., k] = ~(cols[..., k : k + 1] == cols[..., :k]).any(dim=-1)
    cols = cols.clamp(max=tile - 1)
    w = torch.gather(WxB, 2, cols.long())
    w = torch.where(in_tile & first, w, torch.zeros_like(w))
    return cols.to(torch.int32), w


def band_taps(prep: BandPrep, level_shapes, B: int, tile: int, patch: bool) -> RoiTaps:
    """Kernel inputs for K1 from the band prep."""
    device = prep.band_starts.device
    lv = prep.levels
    H = torch.tensor([h for h, _ in level_shapes], device=device)[lv][:, None, None]
    Hp = torch.tensor(prep.rows_per_image, device=device)[lv][:, None, None]
    rb = torch.arange(4, device=device)
    starts = prep.band_starts.long()
    if patch:
        # one tile-row patch per box, its start clamped into the level; band
        # reads past the patch clamp to its last row (zero weight there)
        PR = tile
        patch0 = torch.minimum(starts[:, :1].clamp(min=0), B * Hp[:, :, 0] - PR)
        rel = starts - patch0
        jrow = patch0[:, :, None] + torch.clamp(rel[:, :, None] + rb, max=PR - 1)
        b = torch.div(jrow, Hp, rounding_mode="floor")
        local = jrow - b * Hp
    else:
        sum_h = prep.rows_per_image[0]
        offsets = [0]
        for h, _ in level_shapes[:-1]:
            offsets.append(offsets[-1] + h)
        off = torch.tensor(offsets, device=device)[lv][:, None, None]
        jrow = starts[:, :, None] + rb
        b = torch.div(jrow, sum_h, rounding_mode="floor")
        local = jrow - b * sum_h - off
    real = (local >= 0) & (local < H) & (b < B)
    rows = torch.where(real, b * H + local, torch.full_like(local, -1))
    tcol, wx = _taps(prep.Wx, prep.t_low, prep.G, tile)
    return RoiTaps(
        lv.to(torch.int32), prep.x_start.contiguous(), (1.0 / prep.count).float(),
        rows.to(torch.int32), prep.Wy4, tcol, wx,
    )


def paired_taps(prep: PairedPrep, level_shapes, tile: int) -> RoiTaps:
    """Kernel inputs for K2 from the paired prep. Both corner rows are read
    in the box's own level: the second is clamped to the last row, where
    its weight is 0."""
    device = prep.x_start.device
    lv = prep.levels
    n, P, G = prep.y_low.shape
    H = torch.tensor([h for h, _ in level_shapes], device=device)[lv][:, None, None]
    img = torch.div(prep.row_starts[:, :1].long(), sum(h for h, _ in level_shapes),
                    rounding_mode="floor")[:, :, None]
    y0 = prep.y_low.long()
    pair = torch.stack([y0, torch.minimum(y0 + 1, H - 1)], dim=-1)  # (n, P, G, 2)
    rows = (img[..., None] * H[..., None] + pair).reshape(n, P, 2 * G)
    tcol, wx = _taps(prep.Wx, prep.t_low, G, tile)
    return RoiTaps(
        lv.to(torch.int32), prep.x_start.contiguous(), (1.0 / prep.count).float(),
        rows.to(torch.int32), prep.wy.reshape(n, P, 2 * G).contiguous(), tcol, wx,
    )


# ---------------------------------------------------------------------------
# Plain versions of the two kernels
# ---------------------------------------------------------------------------


def roi_align_taps_plain(
    levels: Sequence[torch.Tensor], taps: RoiTaps, paired: bool, chunk: int = 128
) -> torch.Tensor:
    """The kernels' function in torch ops, with their summation order: per
    tap column the y-combine (band: ((t0 + t1) + t2) + t3; paired: the sum
    over grid rows of (corner0 + corner1)), then the taps in order, then the
    scale by 1/count. Returns (n, P, P, C) in the feature dtype."""
    B, _, _, C = levels[0].shape
    n, P, NR = taps.rows.shape
    NT = taps.tcol.shape[-1]
    out = torch.empty((n, P, P, C), dtype=levels[0].dtype, device=levels[0].device)
    lvl = taps.lvl.long()
    for l, feat in enumerate(levels):
        _, H, W, _ = feat.shape
        flat = feat.reshape(B * H, W, C)
        idx = (lvl == l).nonzero().squeeze(1)
        for s in range(0, idx.numel(), chunk):
            ci = idx[s : s + chunk]
            rows = taps.rows[ci].long()  # (m, P, NR)
            cols = taps.xs[ci].long()[:, None, None] + taps.tcol[ci].long()  # (m, P, NT)
            ok = (rows >= 0)[:, :, :, None, None] & (cols < W)[:, None, None, :, :]
            v = flat[rows.clamp(min=0)[:, :, :, None, None], cols.clamp(max=W - 1)[:, None, None]]
            v = torch.where(ok[..., None], v.float(), torch.zeros((), device=v.device))
            t = v * taps.wy[ci][:, :, :, None, None, None]  # (m, Py, NR, Px, NT, C)
            if paired:
                y = t[:, :, 0] + t[:, :, 1]
                for r in range(2, NR, 2):
                    y = y + (t[:, :, r] + t[:, :, r + 1])
            else:
                y = t[:, :, 0]
                for r in range(1, NR):
                    y = y + t[:, :, r]
            wx = taps.wx[ci][:, None, :, :, None]  # (m, 1, Px, NT, 1)
            acc = y[:, :, :, 0] * wx[:, :, :, 0]
            for k in range(1, NT):
                acc = acc + y[:, :, :, k] * wx[:, :, :, k]
            out[ci] = (acc * taps.inv[ci][:, None, None, None]).to(out.dtype)
    return out


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_MAX_LEVELS = 5
_MAX_P = 16
_MAX_TAPS = 8


class RoiAlignKernel:
    """Wrapper of one RoIAlign kernel of ``csrc/roi_align_fwd.cu``.

    On CPU tensors it returns the plain version. On CUDA tensors it launches
    the kernel (building it on first use) or raises; ``launches`` counts the
    launches and nothing else."""

    def __init__(self, symbol: str, paired: bool):
        self.symbol = symbol
        self.paired = paired
        self.launches = 0

    def __call__(self, levels: Sequence[torch.Tensor], taps: RoiTaps) -> torch.Tensor:
        self._check(levels, taps)
        feat = levels[0]
        if feat.device.type == "cpu":
            return roi_align_taps_plain(levels, taps, self.paired)
        if feat.device.type != "cuda":
            raise RuntimeError(f"RoIAlign kernel: unsupported device {feat.device}")
        import ctypes

        from lvc_tpu_torch.ops import _build

        lib = _build.load_library()
        B, _, _, C = feat.shape
        n, P, NR = taps.rows.shape
        NT = taps.tcol.shape[-1]
        out = torch.empty((n, P, P, C), dtype=feat.dtype, device=feat.device)
        if n == 0:
            return out
        ptrs = (ctypes.c_void_p * _MAX_LEVELS)(*[f.data_ptr() for f in levels])
        hs = (ctypes.c_int * _MAX_LEVELS)(*[f.shape[1] for f in levels])
        ws = (ctypes.c_int * _MAX_LEVELS)(*[f.shape[2] for f in levels])
        err = getattr(lib, self.symbol)(
            ptrs, hs, ws, len(levels), B, C, P, NR, NT, n,
            taps.lvl.data_ptr(), taps.xs.data_ptr(), taps.inv.data_ptr(),
            taps.rows.data_ptr(), taps.wy.data_ptr(), taps.tcol.data_ptr(),
            taps.wx.data_ptr(), out.data_ptr(), 1 if feat.dtype == torch.bfloat16 else 0,
            torch.cuda.current_stream(feat.device).cuda_stream,
        )
        if err != 0:
            raise RuntimeError(f"{self.symbol}: CUDA error {err} at launch")
        self.launches += 1
        return out

    @staticmethod
    def _check(levels, taps: RoiTaps) -> None:
        if not 1 <= len(levels) <= _MAX_LEVELS:
            raise ValueError(f"RoIAlign kernel takes 1..{_MAX_LEVELS} levels, got {len(levels)}")
        feat = levels[0]
        if feat.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"RoIAlign kernel: feature dtype {feat.dtype}")
        B, _, _, C = feat.shape
        vec = 16 // feat.element_size()
        for f in levels:
            if f.dim() != 4 or f.shape[0] != B or f.shape[3] != C:
                raise ValueError(f"level shape {tuple(f.shape)} does not match (B={B}, C={C})")
            if f.dtype != feat.dtype or f.device != feat.device:
                raise ValueError("levels differ in dtype or device")
            if not f.is_contiguous():
                raise ValueError("levels must be contiguous (B, H, W, C)")
            if feat.device.type == "cuda" and (C % vec or f.data_ptr() % 16):
                raise ValueError(f"kernel needs C % {vec} == 0 and 16-byte aligned levels")
        RoiAlignKernel._check_taps(taps, feat.device)

    @staticmethod
    def _check_taps(taps: RoiTaps, device) -> None:
        n, P, NR = taps.rows.shape
        NT = taps.tcol.shape[-1]
        if P > _MAX_P or NR > _MAX_TAPS or NT > _MAX_TAPS:
            raise ValueError(f"P={P}, NR={NR}, NT={NT} over the kernel's limits")
        expect = {
            "lvl": ((n,), torch.int32), "xs": ((n,), torch.int32), "inv": ((n,), torch.float32),
            "rows": ((n, P, NR), torch.int32), "wy": ((n, P, NR), torch.float32),
            "tcol": ((n, P, NT), torch.int32), "wx": ((n, P, NT), torch.float32),
        }
        for name, (shape, dtype) in expect.items():
            t = getattr(taps, name)
            if tuple(t.shape) != shape or t.dtype != dtype:
                raise ValueError(f"taps.{name}: {tuple(t.shape)} {t.dtype}, want {shape} {dtype}")
            if t.device != device or not t.is_contiguous():
                raise ValueError(f"taps.{name} must be contiguous on {device}")


roi_align_band = RoiAlignKernel("roi_align_band_fwd", paired=False)
roi_align_paired = RoiAlignKernel("roi_align_paired_fwd", paired=True)


# ---------------------------------------------------------------------------
# The pools the ROI heads call
# ---------------------------------------------------------------------------


def pool_band(
    features, boxes, strides, output_size=7, sampling_ratio=0, max_grid=2,
    min_level=None, canonical_box_size=224, canonical_level=4, tile=32, patch=True,
) -> torch.Tensor:
    """Band-semantics serving pool (K1). ``patch=True`` is
    ``batched_multilevel_roi_align_pallas_patch_ml`` (``pallas_fast``), whose
    single-level input falls back to the band form as in JAX; ``patch=False``
    is ``..._pallas_fast`` (``pallas_band``). (B, R, P, P, C)."""
    B, R = boxes.shape[:2]
    shapes = [tuple(f.shape[1:3]) for f in features]
    patch = patch and len(features) > 1
    prep = tiled_prep_band(
        shapes, B, boxes, strides, output_size, sampling_ratio, max_grid, min_level,
        canonical_box_size, canonical_level, tile, patch=patch, dtype=features[0].dtype,
    )
    out = roi_align_band(features, band_taps(prep, shapes, B, tile, patch))
    return out.reshape(B, R, output_size, output_size, -1)


def pool_paired(
    features, boxes, strides, output_size=7, sampling_ratio=0, max_grid=2,
    min_level=None, canonical_box_size=224, canonical_level=4, tile=48,
) -> torch.Tensor:
    """Paired pool (K2): ``batched_multilevel_roi_align_pallas_paired``,
    ``POOLER_IMPL`` auto/pallas. (B, R, P, P, C)."""
    B, R = boxes.shape[:2]
    shapes = [tuple(f.shape[1:3]) for f in features]
    prep = tiled_prep_2d(
        shapes, B, boxes, strides, output_size, sampling_ratio, max_grid, min_level,
        canonical_box_size, canonical_level, tile, dtype=features[0].dtype,
    )
    out = roi_align_paired(features, paired_taps(prep, shapes, tile))
    return out.reshape(B, R, output_size, output_size, -1)


# ---------------------------------------------------------------------------
# The training pool: K2 forward, K3 backward
# ---------------------------------------------------------------------------


def roi_align_taps_plain_backward(
    level_shapes: Sequence[Tuple[int, int, int, int]], taps: RoiTaps, gout: torch.Tensor,
    chunk: int = 128,
) -> List[torch.Tensor]:
    """The exact transpose of ``roi_align_taps_plain`` (paired taps): d out ->
    d levels, summed in float32 with ``index_add_``. ``level_shapes`` are the
    levels' (B, H, W, C); ``gout`` is (n, P, P, C). Each term is
    ``(wy * wx) * (inv * gout)``, K3's product. Returns float32 (B, H, W, C)
    per level."""
    n, P, NR = taps.rows.shape
    NT = taps.tcol.shape[-1]
    device = gout.device
    lvl = taps.lvl.long()
    g = gout.float() * taps.inv[:, None, None, None]  # (n, Py, Px, C)
    grads = []
    for l, (B, H, W, C) in enumerate(level_shapes):
        acc = torch.zeros(B * H * W, C, dtype=torch.float32, device=device)
        idx = (lvl == l).nonzero().squeeze(1)
        for s in range(0, idx.numel(), chunk):
            ci = idx[s : s + chunk]
            rows = taps.rows[ci].long()  # (m, Py, NR)
            cols = taps.xs[ci].long()[:, None, None] + taps.tcol[ci].long()  # (m, Px, NT)
            ok = (rows >= 0)[:, :, :, None, None] & (cols < W)[:, None, None, :, :]
            w = taps.wy[ci][:, :, :, None, None] * taps.wx[ci][:, None, None, :, :]
            w = torch.where(ok, w, torch.zeros((), device=device))  # (m, Py, NR, Px, NT)
            pos = rows.clamp(min=0)[:, :, :, None, None] * W + cols.clamp(max=W - 1)[:, None, None]
            contrib = w[..., None] * g[ci][:, :, None, :, None, :]  # (m, Py, NR, Px, NT, C)
            acc.index_add_(0, pos.reshape(-1), contrib.reshape(-1, C))
        grads.append(acc.reshape(B, H, W, C))
    return grads


class RoiAlignBackwardKernel:
    """Wrapper of K3, ``roi_align_paired_bwd`` in ``csrc/roi_align_bwd.cu``.

    Returns the per-level feature gradients (B, H, W, C) in gout's dtype: the
    float32 sums of the plain version, cast once. On CPU tensors it returns
    the plain version so cast; on CUDA tensors it launches the kernel
    (building it on first use), which writes every element once, or raises.
    ``launches`` counts the calls that launched it and nothing else."""

    symbol = "roi_align_paired_bwd"

    def __init__(self):
        self.launches = 0

    def __call__(
        self, level_shapes: Sequence[Tuple[int, int, int, int]], taps: RoiTaps, gout: torch.Tensor
    ) -> List[torch.Tensor]:
        level_shapes = [tuple(int(d) for d in s) for s in level_shapes]
        self._check(level_shapes, taps, gout)
        if gout.device.type == "cpu":
            return [g.to(gout.dtype) for g in roi_align_taps_plain_backward(level_shapes, taps, gout)]
        if gout.device.type != "cuda":
            raise RuntimeError(f"RoIAlign backward kernel: unsupported device {gout.device}")
        import ctypes

        from lvc_tpu_torch.ops import _build

        lib = _build.load_library("roi_align_bwd")  # builds on first use, or raises
        grads = [torch.empty(s, dtype=gout.dtype, device=gout.device) for s in level_shapes]
        n, P, NR = taps.rows.shape
        if n == 0:
            return [g.zero_() for g in grads]
        B = level_shapes[0][0]
        rects = torch.empty((n, 4), dtype=torch.int32, device=gout.device)
        ranges = torch.empty((2 * len(level_shapes) * B,), dtype=torch.int32, device=gout.device)
        ptrs = (ctypes.c_void_p * _MAX_LEVELS)(*[g.data_ptr() for g in grads])
        hs = (ctypes.c_int * _MAX_LEVELS)(*[h for _, h, _, _ in level_shapes])
        ws = (ctypes.c_int * _MAX_LEVELS)(*[w for _, _, w, _ in level_shapes])
        err = getattr(lib, self.symbol)(
            ptrs, hs, ws, len(grads), B, gout.shape[-1], P, NR, taps.tcol.shape[-1], n,
            taps.lvl.data_ptr(), taps.xs.data_ptr(), taps.inv.data_ptr(),
            taps.rows.data_ptr(), taps.wy.data_ptr(), taps.tcol.data_ptr(),
            taps.wx.data_ptr(), gout.data_ptr(), 1 if gout.dtype == torch.bfloat16 else 0,
            rects.data_ptr(), ranges.data_ptr(),
            torch.cuda.current_stream(gout.device).cuda_stream,
        )
        if err != 0:
            raise RuntimeError(f"{self.symbol}: CUDA error {err} at launch")
        self.launches += 1
        return grads

    @staticmethod
    def _check(level_shapes, taps: RoiTaps, gout: torch.Tensor) -> None:
        if not 1 <= len(level_shapes) <= _MAX_LEVELS:
            raise ValueError(f"RoIAlign backward takes 1..{_MAX_LEVELS} levels, got {len(level_shapes)}")
        if gout.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"RoIAlign backward kernel: gout dtype {gout.dtype}")
        C = gout.shape[-1]
        if any(len(s) != 4 or s[3] != C or s[0] != level_shapes[0][0] for s in level_shapes):
            raise ValueError(f"level shapes {level_shapes} do not match gout's C={C}")
        if any(d < 1 for s in level_shapes for d in s):
            raise ValueError(f"level shapes {level_shapes} must not be empty")
        n, P, NR = taps.rows.shape
        if tuple(gout.shape) != (n, P, P, C) or not gout.is_contiguous():
            raise ValueError(f"gout must be contiguous ({n}, {P}, {P}, {C}), got {tuple(gout.shape)}")
        if gout.device.type == "cuda" and (C % (16 // gout.element_size()) or gout.data_ptr() % 16):
            raise ValueError("kernel needs 16-byte vectors of gout channels")
        RoiAlignKernel._check_taps(taps, gout.device)


roi_align_paired_bwd = RoiAlignBackwardKernel()


class _PairedPool(torch.autograd.Function):
    """The training pool (``batched_multilevel_roi_align_pallas_train_ml`` and
    ``..._pallas_trainable``, the custom VJPs at ``roi_align.py:3223`` and
    ``:2388``): forward K2, backward K3, feature grads in the feature dtype
    (K3 sums in f32 and casts, as ``roi_align.py:3276``) and none for the
    boxes (their taps carry no gradient: zero box grads, as ``:3277``)."""

    @staticmethod
    def forward(ctx, taps: RoiTaps, *levels: torch.Tensor) -> torch.Tensor:
        ctx.taps = taps
        ctx.level_shapes = [tuple(f.shape) for f in levels]
        return roi_align_paired(list(levels), taps)

    @staticmethod
    def backward(ctx, gout: torch.Tensor):
        return (None, *roi_align_paired_bwd(ctx.level_shapes, ctx.taps, gout.contiguous()))


def pool_paired_train(
    features, boxes, strides, output_size=7, sampling_ratio=0, max_grid=2,
    min_level=None, canonical_box_size=224, canonical_level=4, tile=48,
) -> torch.Tensor:
    """Differentiable paired pool (``POOLER_IMPL`` pallas_train and
    pallas_train_flat): K2 forward (the same output as the JAX per-level
    train forward ``..._pallas_paired_ml``, whose clamped windows equal the
    padded form) and K3 backward, on any number of levels. (B, R, P, P, C)."""
    B, R = boxes.shape[:2]
    shapes = [tuple(f.shape[1:3]) for f in features]
    with torch.no_grad():
        prep = tiled_prep_2d(
            shapes, B, boxes.detach(), strides, output_size, sampling_ratio, max_grid,
            min_level, canonical_box_size, canonical_level, tile, dtype=features[0].dtype,
        )
        taps = paired_taps(prep, shapes, tile)
    out = _PairedPool.apply(taps, *features)
    return out.reshape(B, R, output_size, output_size, -1)
