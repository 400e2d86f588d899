"""Multi-level RoIAlign for the plain reference, with the port's paired-pool
semantics (``lvc_tpu_torch/ops/roi_align.py`` at commit 7572f27:
``assign_boxes_to_levels``, ``_samples``, ``_x_weights``, ``tiled_prep_2d``,
``_taps``, ``paired_taps``, copied). The semantics include two departures
from detectron2's ``ROIPooler`` that the configuration's POOLER_IMPL
``auto`` runs on the card (K2 forward, K3 backward): a box whose footprint
on its FPN level exceeds the 44-pixel window pools on a coarser level, and
the x taps of a window are clamped to it. The pooled value is the sum over
(row tap, column tap) of ``wy * wx * feature``, evaluated here as one
gather and a weighted sum in float32 (or float64), differentiable through
autograd, in chunks that recompute in the backward so that the gathered
values are never all held at once.
"""
from __future__ import annotations

import math
from typing import List, NamedTuple, Sequence

import torch
from torch.utils.checkpoint import checkpoint

TILE = 48  # the paired pool's window width


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    return x / x.new_full((), d)


def _f32(values, device):
    return torch.tensor(values, dtype=torch.float32, device=device)


def assign_levels(boxes, min_level: int, max_level: int, canonical_box_size=224, canonical_level=4):
    box_sizes = torch.sqrt(((boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])).clamp(min=0.0))
    lvl = torch.floor(canonical_level + torch.log2(_div(box_sizes, canonical_box_size) + 1e-8))
    return (lvl.clamp(min_level, max_level) - min_level).to(torch.int32)


class Taps(NamedTuple):
    lvl: torch.Tensor  # (n,) level of each box
    xs: torch.Tensor  # (n,) window start column
    inv: torch.Tensor  # (n,) 1 / samples per bin
    rows: torch.Tensor  # (n, P, 2G) level-local row in the level's B*H rows
    wy: torch.Tensor  # (n, P, 2G)
    tcol: torch.Tensor  # (n, P, 2G) column offset from xs
    wx: torch.Tensor  # (n, P, 2G)


def paired_taps(level_shapes, B: int, boxes: torch.Tensor, strides, P: int, max_grid: int = 2,
                dtype=torch.float32) -> Taps:
    """Rows, columns and weights of every bin of every box (sampling ratio
    0: an adaptive grid of at most ``max_grid`` per axis); ``boxes`` (B, R, 4)."""
    device = boxes.device
    G = max_grid
    min_level = int(math.log2(strides[0]))
    n = boxes.shape[0] * boxes.shape[1]
    all_boxes = boxes.reshape(n, 4).float()
    img_idx = torch.arange(B, device=device).repeat_interleave(n // B)
    L = len(level_shapes)
    levels = assign_levels(all_boxes, min_level, min_level + L - 1).long()
    budget = float(TILE - 4)
    max_side = torch.maximum(all_boxes[:, 2] - all_boxes[:, 0], all_boxes[:, 3] - all_boxes[:, 1])
    fp = max_side / _f32([float(s) for s in strides], device)[levels]
    need = torch.ceil(torch.log2(torch.clamp(_div(fp, budget), min=1.0))).long()
    levels = torch.clamp(levels + need, max=L - 1)

    scale = _f32([1.0 / s for s in strides], device)[levels]
    h_l = _f32([h for h, _ in level_shapes], device)[levels]
    w_l = _f32([w for _, w in level_shapes], device)[levels]
    x0 = all_boxes[:, 0] * scale - 0.5
    y0 = all_boxes[:, 1] * scale - 0.5
    x1 = torch.maximum(all_boxes[:, 2] * scale - 0.5, x0)
    y1 = torch.maximum(all_boxes[:, 3] * scale - 0.5, y0)
    bin_w = _div(x1 - x0, P)
    bin_h = _div(y1 - y0, P)
    grid_w = torch.ceil(bin_w).clamp(1, G)
    grid_h = torch.ceil(bin_h).clamp(1, G)
    count = torch.clamp(grid_h * grid_w, min=1.0)
    p_ar = torch.arange(P, dtype=torch.float32, device=device)
    g_ar = torch.arange(G, dtype=torch.float32, device=device)

    def axis(o0, bin_sz, grid, size):
        pos = (o0[:, None, None] + p_ar[None, :, None] * bin_sz[:, None, None]
               + (g_ar[None, None, :] + 0.5) * bin_sz[:, None, None] / grid[:, None, None])
        ok = (g_ar[None, None, :] < grid[:, None, None]) & (pos >= -1.0) & (pos <= size[:, None, None])
        v = pos.clamp(min=0.0)
        low = torch.floor(v).to(torch.int32)
        sz = size.to(torch.int32)[:, None, None]
        capped = low >= sz - 1
        low = torch.where(capped, sz - 1, low)
        frac = torch.where(capped, torch.zeros_like(v), v - low)
        return low, frac, ok

    x_low, lx, x_ok = axis(x0, bin_w, grid_w, w_l)
    y_low, ly, y_ok = axis(y0, bin_h, grid_h, h_l)

    # x: one-hot interpolation over the window, rounded to the feature
    # dtype, summed over the grid, compressed into <= 2G (column, weight) taps
    x_start = x_low[:, 0, 0]
    t_low = torch.clamp(x_low - x_start[:, None, None], 0, TILE - 2)
    zero = torch.zeros_like(lx)
    wx0 = torch.where(x_ok, 1.0 - lx, zero).reshape(n, P * G, 1)
    wx1 = torch.where(x_ok, lx, zero).reshape(n, P * G, 1)
    t_iota = torch.arange(TILE, dtype=torch.int32, device=device)
    t_f = t_low.reshape(n, P * G, 1)
    Wx = (wx0 * (t_iota == t_f) + wx1 * (t_iota == t_f + 1)).to(dtype)
    WxB = Wx.reshape(n, P, G, TILE).sum(dim=2).float()
    cols = torch.stack([t_low, t_low + 1], dim=-1).reshape(n, P, 2 * G)
    in_tile = cols < TILE
    first = torch.ones_like(in_tile)
    for k in range(1, 2 * G):
        first[..., k] = ~(cols[..., k:k + 1] == cols[..., :k]).any(dim=-1)
    cols = cols.clamp(max=TILE - 1)
    wx = torch.gather(WxB, 2, cols.long())
    wx = torch.where(in_tile & first, wx, torch.zeros_like(wx))

    # y: the two corner rows of each grid row, read in the box's own level
    H = torch.tensor([h for h, _ in level_shapes], device=device)[levels][:, None, None]
    y0r = y_low.long()
    pair = torch.stack([y0r, torch.minimum(y0r + 1, H - 1)], dim=-1)
    rows = (img_idx[:, None, None, None] * H[..., None] + pair).reshape(n, P, 2 * G)
    zero = torch.zeros_like(ly)
    wy = torch.stack([torch.where(y_ok, 1.0 - ly, zero), torch.where(y_ok, ly, zero)], dim=-1).reshape(n, P, 2 * G)
    return Taps(levels, x_start.long(), 1.0 / count, rows, wy, cols.long(), wx)


def _pool_chunk(flat: torch.Tensor, W: int, rows, xs, tcol, weight) -> torch.Tensor:
    """(m, P, P, C): sum over (row tap r, column tap t) of weight[m, py, r,
    px, t] * flat[rows[m, py, r] * W + xs[m] + tcol[m, px, t]]."""
    cols = xs[:, None, None] + tcol  # (m, P, NT)
    ok = cols < W
    idx = rows[:, :, :, None, None] * W + cols.clamp(max=W - 1)[:, None, None]  # (m, Py, NR, Px, NT)
    w = torch.where(ok[:, None, None], weight, torch.zeros((), dtype=weight.dtype, device=weight.device))
    v = flat[idx.reshape(-1)].reshape(idx.shape + (flat.shape[-1],))
    return (v * w[..., None].to(v.dtype)).sum(dim=(2, 4))


def roi_align(levels: Sequence[torch.Tensor], boxes: torch.Tensor, strides, P: int, chunk: int = 512):
    """``levels``: per-level (B, C, H, W) features; ``boxes`` (B, R, 4) ->
    (B, R, P, P, C) in the features' dtype, summed in float32 (float64 for
    float64 features)."""
    B, R = boxes.shape[:2]
    shapes = [tuple(f.shape[2:4]) for f in levels]
    with torch.no_grad():
        taps = paired_taps(shapes, B, boxes.detach(), strides, P, dtype=levels[0].dtype)
    sum_dtype = torch.float64 if levels[0].dtype == torch.float64 else torch.float32
    n = B * R
    C = levels[0].shape[1]
    out: List[torch.Tensor] = []
    order = []
    for lv, feat in enumerate(levels):
        idx = (taps.lvl == lv).nonzero().squeeze(1)
        if idx.numel() == 0:
            continue
        _, _, H, W = feat.shape
        flat = feat.permute(0, 2, 3, 1).reshape(B * H * W, C).to(sum_dtype)
        for s in range(0, idx.numel(), chunk):
            ci = idx[s:s + chunk]
            weight = (taps.wy[ci][:, :, :, None, None] * taps.wx[ci][:, None, None, :, :]
                      * taps.inv[ci][:, None, None, None, None]).to(sum_dtype)
            args = (flat, W, taps.rows[ci], taps.xs[ci], taps.tcol[ci], weight)
            part = checkpoint(_pool_chunk, *args, use_reentrant=False) if flat.requires_grad else _pool_chunk(*args)
            out.append(part)
            order.append(ci)
    pooled = torch.cat(out)
    inv_order = torch.empty(n, dtype=torch.long, device=boxes.device)
    inv_order[torch.cat(order)] = torch.arange(n, device=boxes.device)
    return pooled[inv_order].to(levels[0].dtype).reshape(B, R, P, P, C)
