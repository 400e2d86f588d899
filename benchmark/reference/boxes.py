"""Box geometry, anchors, NMS, matching and seeded sampling for the plain
reference: frozen copies of the port's arithmetic at commit 7572f27
(``lvc_tpu_torch/structures/boxes.py``, ``modeling/anchors.py``,
``modeling/box_regression.py``, ``ops/nms.py``, ``modeling/matcher.py``,
``modeling/sampling.py``). The reference must draw the same sampling
priorities from the same per-image generators as the port, and make the
same discrete choices from the same numbers, so these keep the port's
operation order. Nothing here imports the port.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np
import torch

NEG_INF = -1e10
SCALE_CLAMP = math.log(1000.0 / 16)


# ----------------------------------------------------------------- geometry

def area(b: torch.Tensor) -> torch.Tensor:
    return (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])


def clip(boxes: torch.Tensor, height, width) -> torch.Tensor:
    height = torch.as_tensor(height, dtype=boxes.dtype, device=boxes.device)
    width = torch.as_tensor(width, dtype=boxes.dtype, device=boxes.device)
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    x0 = torch.minimum(torch.maximum(boxes[..., 0], zero), width)
    y0 = torch.minimum(torch.maximum(boxes[..., 1], zero), height)
    x1 = torch.minimum(torch.maximum(boxes[..., 2], zero), width)
    y1 = torch.minimum(torch.maximum(boxes[..., 3], zero), height)
    return torch.stack([x0, y0, x1, y1], dim=-1)


def nonempty(boxes: torch.Tensor, threshold: float = 0.0) -> torch.Tensor:
    return ((boxes[..., 2] - boxes[..., 0]) > threshold) & ((boxes[..., 3] - boxes[..., 1]) > threshold)


def pairwise_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area(boxes1)[..., :, None] + area(boxes2)[..., None, :] - inter
    safe = torch.where(union > 0, union, torch.ones_like(union))
    return torch.where(inter > 0, inter / safe, torch.zeros_like(inter))


def get_deltas(weights, src: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
    src_w = src[..., 2] - src[..., 0]
    src_h = src[..., 3] - src[..., 1]
    src_cx = src[..., 0] + 0.5 * src_w
    src_cy = src[..., 1] + 0.5 * src_h
    tgt_w = tgt[..., 2] - tgt[..., 0]
    tgt_h = tgt[..., 3] - tgt[..., 1]
    tgt_cx = tgt[..., 0] + 0.5 * tgt_w
    tgt_cy = tgt[..., 1] + 0.5 * tgt_h
    wx, wy, ww, wh = weights
    one = torch.ones((), dtype=src_w.dtype, device=src_w.device)
    safe_w = torch.where(src_w > 0, src_w, one)
    safe_h = torch.where(src_h > 0, src_h, one)
    dx = wx * (tgt_cx - src_cx) / safe_w
    dy = wy * (tgt_cy - src_cy) / safe_h
    dw = ww * torch.log(torch.where(tgt_w > 0, tgt_w, one) / safe_w)
    dh = wh * torch.log(torch.where(tgt_h > 0, tgt_h, one) / safe_h)
    return torch.stack([dx, dy, dw, dh], dim=-1)


def apply_deltas(weights, deltas: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """(..., K*4) deltas on (..., 4) boxes -> (..., K*4) boxes."""
    boxes = boxes.to(deltas.dtype)
    widths = boxes[..., 2] - boxes[..., 0]
    heights = boxes[..., 3] - boxes[..., 1]
    ctr_x = boxes[..., 0] + 0.5 * widths
    ctr_y = boxes[..., 1] + 0.5 * heights
    wx, wy, ww, wh = (deltas.new_full((), float(w)) for w in weights)
    d = deltas.reshape(deltas.shape[:-1] + (-1, 4))
    dx = d[..., 0] / wx
    dy = d[..., 1] / wy
    dw = torch.clamp(d[..., 2] / ww, max=SCALE_CLAMP)
    dh = torch.clamp(d[..., 3] / wh, max=SCALE_CLAMP)
    pred_cx = dx * widths[..., None] + ctr_x[..., None]
    pred_cy = dy * heights[..., None] + ctr_y[..., None]
    pred_w = torch.exp(dw) * widths[..., None]
    pred_h = torch.exp(dh) * heights[..., None]
    out = torch.stack([pred_cx - 0.5 * pred_w, pred_cy - 0.5 * pred_h,
                       pred_cx + 0.5 * pred_w, pred_cy + 0.5 * pred_h], dim=-1)
    return out.reshape(deltas.shape)


# ------------------------------------------------------------------ anchors

def cell_anchors(sizes: Sequence[float], aspect_ratios: Sequence[float]) -> np.ndarray:
    out = []
    for size in sizes:
        a = size ** 2.0
        for ar in aspect_ratios:
            w = np.sqrt(a / ar)
            h = ar * w
            out.append([-w / 2.0, -h / 2.0, w / 2.0, h / 2.0])
    return np.asarray(out, dtype=np.float32)


def grid_anchors(sizes, aspect_ratios, strides, grid_sizes, device) -> List[torch.Tensor]:
    """Per-level (H*W*A, 4) float32 anchors, row-major over (y, x, anchor),
    computed in float64 and cast (offset 0)."""
    if len(sizes) == 1:
        sizes = list(sizes) * len(strides)
    if len(aspect_ratios) == 1:
        aspect_ratios = list(aspect_ratios) * len(strides)
    out = []
    for (h, w), stride, s, r in zip(grid_sizes, strides, sizes, aspect_ratios):
        cell = cell_anchors(s, r)
        sx, sy = np.meshgrid(np.arange(w) * stride, np.arange(h) * stride)
        shifts = np.stack([sx.ravel(), sy.ravel(), sx.ravel(), sy.ravel()], axis=1)
        anchors = (shifts[:, None, :] + cell[None]).reshape(-1, 4)
        out.append(torch.from_numpy(anchors.astype(np.float32)).to(device))
    return out


# ---------------------------------------------------------------------- NMS

def _stable_desc(scores: torch.Tensor) -> torch.Tensor:
    return torch.sort(scores, dim=-1, descending=True, stable=True).indices


def nms_mask(boxes, scores, valid, iou_threshold: float) -> torch.Tensor:
    """Greedy NMS as the fixpoint of ``x[j] = valid[j] & not any_i(sup[i, j]
    & x[i])`` over (..., N) sets; a keep mask in input order."""
    n = boxes.shape[-2]
    order = _stable_desc(torch.where(valid, scores, torch.full_like(scores, NEG_INF)))
    b = torch.gather(boxes, -2, order[..., None].expand(order.shape + (4,)))
    v = torch.gather(valid, -1, order)
    upper = torch.ones((n, n), dtype=torch.bool, device=boxes.device).triu(1)
    sup = (pairwise_iou(b, b) > iou_threshold) & upper
    cur = v.clone()
    while True:
        nxt = v & ~(sup & cur[..., :, None]).any(dim=-2)
        if torch.equal(nxt, cur):
            break
        cur = nxt
    return torch.zeros_like(valid).scatter(-1, order, cur)


def batched_nms_mask(boxes, scores, idxs, valid, iou_threshold: float) -> torch.Tensor:
    masked = torch.where(valid[..., None], boxes, torch.zeros_like(boxes))
    max_coord = masked.flatten(-2).amax(dim=-1) + 1.0
    offsets = idxs.to(boxes.dtype) * max_coord[..., None]
    return nms_mask(boxes + offsets[..., None], scores, valid, iou_threshold)


def masked_topk(scores, valid, k: int):
    neg = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    k = min(k, scores.shape[-1])
    order = _stable_desc(neg)[..., :k]
    return order, torch.gather(valid, -1, order)


# ------------------------------------------------------ matching, sampling

def match(quality: torch.Tensor, gt_valid: torch.Tensor, thresholds, labels, low_quality: bool):
    """(..., M, N) qualities over padded gt rows -> (best gt index, label in
    {-1, 0, 1}) per prediction."""
    bounds = [-float("inf")] + list(thresholds) + [float("inf")]
    neg = torch.full((), -1.0, dtype=quality.dtype, device=quality.device)
    q = torch.where(gt_valid[..., None], quality, neg)
    matches = q.argmax(dim=-2)
    vals = q.max(dim=-2).values.clamp(min=0.0)
    vals = torch.where(gt_valid.any(dim=-1, keepdim=True), vals, torch.zeros_like(vals))
    out = torch.ones(matches.shape, dtype=torch.int8, device=matches.device)
    for label, lo, hi in zip(labels, bounds[:-1], bounds[1:]):
        band = (vals >= lo) & (vals < hi)
        out = torch.where(band, torch.tensor(label, dtype=torch.int8, device=matches.device), out)
    if low_quality:
        best = q.max(dim=-1, keepdim=True).values
        is_best = (q == best) & (best > 0) & gt_valid[..., None]
        out = torch.where(is_best.any(dim=-2), torch.ones_like(out), out)
    return matches, out


def fold_in(seed: int, *data: int) -> int:
    state = np.random.SeedSequence([seed, *data]).generate_state(1, np.uint64)[0]
    return int(state) & (2 ** 63 - 1)


def image_generators(step_seed: int, count: int, device) -> List[torch.Generator]:
    """One generator per image, seeded from the step's seed and the image's
    position in the global batch (as the port's data-parallel step does)."""
    return [torch.Generator(device=device).manual_seed(fold_in(step_seed, 0, i)) for i in range(count)]


def subsample(labels: torch.Tensor, num_samples: int, positive_fraction: float,
              generator: Optional[torch.Generator]):
    """Fixed slots: positives first, then negatives, by the smallest of one
    uniform priority per candidate (two draws of ``len(labels)``)."""
    n = labels.shape[0]
    device = labels.device
    pos, neg = labels == 1, labels == 0
    k = min(num_samples, n)
    inf = torch.full((), float("inf"), device=device)

    def priorities():
        return torch.rand(n, generator=generator, device=generator.device).to(device)

    pos_order = torch.topk(torch.where(pos, priorities(), inf), k, largest=False, sorted=True).indices
    neg_order = torch.topk(torch.where(neg, priorities(), inf), k, largest=False, sorted=True).indices
    num_pos = torch.clamp(pos.sum(), max=int(num_samples * positive_fraction))
    num_neg = torch.minimum(neg.sum(), num_samples - num_pos)
    slot = torch.arange(num_samples, device=device)
    is_pos = slot < num_pos
    idxs = torch.where(is_pos, pos_order[slot.clamp(0, k - 1)], neg_order[torch.clamp(slot - num_pos, 0, k - 1)])
    slot_valid = slot < num_pos + num_neg
    return idxs, is_pos & slot_valid, slot_valid
