"""Segmentation mask structures, a copy of ``lvc_tpu/structures/masks.py``
(the port keeps its own; counterpart of detectron2/structures/masks.py:
PolygonMasks, BitMasks, polygons_to_bitmask).

Host-side numpy and PIL: COCO polygons and RLE decode to bitmasks, bitmasks
encode to uncompressed RLE, and ``paste_masks_np`` pastes per-detection
roi masks into the original image for the evaluator. The device-side crop
and paste are in ``modeling/roi_heads/mask_head.py``.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
from PIL import Image, ImageDraw


def polygons_to_bitmask(polygons: Sequence[np.ndarray], height: int, width: int) -> np.ndarray:
    """Rasterize COCO-style polygons ([x0, y0, x1, y1, ...] flat lists) to a
    (height, width) bool mask."""
    img = Image.new("L", (width, height), 0)
    draw = ImageDraw.Draw(img)
    for p in polygons:
        pts = np.asarray(p, np.float64).reshape(-1, 2)
        if len(pts) < 3:
            continue
        draw.polygon([tuple(xy) for xy in pts], outline=1, fill=1)
    return np.asarray(img, bool)


def _rle_counts(rle: dict) -> List[int]:
    """Decode the ``counts`` field of a COCO RLE dict to a plain run-length
    list. Handles both the uncompressed form (list of ints) and the
    compressed LEB128-style string of the COCO mask API
    (pycocotools rleFrString semantics: 5-bit groups, chars offset by 48,
    runs >2 stored as deltas from the run two places back)."""
    counts = rle["counts"]
    if isinstance(counts, (list, tuple)):
        return [int(c) for c in counts]
    if isinstance(counts, bytes):
        counts = counts.decode("ascii")
    out: List[int] = []
    p = 0
    while p < len(counts):
        x, k, more = 0, 0, True
        while more:
            c = ord(counts[p]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            p += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(out) > 2:
            x += out[-2]
        out.append(x)
    return out


def rle_to_bitmask(rle: dict) -> np.ndarray:
    """COCO RLE dict ({"size": [h, w], "counts": ...}) -> (h, w) bool mask.
    Runs alternate background/foreground in column-major order (COCO mask
    API convention)."""
    h, w = rle["size"]
    counts = _rle_counts(rle)
    flat = np.zeros(h * w, bool)
    pos = 0
    val = False
    for c in counts:
        flat[pos : pos + c] = val
        pos += c
        val = not val
    return flat.reshape(w, h).T  # column-major


def bitmask_to_rle(mask: np.ndarray) -> dict:
    """(h, w) bool mask -> uncompressed COCO RLE dict (column-major runs)."""
    m = np.asarray(mask, bool)
    h, w = m.shape
    flat = m.T.reshape(-1)
    # run boundaries; COCO counts always start with a background run
    change = np.flatnonzero(flat[1:] != flat[:-1]) + 1
    lengths = np.diff(np.concatenate([[0], change, [flat.size]])).tolist()
    if flat.size and flat[0]:
        lengths = [0] + lengths
    return {"size": [h, w], "counts": [int(c) for c in lengths]}


def paste_masks_np(
    masks: np.ndarray,  # (D, M, M) probability masks
    boxes: np.ndarray,  # (D, 4) XYXY image coords
    image_hw: Tuple[int, int],
    threshold: float = 0.5,
) -> np.ndarray:
    """Host-side numpy mirror of ``modeling/roi_heads/mask_head.py``'s
    ``paste_masks_in_image`` (grid_sample align_corners=False zeros-padding
    semantics of the reference's layers/mask_ops.py:67). The evaluator uses
    it: each image has its own output size, and only the pixels near each
    box are computed."""
    masks = np.asarray(masks, np.float32)
    boxes = np.asarray(boxes, np.float32)
    D, M, _ = masks.shape
    H, W = image_hw
    out = np.zeros((D, H, W), bool if threshold >= 0 else np.float32)
    ys = np.arange(H, dtype=np.float32) + 0.5
    xs = np.arange(W, dtype=np.float32) + 0.5

    def axis_taps(coords, lo, size):
        g = (coords - lo) / max(size, 1e-4) * M - 0.5
        i0 = np.floor(g).astype(np.int64)
        f = (g - i0).astype(np.float32)
        i1 = i0 + 1
        w0 = np.where((i0 >= 0) & (i0 < M), 1.0 - f, 0.0)
        w1 = np.where((i1 >= 0) & (i1 < M), f, 0.0)
        return np.clip(i0, 0, M - 1), np.clip(i1, 0, M - 1), w0, w1

    for i in range(D):
        x0v, y0v, x1v, y1v = boxes[i]
        # only the rows/cols whose taps can be non-zero (fixed-shape is a
        # device concern; on host, slicing is the fast path). The zeros-
        # padding fade band extends box_size/(2M) px past the box edge, so
        # the crop margin must scale with the box, not be a fixed 1px.
        mx = int(np.ceil(max(x1v - x0v, 0.0) / (2 * M))) + 1
        my = int(np.ceil(max(y1v - y0v, 0.0) / (2 * M))) + 1
        cx0 = max(int(np.floor(x0v)) - mx, 0)
        cx1 = min(int(np.ceil(x1v)) + mx, W)
        cy0 = max(int(np.floor(y0v)) - my, 0)
        cy1 = min(int(np.ceil(y1v)) + my, H)
        if cx1 <= cx0 or cy1 <= cy0:
            continue
        x0, x1, wx0, wx1 = axis_taps(xs[cx0:cx1], x0v, x1v - x0v)
        y0, y1, wy0, wy1 = axis_taps(ys[cy0:cy1], y0v, y1v - y0v)
        m = masks[i]
        top = m[y0][:, x0] * wx0[None, :] + m[y0][:, x1] * wx1[None, :]
        bot = m[y1][:, x0] * wx0[None, :] + m[y1][:, x1] * wx1[None, :]
        val = top * wy0[:, None] + bot * wy1[:, None]
        if threshold >= 0:
            out[i, cy0:cy1, cx0:cx1] = val >= threshold
        else:
            out[i, cy0:cy1, cx0:cx1] = val
    return out


class PolygonMasks:
    """A list (per instance) of polygon lists; lazily rasterizable."""

    def __init__(self, polygons: List[List[np.ndarray]]):
        self.polygons = [
            [np.asarray(p, np.float64).reshape(-1) for p in per_inst]
            for per_inst in polygons
        ]

    def __len__(self) -> int:
        return len(self.polygons)

    def __getitem__(self, idx):
        if isinstance(idx, (int, np.integer)):
            return PolygonMasks([self.polygons[idx]])
        if isinstance(idx, slice):
            return PolygonMasks(self.polygons[idx])
        return PolygonMasks([self.polygons[int(i)] for i in np.asarray(idx).reshape(-1)])

    def to_bitmasks(self, height: int, width: int) -> "BitMasks":
        return BitMasks(
            np.stack(
                [polygons_to_bitmask(p, height, width) for p in self.polygons]
            )
            if self.polygons
            else np.zeros((0, height, width), bool)
        )

    def area(self) -> np.ndarray:
        """Shoelace area summed over each instance's polygons."""
        out = []
        for per_inst in self.polygons:
            a = 0.0
            for p in per_inst:
                pts = p.reshape(-1, 2)
                x, y = pts[:, 0], pts[:, 1]
                a += 0.5 * abs(np.dot(x, np.roll(y, 1)) - np.dot(y, np.roll(x, 1)))
            out.append(a)
        return np.asarray(out)

    def get_bounding_boxes(self) -> np.ndarray:
        """(N, 4) XYXY tight boxes."""
        boxes = np.zeros((len(self), 4), np.float32)
        for i, per_inst in enumerate(self.polygons):
            if not per_inst:
                continue
            pts = np.concatenate([p.reshape(-1, 2) for p in per_inst])
            boxes[i] = [pts[:, 0].min(), pts[:, 1].min(), pts[:, 0].max(), pts[:, 1].max()]
        return boxes


class BitMasks:
    """(N, H, W) bool masks."""

    def __init__(self, tensor: np.ndarray):
        self.tensor = np.asarray(tensor, bool)
        assert self.tensor.ndim == 3

    def __len__(self) -> int:
        return self.tensor.shape[0]

    def __getitem__(self, idx) -> "BitMasks":
        t = self.tensor[idx]
        return BitMasks(t[None] if t.ndim == 2 else t)

    @property
    def image_size(self) -> Tuple[int, int]:
        return self.tensor.shape[1:]

    def nonempty(self) -> np.ndarray:
        return self.tensor.reshape(len(self), -1).any(axis=1)

    def area(self) -> np.ndarray:
        return self.tensor.reshape(len(self), -1).sum(axis=1).astype(np.float32)

    def get_bounding_boxes(self) -> np.ndarray:
        boxes = np.zeros((len(self), 4), np.float32)
        for i, m in enumerate(self.tensor):
            ys, xs = np.nonzero(m)
            if len(ys):
                boxes[i] = [xs.min(), ys.min(), xs.max() + 1, ys.max() + 1]
        return boxes

    def pad_to(self, max_instances: int) -> Tuple[np.ndarray, np.ndarray]:
        """Fixed-shape (max_instances, H, W) tensor + validity mask — the
        device-side contract."""
        n = min(len(self), max_instances)
        h, w = self.image_size
        out = np.zeros((max_instances, h, w), bool)
        out[:n] = self.tensor[:n]
        valid = np.zeros((max_instances,), bool)
        valid[:n] = True
        return out, valid
