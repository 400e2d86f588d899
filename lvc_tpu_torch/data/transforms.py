"""Host-side image/box transforms (numpy + PIL), a copy of
``lvc_tpu/data/transforms.py`` (the port keeps its own; ``s2d_canvas`` is left
out, as the port has no space-to-depth stem).

Counterpart of detectron2/data/transforms/ (ResizeShortestEdge:184,
RandomFlip:91, RandomCrop:291, and LVC's ColorJitterPIL:589 /
GaussianBlurPIL:620). These run in the input pipeline on CPU; the padded
fixed-shape output then moves to the card once per batch.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
from PIL import Image, ImageEnhance, ImageFilter


def _resize_bilinear(image: np.ndarray, newh: int, neww: int) -> np.ndarray:
    """PIL.BILINEAR resize; prefers the native GIL-free kernel
    (data/csrc/imageio.cpp, within +-1 LSB of PIL) for u8 inputs."""
    if image.dtype == np.uint8:
        from lvc_tpu_torch.data import native_io

        if native_io.available():
            return native_io.resize(np.ascontiguousarray(image), newh, neww)
    pil = Image.fromarray(image)
    return np.asarray(pil.resize((neww, newh), Image.BILINEAR))


def resize_shortest_edge(
    image: np.ndarray,
    boxes: Optional[np.ndarray],
    short: int,
    max_size: int = 1333,
) -> Tuple[np.ndarray, Optional[np.ndarray], float]:
    """Resize so the short side == short, long side capped at max_size
    (d2 ResizeShortestEdge semantics, incl. the +0.5 rounding)."""
    h, w = image.shape[:2]
    scale = short * 1.0 / min(h, w)
    if h < w:
        newh, neww = short, scale * w
    else:
        newh, neww = scale * h, short
    if max(newh, neww) > max_size:
        scale2 = max_size * 1.0 / max(newh, neww)
        newh, neww = newh * scale2, neww * scale2
    neww = int(neww + 0.5)
    newh = int(newh + 0.5)
    out = _resize_bilinear(image, newh, neww)
    if boxes is not None and len(boxes):
        boxes = boxes.astype(np.float64).copy()
        boxes[:, 0::2] *= neww * 1.0 / w
        boxes[:, 1::2] *= newh * 1.0 / h
        boxes = boxes.astype(np.float32)
    return out, boxes, newh / h


def hflip(image: np.ndarray, boxes: Optional[np.ndarray]) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    w = image.shape[1]
    # negative-stride view, not a copy: every consumer either pastes into a
    # fresh canvas (strided reads are fine) or wraps in ascontiguousarray
    image = image[:, ::-1]
    if boxes is not None and len(boxes):
        boxes = boxes.copy()
        x0 = w - boxes[:, 2]
        x1 = w - boxes[:, 0]
        boxes[:, 0], boxes[:, 2] = x0, x1
    return image, boxes


def random_crop_with_instance(
    rng: np.random.RandomState,
    image: np.ndarray,
    boxes: np.ndarray,
    crop_size_rel: Sequence[float],
) -> Tuple[np.ndarray, np.ndarray, Tuple[int, int]]:
    """relative_range crop that keeps a randomly chosen instance's center
    inside the crop (d2 gen_crop_transform_with_instance)."""
    h, w = image.shape[:2]
    c0, c1 = crop_size_rel
    ch = int(h * (c0 + rng.rand() * (1 - c0)) + 0.5)
    cw = int(w * (c1 + rng.rand() * (1 - c1)) + 0.5)
    if len(boxes):
        inst = boxes[rng.randint(len(boxes))]
        cx = (inst[0] + inst[2]) / 2
        cy = (inst[1] + inst[3]) / 2
        # crop window must contain (cx, cy)
        y0_min = max(0, int(np.ceil(cy)) - ch + 1)
        y0_max = min(h - ch, int(cy))
        x0_min = max(0, int(np.ceil(cx)) - cw + 1)
        x0_max = min(w - cw, int(cx))
        y0 = rng.randint(y0_min, max(y0_min, y0_max) + 1)
        x0 = rng.randint(x0_min, max(x0_min, x0_max) + 1)
    else:
        y0 = rng.randint(0, h - ch + 1)
        x0 = rng.randint(0, w - cw + 1)
    image = image[y0 : y0 + ch, x0 : x0 + cw]
    if len(boxes):
        boxes = boxes.copy()
        boxes[:, 0::2] -= x0
        boxes[:, 1::2] -= y0
        boxes[:, 0::2] = boxes[:, 0::2].clip(0, cw)
        boxes[:, 1::2] = boxes[:, 1::2].clip(0, ch)
    return image, boxes, (y0, x0)


def color_jitter(
    rng: np.random.RandomState,
    image: np.ndarray,
    brightness: float = 0.4,
    contrast: float = 0.4,
    saturation: float = 0.4,
) -> np.ndarray:
    """ColorJitterPIL (augmentation_impl.py:589): PIL enhance ops with
    factors in [1-x, 1+x], applied in random order."""
    pil = Image.fromarray(image)
    ops = [
        lambda im: ImageEnhance.Brightness(im).enhance(
            1 + (rng.rand() * 2 - 1) * brightness
        ),
        lambda im: ImageEnhance.Contrast(im).enhance(1 + (rng.rand() * 2 - 1) * contrast),
        lambda im: ImageEnhance.Color(im).enhance(1 + (rng.rand() * 2 - 1) * saturation),
    ]
    order = rng.permutation(len(ops))
    for i in order:
        pil = ops[i](pil)
    return np.asarray(pil)


def gaussian_blur(rng: np.random.RandomState, image: np.ndarray, sigma_range=(0.1, 2.0)) -> np.ndarray:
    sigma = sigma_range[0] + rng.rand() * (sigma_range[1] - sigma_range[0])
    pil = Image.fromarray(image).filter(ImageFilter.GaussianBlur(radius=sigma))
    return np.asarray(pil)
