"""Seeded RoIAlign inputs shared by the port's CPU tests
(test_torch_roi_align.py) and its card tests (test_torch_kernels_cuda.py).
No tests of its own; numpy only, so the card tests import no JAX."""
import numpy as np


def _pyramid():
    rng = np.random.RandomState(7)
    B, R, C = 2, 21, 64
    shapes, h, w = [], 32, 48
    for _ in range(4):
        shapes.append((h, w))
        h, w = (h + 1) // 2, (w + 1) // 2
    feats = [rng.rand(B, h, w, C).astype(np.float32) for h, w in shapes]
    s = rng.uniform(8, 150, (B, R))
    ar = rng.uniform(0.5, 2.0, (B, R))
    bw, bh = s * np.sqrt(ar), s / np.sqrt(ar)
    x0 = rng.uniform(0, 1, (B, R)) * (192 - bw)
    y0 = rng.uniform(0, 1, (B, R)) * (128 - bh)
    boxes = np.stack([x0, y0, x0 + bw, y0 + bh], -1).astype(np.float32)
    boxes[0, 0] = [0.0, 0.0, 191.9, 127.9]
    boxes[0, 1] = [188.0, 124.0, 192.0, 128.0]
    boxes[0, 2] = [5.0, 5.0, 5.0, 5.0]
    boxes[1, 0] = [0.0, 124.0, 4.0, 128.0]
    boxes[1, 1] = [185.0, 0.0, 192.0, 6.0]
    return feats, boxes, (4, 8, 16, 32)


def _wide():
    rng = np.random.RandomState(11)
    B, R, C = 1, 12, 96
    shapes = [(64, 128), (32, 64)]
    feats = [rng.rand(B, h, w, C).astype(np.float32) for h, w in shapes]
    x0 = rng.uniform(0, 100, (B, R))
    y0 = rng.uniform(0, 220, (B, R))
    bw = rng.uniform(300, 512, (B, R))
    bh = rng.uniform(4, 36, (B, R))
    boxes = np.stack([x0, y0, np.minimum(x0 + bw, 512), np.minimum(y0 + bh, 256)], -1)
    boxes = boxes.astype(np.float32)
    boxes[0, 0] = [0.0, 0.0, 512.0, 256.0]
    boxes[0, 1] = [0.0, 240.0, 512.0, 256.0]
    boxes[0, 2] = [500.0, 250.0, 512.0, 256.0]
    return feats, boxes, (4, 8)


CASES = {"pyramid": _pyramid, "wide": _wide}
