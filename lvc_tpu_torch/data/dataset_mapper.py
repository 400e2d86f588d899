"""Image decoding for the verification path.

``read_image`` of ``lvc_tpu/data/dataset_mapper.py`` through PIL. The JAX
package prefers its native decoder (``data/native_io.py``), which it keeps
bit for bit equal to PIL's libjpeg/libpng path (``dataset_mapper.py:24-25``);
that decoder is not ported yet (ROADMAP.md).
"""
from __future__ import annotations

import numpy as np
from PIL import Image


def read_image(file_name: str, fmt: str = "BGR") -> np.ndarray:
    """Decode to RGB or BGR uint8 (H, W, 3)."""
    arr = np.asarray(Image.open(file_name).convert("RGB"))
    if fmt == "BGR":
        arr = arr[:, :, ::-1]
    return np.ascontiguousarray(arr)
