"""Batched image padding: a copy of ``lvc_tpu/structures/image_list.py``
(``pad_to_divisibility``:20, ``ImageList.from_tensors``:38; detectron2's
structures/image_list.py:8).

Images are NHWC. ``from_tensors`` pads a list of (h, w, C) images to the
largest size rounded up to ``size_divisibility``, or to a static ``canvas``
(the loader's canvas buckets), with ``pad_value``; it takes numpy arrays or
torch tensors (the batch is made on the first image's device) and returns
the same kind.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple, Union

import numpy as np
import torch

Array = Union[np.ndarray, torch.Tensor]


def pad_to_divisibility(size: Tuple[int, int], divisibility: int) -> Tuple[int, int]:
    h, w = size
    d = divisibility
    return (-(-h // d) * d, -(-w // d) * d)


@dataclasses.dataclass
class ImageList:
    """tensor: (B, H, W, C) padded batch; image_sizes: true (h, w) per image."""

    tensor: Array
    image_sizes: np.ndarray  # (B, 2) int32: the sizes before padding

    def __len__(self):
        return self.tensor.shape[0]

    @staticmethod
    def from_tensors(
        tensors: Sequence[Array],
        size_divisibility: int = 0,
        pad_value: float = 0.0,
        canvas: Tuple[int, int] | None = None,
    ) -> "ImageList":
        """Pad a list of (h, w, C) images to a common canvas (max size rounded
        up to divisibility, or an explicit static ``canvas``)."""
        sizes = np.array([tuple(t.shape[:2]) for t in tensors], dtype=np.int32)
        if canvas is None:
            max_h, max_w = (int(x) for x in sizes.max(axis=0))
        else:
            max_h, max_w = canvas
        if size_divisibility > 0:
            max_h, max_w = pad_to_divisibility((max_h, max_w), size_divisibility)
        shape = (len(tensors), max_h, max_w, tensors[0].shape[2])
        first = tensors[0]
        if isinstance(first, torch.Tensor):
            batch = torch.full(shape, pad_value, dtype=first.dtype, device=first.device)
        else:
            batch = np.full(shape, pad_value, dtype=first.dtype)
        for i, t in enumerate(tensors):
            batch[i, : t.shape[0], : t.shape[1]] = t
        return ImageList(batch, sizes)
