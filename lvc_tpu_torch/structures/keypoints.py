"""Keypoint structures, a copy of ``lvc_tpu/structures/keypoints.py`` (the
port keeps its own; counterpart of detectron2/structures/keypoints.py):
``Keypoints``, ``flip_keypoints`` and ``create_keypoint_hflip_indices``.
Host-side numpy; the heatmap encode and decode are in
``modeling/roi_heads/keypoint_head.py``.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


class Keypoints:
    """(N, K, 3) keypoints as (x, y, visibility)."""

    def __init__(self, keypoints: np.ndarray):
        self.tensor = np.asarray(keypoints, np.float32)
        assert self.tensor.ndim == 3 and self.tensor.shape[2] == 3

    def __len__(self) -> int:
        return self.tensor.shape[0]

    def __getitem__(self, idx) -> "Keypoints":
        t = self.tensor[idx]
        return Keypoints(t[None] if t.ndim == 2 else t)

    def pad_to(self, max_instances: int) -> Tuple[np.ndarray, np.ndarray]:
        n = min(len(self), max_instances)
        k = self.tensor.shape[1]
        out = np.zeros((max_instances, k, 3), np.float32)
        out[:n] = self.tensor[:n]
        valid = np.zeros((max_instances,), bool)
        valid[:n] = True
        return out, valid


def flip_keypoints(
    keypoints: np.ndarray, width: int, flip_indices: Sequence[int]
) -> np.ndarray:
    """Horizontal flip with left/right pair swap (d2
    transform_keypoint_annotations semantics). ``flip_indices[i]`` names the
    keypoint that lands at slot i after the flip (e.g. left_eye <->
    right_eye)."""
    kp = np.asarray(keypoints, np.float32).copy()
    kp = kp[..., list(flip_indices), :]
    kp[..., 0] = width - kp[..., 0]
    return kp


# COCO-person flip map (d2 detection_utils create_keypoint_hflip_indices)
COCO_PERSON_KEYPOINT_NAMES = (
    "nose", "left_eye", "right_eye", "left_ear", "right_ear",
    "left_shoulder", "right_shoulder", "left_elbow", "right_elbow",
    "left_wrist", "right_wrist", "left_hip", "right_hip",
    "left_knee", "right_knee", "left_ankle", "right_ankle",
)


def create_keypoint_hflip_indices(names: Sequence[str] = COCO_PERSON_KEYPOINT_NAMES):
    flipped = [
        n.replace("left_", "X_").replace("right_", "left_").replace("X_", "right_")
        for n in names
    ]
    return [names.index(f) for f in flipped]
