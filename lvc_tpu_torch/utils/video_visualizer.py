"""Temporally-consistent instance visualization for video streams.

Counterpart of ``lvc_tpu/utils/video_visualizer.py`` and of the reference's ``detectron2/utils/video_visualizer.py``
(235 LoC): detections in consecutive frames are greedily associated by IoU
so an instance keeps its color across frames; unmatched detections get a
fresh color.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from lvc_tpu_torch.structures import boxes as box_ops
from lvc_tpu_torch.utils.colormap import random_color
from lvc_tpu_torch.utils.visualizer import VisImage, Visualizer


class _TrackedInstance:
    __slots__ = ("box", "color", "ttl")

    def __init__(self, box, color, ttl=8):
        self.box = box
        self.color = color
        self.ttl = ttl


class VideoVisualizer:
    """Stateful per-stream visualizer (reference VideoVisualizer:22-235)."""

    def __init__(self, metadata=None, iou_threshold: float = 0.5):
        self.metadata = metadata
        self.iou_threshold = iou_threshold
        self._tracked: List[_TrackedInstance] = []

    def _assign_colors(self, boxes: np.ndarray) -> List[tuple]:
        """Greedy IoU matching against live tracks (reference
        _assign_colors, video_visualizer.py:168-220)."""
        colors: List[Optional[tuple]] = [None] * len(boxes)
        if self._tracked and len(boxes):
            prev = np.stack([t.box for t in self._tracked])
            iou = box_ops.pairwise_iou(torch.from_numpy(prev).float(), torch.from_numpy(boxes).float()).numpy()
            # greedily take the best (track, det) pairs
            used_t, used_d = set(), set()
            order = np.dstack(np.unravel_index(np.argsort(-iou, axis=None), iou.shape))[0]
            for ti, di in order:
                if iou[ti, di] < self.iou_threshold:
                    break
                if ti in used_t or di in used_d:
                    continue
                used_t.add(int(ti))
                used_d.add(int(di))
                colors[di] = self._tracked[ti].color
                self._tracked[ti].box = boxes[di]
                self._tracked[ti].ttl = 8
        for t in self._tracked:
            t.ttl -= 1
        self._tracked = [t for t in self._tracked if t.ttl > 0]
        for di in range(len(boxes)):
            if colors[di] is None:
                colors[di] = tuple(int(c) for c in random_color())
                self._tracked.append(_TrackedInstance(boxes[di], colors[di]))
        return colors

    def draw_instance_predictions(self, frame_rgb: np.ndarray, dets) -> VisImage:
        """dets: one image's padded Detections (numpy arrays or tensors)."""
        boxes, scores, classes, valid = (
            f.cpu().numpy() if isinstance(f, torch.Tensor) else np.asarray(f)
            for f in (dets.boxes, dets.scores, dets.classes, dets.valid)
        )
        boxes, scores, classes = boxes[valid], scores[valid], classes[valid]
        colors = self._assign_colors(boxes)
        vis = Visualizer(frame_rgb, metadata=self.metadata)
        for box, score, cls, color in zip(boxes, scores, classes, colors):
            vis.draw_box(box, color=color)
            vis.draw_text(f"{vis._class_name(int(cls))} {score:.0%}", box[:2], color=color)
        return VisImage(vis.img)
