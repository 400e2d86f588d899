"""Dataset dict -> fixed-shape padded training/eval example.

The port's copy of ``lvc_tpu/data/dataset_mapper.py`` (``read_image``:23,
``pick_canvas``:40, ``DatasetMapper``:74, ``collate``:236, ``MODEL_KEYS``).
Counterpart of lvc/data/dataset_mapper.py (DatasetMapperIgnore:24-209 keeps
iscrowd boxes as ignore regions). Instead of variable-size tensors, the
mapper resizes, augments, and pads into one of a small set of static canvas
buckets and emits numpy arrays with validity masks; batches of examples from
the same bucket stack directly into the model's batch contract.

The batch contract has no space-to-depth form: the image is always
``"image"``, the padded float32 canvas of raw pixels that the JAX mapper
emits with ``INPUT.LOADER_S2D "off"``. ``"auto"`` means that here;
``"on"`` raises, since the port's stem is the plain 7x7 convolution.
"""
from __future__ import annotations

import logging
from typing import Dict, List, Sequence, Tuple

import numpy as np
from PIL import Image

from lvc_tpu_torch.data import native_io
from lvc_tpu_torch.data import transforms as T
from lvc_tpu_torch.structures.boxes import BoxMode
from lvc_tpu_torch.utils.tracing import span


def read_image(file_name: str, fmt: str = "BGR") -> np.ndarray:
    """Decode to RGB or BGR uint8 (H, W, 3); prefers the native GIL-free
    decoder (``data/csrc/imageio.cpp``, bit for bit PIL's libjpeg/libpng
    path) and takes PIL where that library could not be built."""
    arr = None
    if native_io.available():
        try:
            arr, _ = native_io.load_resize(file_name, 0)
        except (IOError, ImportError):
            arr = None
    if arr is None:
        arr = np.asarray(Image.open(file_name).convert("RGB"))
    if fmt == "BGR":
        arr = arr[:, :, ::-1]
    return np.ascontiguousarray(arr)


def pick_canvas(h: int, w: int, buckets: Sequence[Sequence[int]]) -> Tuple[int, int]:
    for bh, bw in buckets:
        if h <= bh and w <= bw:
            return (bh, bw)
    # fall back to the largest bucket; caller guarantees images fit after
    # resize (max_size <= max bucket dim)
    return tuple(max(buckets, key=lambda b: b[0] * b[1]))


class DatasetMapper:
    """cfg-driven mapper. ``keep_ignore=True`` reproduces
    DatasetMapperIgnore (iscrowd/ignore_qe boxes become gt_ignores)."""

    def __init__(self, cfg, is_train: bool = True, keep_ignore: bool = False, seed: int = 0):
        if cfg.INPUT.LOADER_S2D == "on":
            raise NotImplementedError(
                "INPUT.LOADER_S2D 'on' (the space-to-depth canvas) has no counterpart in the "
                "port: its stem is the plain 7x7 convolution and takes the 'image' canvas"
            )
        self.is_train = is_train
        self.keep_ignore = keep_ignore
        self.fmt = cfg.INPUT.FORMAT
        self.min_size_train = tuple(cfg.INPUT.MIN_SIZE_TRAIN)
        self.max_size_train = cfg.INPUT.MAX_SIZE_TRAIN
        self.min_size_test = cfg.INPUT.MIN_SIZE_TEST
        self.max_size_test = cfg.INPUT.MAX_SIZE_TEST
        self.crop_enabled = cfg.INPUT.CROP.ENABLED and is_train
        self.crop_size = tuple(cfg.INPUT.CROP.SIZE)
        self.color_jitter = cfg.INPUT.COLOR_JITTER and is_train
        self.blur = cfg.INPUT.BLUR and is_train
        self.max_gt = cfg.PAD.MAX_GT_PER_IMAGE
        self.buckets = [tuple(b) for b in cfg.PAD.CANVAS_BUCKETS]
        self.rng = np.random.RandomState(seed)

    # ------------------------------------------------------------- parsing
    @staticmethod
    def parse_annotations(annos: List[dict], keep_ignore: bool):
        boxes, classes, ignores, ids, scores = [], [], [], [], []
        for a in annos:
            crowd = a.get("iscrowd", 0)
            ign = a.get("ignore_qe", 0) or crowd
            if not keep_ignore and crowd:
                continue  # standard mapper drops crowd boxes
            b = np.asarray(a["bbox"], np.float32)
            if a.get("bbox_mode", BoxMode.XYWH_ABS) == BoxMode.XYWH_ABS:
                b = np.array([b[0], b[1], b[0] + b[2], b[1] + b[3]], np.float32)
            boxes.append(b)
            classes.append(a["category_id"])
            ignores.append(bool(ign))
            ids.append(a.get("id", -1))
            scores.append(a.get("score", 1.0))
        if boxes:
            return (
                np.stack(boxes),
                np.asarray(classes, np.int32),
                np.asarray(ignores, bool),
                np.asarray(ids, np.int64),
                np.asarray(scores, np.float32),
            )
        return (
            np.zeros((0, 4), np.float32),
            np.zeros((0,), np.int32),
            np.zeros((0,), bool),
            np.zeros((0,), np.int64),
            np.zeros((0,), np.float32),
        )

    # -------------------------------------------------------------- mapping
    def __call__(self, dataset_dict: dict) -> Dict[str, np.ndarray]:
        """Decodes (span ``loader.decode``), then maps (span
        ``loader.augment``), on the loader's worker thread."""
        with span("loader.decode", device=False):
            image = read_image(dataset_dict["file_name"], self.fmt)
        with span("loader.augment", device=False):
            return self._map_loaded(dataset_dict, image)

    def _map_loaded(self, dataset_dict: dict, image: np.ndarray) -> Dict[str, np.ndarray]:
        d = dataset_dict
        orig_h, orig_w = image.shape[:2]
        boxes, classes, ignores, ids, scores = self.parse_annotations(
            d.get("annotations", []), self.keep_ignore
        )
        boxes_orig = boxes.copy()

        if self.is_train:
            if self.crop_enabled and len(boxes):
                image, boxes, _ = T.random_crop_with_instance(
                    self.rng, image, boxes, self.crop_size
                )
            short = self.min_size_train[self.rng.randint(len(self.min_size_train))]
            image, boxes, _ = T.resize_shortest_edge(image, boxes, short, self.max_size_train)
            if self.rng.rand() < 0.5:
                image, boxes = T.hflip(image, boxes)
            if self.color_jitter:
                # jitter operates on RGB; flip channels around it for BGR
                rgb = image[:, :, ::-1] if self.fmt == "BGR" else image
                rgb = T.color_jitter(self.rng, np.ascontiguousarray(rgb))
                image = rgb[:, :, ::-1] if self.fmt == "BGR" else rgb
            if self.blur:
                image = T.gaussian_blur(self.rng, np.ascontiguousarray(image))
        else:
            if self.min_size_test > 0:
                image, boxes, _ = T.resize_shortest_edge(
                    image, boxes, self.min_size_test, self.max_size_test
                )

        h, w = image.shape[:2]
        canvas_h, canvas_w = pick_canvas(h, w, self.buckets)
        padded = np.zeros((canvas_h, canvas_w, 3), np.float32)
        padded[:h, :w] = image.astype(np.float32)

        # drop degenerate boxes (filter_empty_instances)
        if len(boxes):
            keep = (boxes[:, 2] > boxes[:, 0]) & (boxes[:, 3] > boxes[:, 1])
            boxes, classes, ignores, ids, scores = (
                boxes[keep], classes[keep], ignores[keep], ids[keep], scores[keep]
            )
            if len(boxes_orig) == len(keep):
                boxes_orig = boxes_orig[keep]

        G = self.max_gt
        n = min(len(boxes), G)
        if len(boxes) > G and not self.is_train:
            # at eval time every gt/candidate box is a consumer-visible
            # output slot; truncation silently drops results
            logging.getLogger(__name__).warning(
                "image %s: %d gt boxes exceed PAD.MAX_GT_PER_IMAGE=%d; "
                "%d dropped — raise the pad for candidate-correction runs",
                d.get("image_id", "?"), len(boxes), G, len(boxes) - G,
            )
        gt_boxes = np.zeros((G, 4), np.float32)
        gt_classes = np.zeros((G,), np.int32)
        gt_valid = np.zeros((G,), bool)
        gt_ignores = np.zeros((G,), bool)
        gt_ids = np.full((G,), -1, np.int64)
        gt_scores = np.zeros((G,), np.float32)
        gt_boxes_orig = np.zeros((G, 4), np.float32)
        gt_boxes[:n] = boxes[:n]
        if len(boxes_orig) >= n:
            gt_boxes_orig[:n] = boxes_orig[:n]
        gt_classes[:n] = classes[:n]
        gt_valid[:n] = True
        gt_ignores[:n] = ignores[:n]
        gt_ids[:n] = ids[:n]
        gt_scores[:n] = scores[:n]

        return {
            "image": padded,
            "image_size": np.array([h, w], np.int32),
            "gt_boxes": gt_boxes,
            "gt_classes": gt_classes,
            "gt_valid": gt_valid,
            "gt_ignores": gt_ignores,
            "gt_ids": gt_ids,
            "gt_scores": gt_scores,
            "gt_boxes_orig": gt_boxes_orig,
            # host-side metadata (not fed to the model)
            "image_id": d.get("image_id", -1),
            "orig_size": np.array([orig_h, orig_w], np.int32),
            "canvas": (canvas_h, canvas_w),
        }


MODEL_KEYS = (
    "image_size",
    "gt_boxes",
    "gt_classes",
    "gt_valid",
    "gt_ignores",
)


def collate(
    examples: List[Dict[str, np.ndarray]], train: bool = True, with_gt: bool = False
) -> Dict[str, np.ndarray]:
    """Stack same-canvas examples into the model batch contract.
    ``with_gt`` includes the gt fields in eval batches (box-correction
    inference consumes candidates through the gt slots)."""
    assert len({e["canvas"] for e in examples}) == 1, "mixed canvas buckets in batch"
    keys = ("image",) + MODEL_KEYS if (train or with_gt) else ("image", "image_size")
    return {k: np.stack([e[k] for e in examples]) for k in keys}
