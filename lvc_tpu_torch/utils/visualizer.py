"""Detection/segmentation visualization (development aid).

Counterpart of ``lvc_tpu/utils/visualizer.py`` (the same code: PIL and numpy,
on the port's outputs as numpy arrays) and of detectron2/utils/visualizer.py (ColorMode, GenericMask,
_PanopticPrediction, Visualizer: instance/sem-seg/panoptic/dataset-dict
overlays, keypoint skeletons, rotated boxes, primitives). Built on PIL
instead of matplotlib so it works headless with no extra deps; drawing
coordinates, layer order, and label semantics follow the reference
(visualizer.py:309-1121) while the raster backend differs.
"""
from __future__ import annotations

import colorsys
import enum
from typing import List, Optional, Sequence, Tuple

import numpy as np
from PIL import Image, ImageDraw

from lvc_tpu_torch.structures.keypoints import COCO_PERSON_KEYPOINT_NAMES
from lvc_tpu_torch.utils.colormap import colormap, random_color

_SMALL_OBJECT_AREA_THRESH = 1000

# reference builtin_meta.py:170-188 (public COCO skeleton color table)
KEYPOINT_CONNECTION_RULES = [
    ("left_ear", "left_eye", (102, 204, 255)),
    ("right_ear", "right_eye", (51, 153, 255)),
    ("left_eye", "nose", (102, 0, 204)),
    ("nose", "right_eye", (51, 102, 255)),
    ("left_shoulder", "right_shoulder", (255, 128, 0)),
    ("left_shoulder", "left_elbow", (153, 255, 204)),
    ("right_shoulder", "right_elbow", (128, 229, 255)),
    ("left_elbow", "left_wrist", (153, 255, 153)),
    ("right_elbow", "right_wrist", (102, 255, 224)),
    ("left_hip", "right_hip", (255, 102, 0)),
    ("left_hip", "left_knee", (255, 255, 77)),
    ("right_hip", "right_knee", (153, 255, 204)),
    ("left_knee", "left_ankle", (191, 255, 128)),
    ("right_knee", "right_ankle", (255, 195, 77)),
]


class ColorMode(enum.Enum):
    """Reference visualizer.py:37-56."""

    IMAGE = 0
    SEGMENTATION = 1
    IMAGE_BW = 2


class GenericMask:
    """Uniform view over the three COCO mask encodings (reference
    visualizer.py:59-147): polygon lists, RLE dicts, (H, W) binary arrays."""

    def __init__(self, mask_or_polygons, height: int, width: int):
        self.height, self.width = height, width
        self._mask = self._polygons = None
        m = mask_or_polygons
        if isinstance(m, dict):  # RLE
            from lvc_tpu_torch.structures.masks import rle_to_bitmask

            self._mask = rle_to_bitmask(m)
        elif isinstance(m, (list, tuple)):  # polygons
            self._polygons = [np.asarray(p, np.float64).reshape(-1) for p in m]
        else:
            arr = np.asarray(m)
            assert arr.ndim == 2, f"mask must be 2D, got {arr.shape}"
            self._mask = arr.astype(bool)

    @property
    def mask(self) -> np.ndarray:
        if self._mask is None:
            from lvc_tpu_torch.structures.masks import polygons_to_bitmask

            self._mask = polygons_to_bitmask(self._polygons, self.height, self.width)
        return self._mask

    @property
    def polygons(self) -> List[np.ndarray]:
        return self._polygons if self._polygons is not None else []

    def area(self) -> float:
        return float(self.mask.sum())

    def bbox(self) -> np.ndarray:
        ys, xs = np.nonzero(self.mask)
        if len(ys) == 0:
            return np.zeros(4, np.float32)
        return np.array([xs.min(), ys.min(), xs.max() + 1, ys.max() + 1], np.float32)


class _PanopticPrediction:
    """Splits a panoptic id map into per-segment masks (reference
    visualizer.py:149-195)."""

    def __init__(self, panoptic_seg: np.ndarray, segments_info: Sequence[dict]):
        self._seg = np.asarray(panoptic_seg)
        self._sinfo = {s["id"]: s for s in segments_info}

    def non_empty_mask(self) -> np.ndarray:
        """Mask of pixels belonging to no listed segment."""
        known = np.isin(self._seg, list(self._sinfo.keys())) if self._sinfo else np.zeros_like(
            self._seg, bool
        )
        return ~known

    def semantic_masks(self):
        for sid, sinfo in self._sinfo.items():
            if sinfo.get("isthing"):
                continue
            yield (self._seg == sid), sinfo

    def instance_masks(self):
        for sid, sinfo in self._sinfo.items():
            if not sinfo.get("isthing"):
                continue
            mask = self._seg == sid
            if mask.any():
                yield mask, sinfo


def _create_text_labels(classes, scores, class_names) -> Optional[List[str]]:
    """Reference visualizer.py:197-215."""
    labels = None
    if classes is not None and class_names is not None and len(class_names) > 0:
        labels = [
            class_names[int(i)] if 0 <= int(i) < len(class_names) else str(int(i))
            for i in classes
        ]
    if scores is not None:
        if labels is None:
            labels = [f"{s * 100:.0f}%" for s in scores]
        else:
            labels = [f"{l} {s * 100:.0f}%" for l, s in zip(labels, scores)]
    return labels


class VisImage:
    def __init__(self, img: Image.Image):
        self.pil = img

    def save(self, filepath: str):
        self.pil.save(filepath)

    def get_image(self) -> np.ndarray:
        return np.asarray(self.pil)


class Visualizer:
    """img: (H, W, 3) uint8 RGB. ``metadata`` may be a MetadataCatalog entry
    or a dict exposing ``thing_classes`` / ``stuff_classes`` / color tables."""

    def __init__(
        self,
        img_rgb: np.ndarray,
        metadata=None,
        scale: float = 1.0,
        instance_mode: ColorMode = ColorMode.IMAGE,
    ):
        img = np.asarray(img_rgb).clip(0, 255).astype(np.uint8)
        self.img = Image.fromarray(img).convert("RGB")
        self._orig_size = self.img.size  # (W, H) pre-scale
        if scale != 1.0:
            self.img = self.img.resize(
                (int(self.img.width * scale), int(self.img.height * scale))
            )
        self.scale = scale
        self.metadata = metadata
        self.instance_mode = instance_mode
        self._draw = ImageDraw.Draw(self.img, "RGBA")
        self._cmap = colormap(rgb=True)

    # ------------------------------------------------------------- metadata
    def _meta(self, key, default=None):
        if self.metadata is None:
            return default
        if isinstance(self.metadata, dict):
            return self.metadata.get(key, default)
        return getattr(self.metadata, key, default)

    def _class_name(self, cls_id: int) -> str:
        names = self._meta("thing_classes")
        if names and 0 <= int(cls_id) < len(names):
            return names[int(cls_id)]
        return str(int(cls_id))

    def _color(self, cls_id: int) -> tuple:
        table = self._meta("thing_colors")
        if table and 0 <= int(cls_id) < len(table):
            return tuple(int(v) for v in table[int(cls_id)])
        c = self._cmap[int(cls_id) % len(self._cmap)]
        return tuple(int(v) for v in c)

    def _stuff_color(self, cls_id: int) -> tuple:
        table = self._meta("stuff_colors")
        if table and 0 <= int(cls_id) < len(table):
            return tuple(int(v) for v in table[int(cls_id)])
        c = self._cmap[(int(cls_id) + 37) % len(self._cmap)]
        return tuple(int(v) for v in c)

    def _jitter(self, color) -> tuple:
        """Small random hue/sat shift so same-class instances are
        distinguishable (reference visualizer.py:1068-1085)."""
        vec = np.random.rand(3) - 0.5
        jittered = np.clip(np.asarray(color, np.float64) / 255.0 + vec * 0.2, 0, 1)
        return tuple(int(v * 255) for v in jittered)

    def _change_color_brightness(self, color, brightness_factor: float) -> tuple:
        """Reference visualizer.py:1098-1121 (HLS lightness scale)."""
        r, g, b = [v / 255.0 for v in color]
        h, l, s = colorsys.rgb_to_hls(r, g, b)
        l = min(1.0, max(0.0, l + brightness_factor * l))
        r, g, b = colorsys.hls_to_rgb(h, l, s)
        return (int(r * 255), int(g * 255), int(b * 255))

    def _create_grayscale_image(self, mask: Optional[np.ndarray] = None):
        """Desaturate the canvas, optionally keeping ``mask`` pixels in
        color (ColorMode.IMAGE_BW, reference visualizer.py:1087-1096)."""
        rgb = np.asarray(self.img).astype(np.float32)
        gray = rgb.mean(axis=2, keepdims=True).repeat(3, axis=2)
        if mask is not None:
            m = np.asarray(mask, bool)
            if m.shape != gray.shape[:2]:
                m = np.asarray(
                    Image.fromarray(m.astype(np.uint8) * 255).resize(self.img.size)
                ).astype(bool)
            gray[m] = rgb[m]
        self.img = Image.fromarray(gray.clip(0, 255).astype(np.uint8))
        self._draw = ImageDraw.Draw(self.img, "RGBA")

    # ------------------------------------------------------------ primitives
    def draw_box(self, box_xyxy: Sequence[float], color=(0, 255, 0), width: int = 2):
        x0, y0, x1, y1 = [v * self.scale for v in box_xyxy]
        self._draw.rectangle([x0, y0, x1, y1], outline=tuple(color), width=width)
        return self

    def draw_text(self, text: str, position, color=(255, 255, 255)):
        x, y = position[0] * self.scale, position[1] * self.scale
        w = max(6 * len(text), 8)
        self._draw.rectangle([x, y, x + w, y + 11], fill=(0, 0, 0, 180))
        self._draw.text((x + 1, y), text, fill=tuple(color))
        return self

    def draw_circle(self, center, color=(0, 255, 0), radius: int = 3):
        x, y = center[0] * self.scale, center[1] * self.scale
        self._draw.ellipse([x - radius, y - radius, x + radius, y + radius], fill=tuple(color))
        return self

    def draw_line(self, x_data: Sequence[float], y_data: Sequence[float], color=(0, 255, 0), linewidth: int = 2):
        pts = [(x * self.scale, y * self.scale) for x, y in zip(x_data, y_data)]
        self._draw.line(pts, fill=tuple(color), width=linewidth)
        return self

    def draw_polygon(self, segment, color=(0, 255, 0), edge_color=None, alpha: float = 0.5):
        """segment: (N, 2) polygon vertices."""
        pts = [
            (float(x) * self.scale, float(y) * self.scale)
            for x, y in np.asarray(segment, np.float64).reshape(-1, 2)
        ]
        if len(pts) < 3:
            return self
        edge = tuple(edge_color) if edge_color else self._change_color_brightness(color, -0.7)
        self._draw.polygon(pts, fill=(*color, int(alpha * 255)), outline=edge)
        return self

    def draw_rotated_box_with_label(
        self, rotated_box, color=(0, 255, 0), label: Optional[str] = None
    ):
        """rotated_box: (cx, cy, w, h, angle_deg), angle ccw (reference
        visualizer.py:869-922)."""
        cx, cy, w, h, a = [float(v) for v in rotated_box]
        theta = -a * np.pi / 180.0  # image y points down
        c, s = np.cos(theta), np.sin(theta)
        rel = np.array(
            [[-w / 2, -h / 2], [w / 2, -h / 2], [w / 2, h / 2], [-w / 2, h / 2]]
        )
        rot = rel @ np.array([[c, -s], [s, c]]).T + np.array([cx, cy])
        pts = [(x * self.scale, y * self.scale) for x, y in rot]
        self._draw.line(pts + [pts[0]], fill=tuple(color), width=2)
        if label:
            self.draw_text(label, rot[0], color=(255, 255, 255))
        return self

    def draw_binary_mask(
        self,
        mask: np.ndarray,
        color=(0, 255, 0),
        alpha: float = 0.4,
        edge: bool = True,
        text: Optional[str] = None,
        area_threshold: float = 0,
    ):
        """Alpha overlay + 1px boundary. The boundary is the mask minus its
        4-neighbour erosion (the reference draws cv2 contours; same visual
        role without the dependency)."""
        m = np.asarray(mask, bool)
        if m.sum() <= area_threshold:
            return self
        overlay = np.zeros((*m.shape, 4), np.uint8)
        overlay[m] = (*color, int(alpha * 255))
        if edge:
            interior = (
                m
                & np.roll(m, 1, 0) & np.roll(m, -1, 0)
                & np.roll(m, 1, 1) & np.roll(m, -1, 1)
            )
            boundary = m & ~interior
            overlay[boundary] = (*self._change_color_brightness(color, -0.5), 255)
        ov = Image.fromarray(overlay, "RGBA")
        if ov.size != self.img.size:
            ov = ov.resize(self.img.size)
        self.img.paste(ov, (0, 0), ov)
        self._draw = ImageDraw.Draw(self.img, "RGBA")
        if text:
            ys, xs = np.nonzero(m)
            # label at the median point of the largest blob, like the
            # reference's center-of-mass placement (visualizer.py:1010-1023)
            self.draw_text(
                text,
                (float(np.median(xs)), float(np.median(ys))),
                color=(255, 255, 255),
            )
        return self

    def draw_and_connect_keypoints(self, keypoints: np.ndarray) -> "Visualizer":
        """keypoints: (K, 3) of (x, y, visibility). Draws visible points and
        the metadata skeleton (reference visualizer.py:726-786)."""
        names = self._meta("keypoint_names", COCO_PERSON_KEYPOINT_NAMES)
        rules = self._meta("keypoint_connection_rules", KEYPOINT_CONNECTION_RULES)
        kp = np.asarray(keypoints, np.float64).reshape(-1, 3)
        visible = {}
        for i, (x, y, v) in enumerate(kp):
            if v > 0:
                self.draw_circle((x, y), color=(255, 0, 0))
                if names and i < len(names):
                    visible[names[i]] = (x, y)
        for a, b, color in rules:
            if a in visible and b in visible:
                (x0, y0), (x1, y1) = visible[a], visible[b]
                self.draw_line([x0, x1], [y0, y1], color=tuple(color))
        # nose->mid-shoulder->mid-hip trunk, as the reference draws
        if "nose" in visible and "left_shoulder" in visible and "right_shoulder" in visible:
            ls, rs = visible["left_shoulder"], visible["right_shoulder"]
            mid_s = ((ls[0] + rs[0]) / 2, (ls[1] + rs[1]) / 2)
            nx, ny = visible["nose"]
            self.draw_line([nx, mid_s[0]], [ny, mid_s[1]], color=(0, 0, 255))
            if "left_hip" in visible and "right_hip" in visible:
                lh, rh = visible["left_hip"], visible["right_hip"]
                mid_h = ((lh[0] + rh[0]) / 2, (lh[1] + rh[1]) / 2)
                self.draw_line(
                    [mid_s[0], mid_h[0]], [mid_s[1], mid_h[1]], color=(0, 0, 255)
                )
        return self

    # --------------------------------------------------------------- overlays
    def overlay_instances(
        self,
        boxes: Optional[np.ndarray] = None,
        labels: Optional[Sequence[str]] = None,
        masks: Optional[Sequence] = None,
        keypoints: Optional[np.ndarray] = None,
        assigned_colors: Optional[Sequence[tuple]] = None,
        alpha: float = 0.4,
    ) -> VisImage:
        """Core compositor (reference visualizer.py:549-686). ``masks``
        entries may be binary arrays, polygon lists, or RLE dicts."""
        num = 0
        for x in (boxes, masks, keypoints, labels):
            if x is not None:
                num = max(num, len(x))
        if num == 0:
            return VisImage(self.img)
        W, H = self._orig_size
        gms = (
            [GenericMask(m, H, W) if not isinstance(m, GenericMask) else m for m in masks]
            if masks is not None
            else None
        )
        if assigned_colors is None:
            assigned_colors = [random_color(rgb=True) for _ in range(num)]
        # draw large instances first so small ones stay visible (reference
        # sorts by area, visualizer.py:597-608)
        areas = None
        if boxes is not None:
            b = np.asarray(boxes)
            areas = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
        elif gms is not None:
            areas = np.asarray([g.area() for g in gms])
        order = np.argsort(-areas) if areas is not None else np.arange(num)

        for i in order:
            color = tuple(int(v) for v in assigned_colors[i])
            if gms is not None and i < len(gms):
                if gms[i].polygons:
                    for seg in gms[i].polygons:
                        self.draw_polygon(seg.reshape(-1, 2), color=color, alpha=alpha)
                else:
                    self.draw_binary_mask(gms[i].mask, color=color, alpha=alpha)
            if boxes is not None and i < len(boxes):
                self.draw_box(boxes[i], color=color)
            if labels is not None and i < len(labels):
                if boxes is not None and i < len(boxes):
                    pos = (boxes[i][0], boxes[i][1])
                elif gms is not None and i < len(gms):
                    bb = gms[i].bbox()
                    pos = (bb[0], bb[1])
                else:
                    pos = (0, 0)
                self.draw_text(labels[i], pos)
            if keypoints is not None and i < len(keypoints):
                self.draw_and_connect_keypoints(keypoints[i])
        return VisImage(self.img)

    def overlay_rotated_instances(
        self, boxes=None, labels=None, assigned_colors=None
    ) -> VisImage:
        """boxes: (N, 5) cx/cy/w/h/angle (reference visualizer.py:688-724)."""
        if boxes is None or len(boxes) == 0:
            return VisImage(self.img)
        if assigned_colors is None:
            assigned_colors = [random_color(rgb=True) for _ in range(len(boxes))]
        areas = np.asarray([b[2] * b[3] for b in boxes])
        for i in np.argsort(-areas):
            self.draw_rotated_box_with_label(
                boxes[i],
                color=tuple(int(v) for v in assigned_colors[i]),
                label=labels[i] if labels is not None else None,
            )
        return VisImage(self.img)

    def draw_instance_predictions(
        self,
        boxes: np.ndarray,  # (D, 4) XYXY
        scores: np.ndarray,  # (D,)
        classes: np.ndarray,  # (D,)
        valid: Optional[np.ndarray] = None,
        masks: Optional[np.ndarray] = None,  # (D, H, W) bool
        keypoints: Optional[np.ndarray] = None,  # (D, K, 3)
    ) -> VisImage:
        """Padded-Detections entry point (our fixed-shape output contract;
        reference equivalent consumes Instances, visualizer.py:354-401)."""
        boxes = np.asarray(boxes)
        scores = np.asarray(scores)
        classes = np.asarray(classes)
        valid = np.ones(len(boxes), bool) if valid is None else np.asarray(valid, bool)
        keep = np.flatnonzero(valid)
        labels = _create_text_labels(
            classes[keep], scores[keep], self._meta("thing_classes")
        )
        if labels is None:
            labels = [f"{self._class_name(c)} {s:.0%}" for c, s in zip(classes[keep], scores[keep])]
        if self.instance_mode == ColorMode.SEGMENTATION:
            colors = [self._jitter(self._color(c)) for c in classes[keep]]
        else:
            colors = [self._color(c) for c in classes[keep]]
        if self.instance_mode == ColorMode.IMAGE_BW:
            bw_mask = None
            if masks is not None and len(keep):
                bw_mask = np.any(np.asarray(masks, bool)[keep], axis=0)
            self._create_grayscale_image(bw_mask)
        return self.overlay_instances(
            boxes=boxes[keep],
            labels=labels,
            masks=[masks[i] for i in keep] if masks is not None else None,
            keypoints=np.asarray(keypoints)[keep] if keypoints is not None else None,
            assigned_colors=colors,
        )

    def draw_sem_seg(
        self, sem_seg: np.ndarray, area_threshold: float = 0, alpha: float = 0.8
    ) -> VisImage:
        """(H, W) int class map (reference visualizer.py:403-437)."""
        sem_seg = np.asarray(sem_seg)
        ignore = self._meta("ignore_label", 255)
        stuff_names = self._meta("stuff_classes")
        for cls_id in np.unique(sem_seg):
            if cls_id == ignore:
                continue
            mask = sem_seg == cls_id
            text = (
                stuff_names[int(cls_id)]
                if stuff_names and 0 <= int(cls_id) < len(stuff_names)
                else str(int(cls_id))
            )
            self.draw_binary_mask(
                mask,
                color=self._stuff_color(int(cls_id)),
                alpha=alpha,
                text=text,
                area_threshold=area_threshold,
            )
        return VisImage(self.img)

    def draw_panoptic_seg_predictions(
        self,
        panoptic_seg: np.ndarray,
        segments_info: Sequence[dict],
        area_threshold: float = 0,
        alpha: float = 0.7,
    ) -> VisImage:
        """(H, W) segment-id map + segments_info dicts with id/isthing/
        category_id (reference visualizer.py:439-497)."""
        pred = _PanopticPrediction(panoptic_seg, segments_info)
        if self.instance_mode == ColorMode.IMAGE_BW:
            self._create_grayscale_image(~pred.non_empty_mask())
        stuff_names = self._meta("stuff_classes")
        for mask, sinfo in pred.semantic_masks():
            cid = int(sinfo["category_id"])
            text = (
                stuff_names[cid] if stuff_names and 0 <= cid < len(stuff_names) else str(cid)
            )
            self.draw_binary_mask(
                mask,
                color=self._stuff_color(cid),
                alpha=alpha,
                text=text,
                area_threshold=area_threshold,
            )
        inst = list(pred.instance_masks())
        if inst:
            masks = [m for m, _ in inst]
            cats = [int(s["category_id"]) for _, s in inst]
            labels = [
                self._class_name(c)
                + (f' {s["score"]:.0%}' if "score" in s else "")
                for c, (_, s) in zip(cats, inst)
            ]
            self.overlay_instances(
                masks=masks,
                labels=labels,
                assigned_colors=[self._jitter(self._color(c)) for c in cats],
                alpha=alpha * 0.7,
            )
        return VisImage(self.img)

    def draw_dataset_dict(self, dataset_dict: dict) -> VisImage:
        """Overlay gt annotations of a catalog-format dict, including
        segmentations and keypoints (reference visualizer.py:499-547)."""
        from lvc_tpu_torch.structures.boxes import BoxMode

        annos = dataset_dict.get("annotations", [])
        boxes, labels, masks, kpts, colors = [], [], [], [], []
        for a in annos:
            b = list(map(float, a["bbox"]))
            if a.get("bbox_mode", BoxMode.XYWH_ABS) == BoxMode.XYWH_ABS:
                b = [b[0], b[1], b[0] + b[2], b[1] + b[3]]
            boxes.append(b)
            cid = a.get("category_id", 0)
            name = self._class_name(cid)
            if a.get("iscrowd"):
                name += "|crowd"
            if a.get("ignore_qe"):
                name += "|ignore"
            labels.append(name)
            masks.append(a.get("segmentation"))
            kpts.append(a.get("keypoints"))
            colors.append(self._color(cid))
        has_masks = any(m is not None for m in masks)
        has_kpts = any(k is not None for k in kpts)
        W, H = self._orig_size
        out = self.overlay_instances(
            boxes=np.asarray(boxes, np.float64).reshape(-1, 4),
            labels=labels,
            masks=[m if m is not None else np.zeros((H, W), bool) for m in masks]
            if has_masks
            else None,
            keypoints=np.asarray(
                [
                    np.asarray(k, np.float64).reshape(-1, 3)
                    if k is not None
                    else np.zeros((len(COCO_PERSON_KEYPOINT_NAMES), 3))
                    for k in kpts
                ]
            )
            if has_kpts
            else None,
            assigned_colors=colors,
        )
        sem_seg = dataset_dict.get("sem_seg")
        if sem_seg is None and dataset_dict.get("sem_seg_file_name"):
            try:
                sem_seg = np.asarray(Image.open(dataset_dict["sem_seg_file_name"]))
            except OSError:
                sem_seg = None
        if sem_seg is not None:
            out = self.draw_sem_seg(sem_seg, alpha=0.5)
        return out

    def get_output(self) -> VisImage:
        return VisImage(self.img)
