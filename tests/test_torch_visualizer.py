"""The port's visualizers against the JAX package's on the CPU: every drawing
of ``tests/test_visualizer.py`` and ``tests/test_d2_surface.py`` (instances
with masks and keypoints, the three colour modes, sem-seg, panoptic, dataset
dicts, rotated boxes and primitives, keypoint skeletons, scaled output) and
the video visualizer's tracked colours give equal pixel arrays: no pixel
differs. Both packages draw random colours where none is assigned
(``random_color`` with no seed, ``np.random`` jitter); the test seeds numpy's
global generator and gives both the same stand-in for ``random_color``."""
import numpy as np
import pytest

import lvc_tpu.utils.video_visualizer as jvideo
import lvc_tpu.utils.visualizer as jvis
import lvc_tpu_torch.utils.video_visualizer as pvideo
import lvc_tpu_torch.utils.visualizer as pvis
from lvc_tpu.modeling.roi_heads.fast_rcnn import Detections as JaxDetections
from lvc_tpu.structures.masks import bitmask_to_rle
from lvc_tpu.utils import colormap as jcolormap
from lvc_tpu_torch.modeling.roi_heads.fast_rcnn import Detections
from lvc_tpu_torch.utils import colormap as pcolormap


@pytest.fixture(autouse=True)
def seeded_colors(monkeypatch):
    def colors():  # the palette in order, one sequence for each package
        counter = iter(range(10 ** 6))
        return lambda rgb=False, maximum=255, seed=None: jcolormap.colormap(rgb, maximum)[next(counter) % 80]

    for mods in ((jvis, jvideo), (pvis, pvideo)):
        color = colors()
        for mod in mods:
            monkeypatch.setattr(mod, "random_color", color)


def _img(h=64, w=80):
    return np.full((h, w, 3), 127, np.uint8)


def _instances(V):
    h, w = 64, 80
    masks = np.zeros((2, h, w), bool)
    masks[0, 5:20, 5:25] = True
    masks[1, 30:60, 40:75] = True
    kpts = np.zeros((2, 17, 3))
    kpts[0, 0] = [12, 8, 2]
    kpts[0, 5] = [8, 14, 2]
    kpts[0, 6] = [16, 14, 2]
    kpts[0, 11] = [9, 30, 2]
    kpts[0, 12] = [15, 30, 2]
    vis = V.Visualizer(_img(h, w), metadata={"thing_classes": ["cat", "dog"]})
    return vis.draw_instance_predictions(
        boxes=np.array([[5, 5, 25, 20], [40, 30, 75, 60]], np.float32), scores=np.array([0.9, 0.7]),
        classes=np.array([0, 1]), valid=np.array([True, True]), masks=masks, keypoints=kpts,
    ).get_image()


def _color_mode(mode):
    def draw(V):
        img = np.zeros((32, 32, 3), np.uint8)
        img[:, :, 0] = 200
        masks = np.zeros((1, 32, 32), bool)
        masks[0, 6:18, 6:18] = True
        vis = V.Visualizer(img, metadata={"thing_classes": ["x"]}, instance_mode=getattr(V.ColorMode, mode))
        return vis.draw_instance_predictions(
            boxes=np.array([[4, 4, 20, 20]], np.float32), scores=np.array([0.5]), classes=np.array([0]), masks=masks,
        ).get_image()
    return draw


def _sem_seg(V):
    sem = np.zeros((48, 48), np.int32)
    sem[:24] = 1
    sem[24:, :24] = 255
    vis = V.Visualizer(_img(48, 48), metadata={"stuff_classes": ["sky", "road"], "ignore_label": 255})
    return vis.draw_sem_seg(sem, alpha=1.0).get_image()


def _panoptic(mode):
    def draw(V):
        seg = np.zeros((40, 40), np.int32)
        seg[:20] = 1
        seg[25:35, 25:35] = 2
        info = [{"id": 1, "isthing": False, "category_id": 0}, {"id": 2, "isthing": True, "category_id": 3, "score": 0.8}]
        vis = V.Visualizer(_img(40, 40), metadata={"stuff_classes": ["sky"]}, instance_mode=getattr(V.ColorMode, mode))
        return vis.draw_panoptic_seg_predictions(seg, info).get_image()
    return draw


def _dataset_dict(V):
    bit = np.zeros((64, 80), bool)
    bit[10:25, 10:30] = True
    dic = {"annotations": [
        {"bbox": [10, 10, 20, 15], "category_id": 0, "segmentation": [[10, 10, 30, 10, 30, 25, 10, 25]],
         "keypoints": [15, 15, 2] + [0, 0, 0] * 16},
        {"bbox": [40, 30, 30, 25], "category_id": 1, "segmentation": bitmask_to_rle(bit), "iscrowd": 1},
        {"bbox": [1, 1, 10, 10], "category_id": 0, "ignore_qe": True},
    ], "sem_seg": np.where(bit, 1, 0)}
    return V.Visualizer(_img(), metadata={"thing_classes": ["cat", "dog"]}).draw_dataset_dict(dic).get_image()


def _rotated_and_primitives(V):
    vis = V.Visualizer(_img())
    vis.draw_circle((10, 10))
    vis.draw_line([5, 30], [40, 40], color=(255, 0, 0))
    vis.draw_polygon(np.array([[50, 10], [70, 10], [60, 30]]), color=(0, 0, 255))
    vis.draw_text("label", (3, 50))
    boxes = np.array([[40.0, 32.0, 30.0, 16.0, 30.0], [20.0, 20.0, 10.0, 24.0, -60.0]])
    return vis.overlay_rotated_instances(boxes=boxes, labels=["obj 55%", "b"]).get_image()


def _skeleton(V):
    kp = np.zeros((17, 3))
    kp[5] = [10, 10, 2]
    kp[7] = [10, 40, 2]
    vis = V.Visualizer(_img())
    vis.draw_and_connect_keypoints(kp)
    return np.asarray(vis.img)


def _scaled(V):
    vis = V.Visualizer(_img(64, 80), scale=2.0)
    return vis.draw_instance_predictions(
        boxes=np.array([[5, 5, 25, 20]], np.float32), scores=np.array([0.9]), classes=np.array([0]),
        masks=np.ones((1, 64, 80), bool),
    ).get_image()


def _surface(V):
    vis = V.Visualizer(np.zeros((50, 50, 3), np.uint8), metadata={"thing_classes": ["cat", "dog"]})
    return vis.draw_instance_predictions(
        np.array([[5, 5, 30, 30]], np.float32), np.array([0.9], np.float32), np.array([1], np.int32),
        masks=np.ones((1, 50, 50), bool),
    ).get_image()


DRAWINGS = {
    "instances": _instances, "image": _color_mode("IMAGE"), "segmentation": _color_mode("SEGMENTATION"),
    "image_bw": _color_mode("IMAGE_BW"), "sem_seg": _sem_seg, "panoptic": _panoptic("IMAGE"),
    "panoptic_bw": _panoptic("IMAGE_BW"), "dataset_dict": _dataset_dict,
    "rotated_and_primitives": _rotated_and_primitives, "skeleton": _skeleton, "scaled": _scaled,
    "d2_surface": _surface,
}


@pytest.mark.parametrize("name", sorted(DRAWINGS))
def test_drawing_equals_jax(name, seeded_colors):
    np.random.seed(0)
    want = DRAWINGS[name](jvis)
    np.random.seed(0)
    got = DRAWINGS[name](pvis)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert (want != 127).any()
    diff = np.argwhere((got != want).any(-1))
    assert len(diff) == 0, f"pixels differ at {diff[:10].tolist()}"


def test_colormap_equals_jax():
    for rgb in (False, True):
        for maximum in (1, 255):
            assert np.array_equal(pcolormap.colormap(rgb, maximum), jcolormap.colormap(rgb, maximum))
    assert np.array_equal(pcolormap.random_color(seed=1), jcolormap.random_color(seed=1))


def test_video_visualizer_tracks_as_jax():
    frame = np.zeros((64, 64, 3), np.uint8)

    def dets(cls, offset):
        boxes = np.array([[10 + offset, 10, 30 + offset, 30], [40, 40, 60, 60], [2, 40, 12, 60]], np.float32)
        return cls(boxes=boxes, scores=np.array([0.9, 0.8, 0.3], np.float32), classes=np.array([0, 1, 1]),
                   valid=np.array([True, True, offset < 4]), proposal_idx=np.arange(3))

    jv, pv = jvideo.VideoVisualizer(), pvideo.VideoVisualizer()
    for offset in (0, 2, 4, 30):
        want = jv.draw_instance_predictions(frame, dets(JaxDetections, offset)).get_image()
        got = pv.draw_instance_predictions(frame, dets(Detections, offset)).get_image()
        assert np.array_equal(got, want), offset
        assert [t.color for t in pv._tracked] == [t.color for t in jv._tracked]
