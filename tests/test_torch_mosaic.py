"""The port's mosaic augmentation against ``lvc_tpu/data/mosaic.py`` on the
CPU.

- ``get_mosaic4`` and ``get_mosaic9`` on the same seeded dataset dicts and
  uint8 images of mixed sizes and boxes in both box modes: the composite
  image and the merged dict.
- ``MosaicDatasetMapper`` around each package's ``DatasetMapper`` (crop 0.7,
  colour jitter, blur; mosaic probability 0.5, 9 tiles with probability
  0.5), 20 draws in turn on one thread from the same seed over PNG images,
  which both packages decode alike (the port's native JPEG decoder need not
  be PIL's): every output array and field. The draws must take plain
  images, 4-tile and 9-tile mosaics.

Tolerance: none; every array is compared for equality.
"""
import copy
import os

import numpy as np
import pytest
from PIL import Image

from lvc_tpu.config import get_cfg as jax_get_cfg
from lvc_tpu.data import mosaic as jax_mosaic
from lvc_tpu.data.dataset_mapper import DatasetMapper as JaxMapper
from lvc_tpu_torch.config import get_cfg
from lvc_tpu_torch.data import mosaic
from lvc_tpu_torch.data.dataset_mapper import DatasetMapper
from lvc_tpu_torch.structures.boxes import BoxMode

SIZES = ((60, 80), (80, 50), (48, 48), (70, 90), (52, 66))


def _dicts(root=None, seed=0):
    rng = np.random.RandomState(seed)
    dicts, images = [], []
    for i, (h, w) in enumerate(SIZES):
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        anns = []
        for j in range(rng.randint(1, 4)):
            x, y = rng.uniform(0, w - 20), rng.uniform(0, h - 20)
            bw, bh = rng.uniform(6, 20, 2)
            xyxy = j % 2 == 1
            anns.append({"bbox": [x, y, x + bw, y + bh] if xyxy else [x, y, bw, bh],
                         "bbox_mode": BoxMode.XYXY_ABS if xyxy else BoxMode.XYWH_ABS,
                         "category_id": int(rng.randint(5)), "iscrowd": 0, "id": 100 * i + j})
        d = {"image_id": i + 1, "height": h, "width": w, "annotations": anns}
        if root is not None:
            d["file_name"] = os.path.join(root, f"img_{i}.png")
            Image.fromarray(img).save(d["file_name"])
        dicts.append(d)
        images.append(img)
    return dicts, images


@pytest.mark.parametrize("n", [4, 9])
def test_mosaic_composition_matches_jax(n):
    dicts, images = _dicts()
    picks = [dicts[i % len(dicts)] for i in range(n)]
    imgs = [images[i % len(images)] for i in range(n)]
    fn = "get_mosaic4" if n == 4 else "get_mosaic9"
    got_img, got = getattr(mosaic, fn)(copy.deepcopy(picks), imgs)
    want_img, want = getattr(jax_mosaic, fn)(copy.deepcopy(picks), imgs)
    np.testing.assert_array_equal(got_img, want_img)
    assert got == want
    assert len(got["annotations"]) == sum(len(p["annotations"]) for p in picks)
    assert (got["height"], got["width"]) == got_img.shape[:2]


def _cfg(cfg):
    cfg.INPUT.LOADER_S2D = "off"
    cfg.INPUT.MIN_SIZE_TRAIN = (64, 72, 80)
    cfg.INPUT.MAX_SIZE_TRAIN = 128
    cfg.INPUT.CROP.ENABLED = True
    cfg.INPUT.CROP.SIZE = [0.7, 0.7]
    cfg.INPUT.COLOR_JITTER = True
    cfg.INPUT.BLUR = True
    cfg.PAD.CANVAS_BUCKETS = [[96, 128], [128, 96], [128, 128]]
    cfg.PAD.MAX_GT_PER_IMAGE = 12
    return cfg


def test_mosaic_mapper_matches_jax(tmp_path, monkeypatch):
    dicts, _ = _dicts(str(tmp_path), seed=1)
    tiles = []
    for fn, n in (("get_mosaic4", 4), ("get_mosaic9", 9)):
        real = getattr(mosaic, fn)
        monkeypatch.setattr(mosaic, fn, lambda *a, real=real, n=n: tiles.append(n) or real(*a))
    got_mapper = mosaic.MosaicDatasetMapper(DatasetMapper(_cfg(get_cfg()), is_train=True, seed=3), dicts, 0.5, 0.5,
                                            seed=3)
    want_mapper = jax_mosaic.MosaicDatasetMapper(JaxMapper(_cfg(jax_get_cfg()), is_train=True, seed=3), dicts, 0.5,
                                                 0.5, seed=3)
    for i in range(20):
        d = dicts[i % len(dicts)]
        got, want = got_mapper(copy.deepcopy(d)), want_mapper(copy.deepcopy(d))
        assert set(got) == set(want) - {"image_s2d"}
        for k, w in want.items():
            if k == "image_s2d":
                continue
            if isinstance(w, np.ndarray):
                assert got[k].dtype == w.dtype, k
                np.testing.assert_array_equal(got[k], w, err_msg=f"draw {i}: {k}")
            else:
                assert got[k] == w, k
    assert 0 < len(tiles) < 20 and set(tiles) == {4, 9}  # plain images, 4- and 9-tile mosaics
    state = got_mapper.rng.get_state()
    assert state[2] == want_mapper.rng.get_state()[2] and np.array_equal(state[1], want_mapper.rng.get_state()[1])
