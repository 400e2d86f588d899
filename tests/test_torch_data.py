"""The port's data path against the JAX package's on the CPU.

On a seeded COCO tree (``chip_smoke.write_coco_tree``: JPEG images of four
sizes, 1-5 boxes each, some of them crowd boxes), the same dataset dicts go
through both packages:

- ``DatasetMapper`` bit for bit, with JAX at ``INPUT.LOADER_S2D "off"``
  (the port's only canvas): train with crop, resize, flip, colour jitter
  and blur, and eval, with and without the ignore boxes;
- the samplers give equal index streams for a seed;
- ``get_dataset_dicts_all``'s few-shot ``all`` merge (and the QE branch's
  ``remove_ignore_overlap``, and ``unseen_sample``) give equal dicts;
- the first batches of ``TrainLoader`` (also with the mosaic mapper) and
  ``EvalLoader`` are equal, the
  eval metas and the padded last batch included (one loader worker: the
  mapper's random stream is shared by its threads, so with more workers
  the order of the draws depends on scheduling, in JAX as here);
- the native decoder and resize give the same bytes in both packages.

Tolerance: none; every array is compared for equality.
"""
import copy
import itertools
import os

import numpy as np
import pytest

import chip_smoke
from lvc_tpu.config import get_cfg as jax_get_cfg
from lvc_tpu.data import build as jax_build
from lvc_tpu.data import builtin as jax_builtin  # noqa: F401
from lvc_tpu.data import catalog as jax_catalog
from lvc_tpu.data import native_io as jax_native_io
from lvc_tpu.data import samplers as jax_samplers
from lvc_tpu.data import utils as jax_utils
from lvc_tpu.data.builtin_meta import _get_builtin_metadata as jax_meta
from lvc_tpu.data.dataset_mapper import DatasetMapper as JaxMapper
from lvc_tpu.data.dataset_mapper import read_image as jax_read_image
from lvc_tpu.data.meta_coco import register_meta_coco as jax_register
from lvc_tpu_torch.config import get_cfg
from lvc_tpu_torch.data import build
from lvc_tpu_torch.data import builtin  # noqa: F401
from lvc_tpu_torch.data import catalog as port_catalog
from lvc_tpu_torch.data import native_io, samplers
from lvc_tpu_torch.data import utils as port_utils
from lvc_tpu_torch.data.builtin_meta import COCO_CATEGORIES
from lvc_tpu_torch.data.builtin_meta import _get_builtin_metadata as port_meta
from lvc_tpu_torch.data.dataset_mapper import DatasetMapper, read_image
from lvc_tpu_torch.data.meta_coco import register_meta_coco as port_register
from lvc_tpu_torch.data.mosaic import MosaicDatasetMapper

SIZES = ((96, 128), (128, 96), (80, 80), (100, 70))
N_TRAIN, N_TEST = 10, 5


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The seeded tree, registered as the COCO splits in both catalogs, with
    2-shot files of the base classes for the few-shot merge."""
    import json

    root = str(tmp_path_factory.mktemp("datasets"))
    base = port_meta("coco_fewshot")["base_classes"][:6]
    name_to_id = {c["name"]: c["id"] for c in COCO_CATEGORIES}
    ids = [name_to_id[n] for n in base] + [1, 18]  # two novel classes too (person, dog)
    chip_smoke.write_coco_tree(root, N_TRAIN, N_TEST, sizes=SIZES, seed=3, max_boxes=5, crowd=0.15,
                               category_ids=ids)
    chip_smoke.register_coco_tree(root, jax_catalog.DatasetCatalog, jax_register, jax_meta("coco_fewshot"))
    chip_smoke.register_coco_tree(root, port_catalog.DatasetCatalog, port_register,
                                  port_meta("coco_fewshot"))
    # the 2-shot files, one per class, of the few-shot training split
    with open(os.path.join(root, "cocosplit", "datasplit", "trainvalno5k.json")) as f:
        gt = json.load(f)
    for c in COCO_CATEGORIES:
        anns = [a for a in gt["annotations"] if a["category_id"] == c["id"] and not a["iscrowd"]][:3]
        imgs = [im for im in gt["images"] if im["id"] in {a["image_id"] for a in anns}]
        with open(os.path.join(root, "cocosplit", f"full_box_2shot_{c['name']}_trainval.json"), "w") as f:
            json.dump({"images": imgs, "annotations": anns, "categories": gt["categories"]}, f)
    saved = os.environ.get("DETECTRON2_DATASETS")
    os.environ["DETECTRON2_DATASETS"] = root
    _register_2shot(root)
    yield root
    # the registrations as the packages made them at import
    original = saved or "datasets"
    if saved is None:
        os.environ.pop("DETECTRON2_DATASETS")
    else:
        os.environ["DETECTRON2_DATASETS"] = saved
    chip_smoke.register_coco_tree(original, jax_catalog.DatasetCatalog, jax_register, jax_meta("coco_fewshot"))
    chip_smoke.register_coco_tree(original, port_catalog.DatasetCatalog, port_register,
                                  port_meta("coco_fewshot"))
    _register_2shot(original)


def _register_2shot(root):
    for catalog, register, meta in ((jax_catalog.DatasetCatalog, jax_register, jax_meta),
                                    (port_catalog.DatasetCatalog, port_register, port_meta)):
        name = "coco_trainval_all_2shot"
        if name in catalog:
            catalog.remove(name)
        register(name, meta("coco_fewshot"), os.path.join(root, "coco", "trainval2014"), "")


def _cfgs(**over):
    out = []
    for cfg in (jax_get_cfg(), get_cfg()):
        cfg.INPUT.LOADER_S2D = "off"
        cfg.INPUT.MIN_SIZE_TRAIN = (64, 72, 80)
        cfg.INPUT.MAX_SIZE_TRAIN = 128
        cfg.INPUT.MIN_SIZE_TEST = 72
        cfg.INPUT.MAX_SIZE_TEST = 128
        cfg.PAD.CANVAS_BUCKETS = [[96, 128], [128, 96], [128, 128]]
        cfg.PAD.MAX_GT_PER_IMAGE = 6
        cfg.DATALOADER.NUM_WORKERS = 1
        cfg.SEED = 5
        for k, v in over.items():
            node = cfg
            *path, leaf = k.split(".")
            for p in path:
                node = getattr(node, p)
            setattr(node, leaf, v)
        out.append(cfg)
    return out


def _assert_examples_equal(got, want):
    assert set(got) == set(want) - {"image_s2d"}
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            assert got[k].dtype == v.dtype, k
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        else:
            assert got[k] == v, k


def _dicts(name):
    return port_catalog.DatasetCatalog.get(name), jax_catalog.DatasetCatalog.get(name)


def test_dataset_dicts_equal(tree):
    for name in ("coco_trainval_base", "coco_test_all", "coco_trainval_all_2shot"):
        np.random.seed(0)
        got = port_catalog.DatasetCatalog.get(name)
        np.random.seed(0)
        assert got == jax_catalog.DatasetCatalog.get(name)


@pytest.mark.parametrize("mode", ["train", "train_augmented", "eval", "eval_keep_ignore"])
def test_mapper_bit_equal_to_jax(tree, mode):
    over = {}
    if mode == "train_augmented":
        over = {"INPUT.CROP.ENABLED": True, "INPUT.COLOR_JITTER": True, "INPUT.BLUR": True}
    jcfg, pcfg = _cfgs(**over)
    train = mode.startswith("train")
    keep = mode == "eval_keep_ignore"
    name = "coco_trainval_base" if train else "coco_test_all"
    dicts, _ = _dicts(name)
    want_mapper = JaxMapper(jcfg, is_train=train, keep_ignore=keep, seed=7)
    got_mapper = DatasetMapper(pcfg, is_train=train, keep_ignore=keep, seed=7)
    for d in dicts + dicts:  # twice: the random stream goes on
        _assert_examples_equal(got_mapper(copy.deepcopy(d)), want_mapper(copy.deepcopy(d)))


def test_mapper_refuses_the_s2d_canvas():
    _, cfg = _cfgs(**{"INPUT.LOADER_S2D": "on"})
    with pytest.raises(NotImplementedError, match="LOADER_S2D"):
        DatasetMapper(cfg)


@pytest.mark.parametrize("kind", ["TrainingSampler", "RepeatFactorTrainingSampler", "CategoryAwareSampler",
                                  "CategoryAreaAwareSampler", "InferenceSampler", "strided"])
def test_samplers_equal_jax(tree, kind):
    dicts, _ = _dicts("coco_trainval_base")
    if kind == "InferenceSampler":
        for rank in range(3):
            assert list(samplers.InferenceSampler(17, rank, 3)) == list(
                jax_samplers.InferenceSampler(17, rank, 3))
        return
    if kind == "strided":
        got = samplers.TrainingSampler(len(dicts), seed=4, rank=1, world_size=2)
        want = jax_samplers.TrainingSampler(len(dicts), seed=4, rank=1, world_size=2)
    elif kind == "TrainingSampler":
        got, want = samplers.TrainingSampler(len(dicts), seed=4), jax_samplers.TrainingSampler(len(dicts), seed=4)
    elif kind == "RepeatFactorTrainingSampler":
        got = samplers.RepeatFactorTrainingSampler(dicts, 0.3, seed=4)
        want = jax_samplers.RepeatFactorTrainingSampler(dicts, 0.3, seed=4)
    else:
        got = getattr(samplers, kind)(dicts, seed=4)
        want = getattr(jax_samplers, kind)(dicts, seed=4)
    n = 5 * len(dicts)
    assert list(itertools.islice(got, n)) == list(itertools.islice(want, n))


def test_dataset_dicts_all_few_shot_merge_equal_jax(tree):
    """The ``all`` split filtered of the unseen classes, merged with the
    2-shot set filtered of the seen ones (``get_dataset_dicts_all``)."""
    jcfg, pcfg = _cfgs()
    meta = port_meta("coco_fewshot")
    for cfg in (jcfg, pcfg):
        cfg.DATASETS.TRAIN = ("coco_trainval_all",)
        cfg.DATASETS.FS_TRAIN = ("coco_trainval_all_2shot",)
        cfg.DATASETS.UNSEEN_CLASSES = list(meta["novel_classes"])
        cfg.DATASETS.SEEN_CLASSES = list(meta["base_classes"])
    np.random.seed(0)
    got = build.get_dataset_dicts_all(pcfg)
    np.random.seed(0)
    want = jax_build.get_dataset_dicts_all(jcfg)
    assert got == want
    assert len(got) and any(a["category_id"] in (0, 17) for d in got for a in d["annotations"])


def test_merge_utilities_equal_jax(tree):
    """``remove_ignore_overlap`` (the QE branch of the merge) and
    ``unseen_sample`` (``DATASETS.SUBSET``) on the same dicts."""
    dicts, _ = _dicts("coco_trainval_all")
    rng = np.random.RandomState(0)
    for d in dicts:  # ignore_qe copies of some boxes, shifted a little
        for a in list(d["annotations"]):
            if rng.rand() < 0.5:
                b = list(a["bbox"])
                b[0] += rng.randint(-6, 7)
                d["annotations"].append(dict(a, bbox=b, ignore_qe=1))
    for fn in ("remove_ignore_overlap", "unseen_sample"):
        got = getattr(port_utils, fn)(copy.deepcopy(dicts))
        want = getattr(jax_utils, fn)(copy.deepcopy(dicts))
        assert got == want, fn
    assert sum(len(d["annotations"]) for d in port_utils.remove_ignore_overlap(copy.deepcopy(dicts))) < sum(
        len(d["annotations"]) for d in dicts)


def test_train_loader_batches_equal_jax(tree):
    jcfg, pcfg = _cfgs(**{"SOLVER.IMS_PER_BATCH": 2, "DATASETS.TRAIN": ("coco_trainval_base",)})
    got = build.build_detection_train_loader(pcfg)
    want = jax_build.build_detection_train_loader(jcfg)
    for g, w in zip(itertools.islice(got, 6), itertools.islice(want, 6)):
        assert set(g) == set(w)
        for k in w:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_eval_loader_batches_equal_jax(tree):
    jcfg, pcfg = _cfgs()
    got = list(build.build_detection_test_loader(pcfg, "coco_test_all", batch_size=2))
    want = list(jax_build.build_detection_test_loader(jcfg, "coco_test_all", batch_size=2))
    assert len(got) == len(want) >= 3
    assert any(m["padding"] for _, metas in got for m in metas)
    for (gb, gm), (wb, wm) in zip(got, want):
        assert set(gb) == set(wb)
        for k in wb:
            np.testing.assert_array_equal(gb[k], wb[k], err_msg=k)
        assert len(gm) == len(wm)
        for a, b in zip(gm, wm):
            assert set(a) == set(b)
            for k in b:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_loader_refuses_mosaic(tree):
    """Since the mosaic mapper is ported, ``INPUT.MOSAIC`` > 0 no longer
    raises: the train loader wraps its mapper in ``MosaicDatasetMapper`` and
    its first batches (4- and 9-tile mosaics and plain images) equal JAX's."""
    jcfg, pcfg = _cfgs(**{"INPUT.MOSAIC": 0.5, "INPUT.MOSAIC49SPLIT": 0.5, "SOLVER.IMS_PER_BATCH": 2,
                          "DATASETS.TRAIN": ("coco_trainval_base",)})
    got = build.build_detection_train_loader(pcfg)
    assert isinstance(got.mapper, MosaicDatasetMapper)
    want = jax_build.build_detection_train_loader(jcfg)
    for g, w in zip(itertools.islice(got, 6), itertools.islice(want, 6)):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_native_decode_and_resize_equal_jax(tree, tmp_path):
    from PIL import Image

    assert native_io.available() == jax_native_io.available()
    arr = (np.random.RandomState(1).rand(61, 83, 3) * 255).astype(np.uint8)
    paths = [os.path.join(tree, "coco", "val2014", f) for f in sorted(os.listdir(
        os.path.join(tree, "coco", "val2014")))[:2]]
    png = str(tmp_path / "x.png")
    Image.fromarray(arr).save(png)
    for path in paths + [png]:
        for fmt in ("RGB", "BGR"):
            np.testing.assert_array_equal(read_image(path, fmt), jax_read_image(path, fmt))
    if native_io.available():
        for dh, dw in ((40, 55), (61, 83), (130, 170)):
            np.testing.assert_array_equal(native_io.resize(arr, dh, dw), jax_native_io.resize(arr, dh, dw))
        got, size = native_io.load_resize(paths[0], 64, 100)
        want, want_size = jax_native_io.load_resize(paths[0], 64, 100)
        np.testing.assert_array_equal(got, want)
        assert size == want_size
