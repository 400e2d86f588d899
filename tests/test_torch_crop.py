"""The crop loaders (``data/crop.py``) against the JAX package on the CPU.

A seeded COCO tree (``chip_smoke.write_coco_tree``: 4 train and 4 test JPEGs
of 96x128 and 128x96, registered in both catalogs) and a proposal pickle in
``RPNEvaluator``'s layout (30 seeded boxes an image, some over the gt boxes,
some too small or too large for the filters). ``build_crop_shots_loader``
(the gt crops of ``DATASETS.FS_TRAIN``), ``build_crop_test_loader`` (the
filtered proposal crops of the test split) and ``build_crop_exem_loader``
(proposal crops plus one shot a batch from ``RandomState(42)``) must give
bit-equal float32 canvases and the same batch composition (sizes,
annotations, proposal boxes, image ids) as JAX's. ``load_coco_rpn_pkl`` and
``register_rpn_coco`` read a COCO-format pickle into equal records and
metadata.
"""
import os
import pickle

import numpy as np
import pytest

import chip_smoke
from lvc_tpu.config import get_cfg as jax_get_cfg
from lvc_tpu.data import crop as jcrop
from lvc_tpu.data.builtin_meta import _get_builtin_metadata as jax_meta
from lvc_tpu.data.catalog import DatasetCatalog as JaxDatasetCatalog
from lvc_tpu.data.catalog import MetadataCatalog as JaxMetadataCatalog
from lvc_tpu.data.meta_coco import register_meta_coco as jax_register_meta_coco

from lvc_tpu_torch.config import get_cfg
from lvc_tpu_torch.data import crop as tcrop
from lvc_tpu_torch.data.builtin_meta import _get_builtin_metadata
from lvc_tpu_torch.data.catalog import DatasetCatalog, MetadataCatalog
from lvc_tpu_torch.data.meta_coco import register_meta_coco


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("crop"))
    chip_smoke.write_coco_tree(root, 4, 4, sizes=((96, 128), (128, 96)), seed=2, max_boxes=4)
    chip_smoke.register_coco_tree(root, DatasetCatalog, register_meta_coco, _get_builtin_metadata("coco_fewshot"))
    chip_smoke.register_coco_tree(root, JaxDatasetCatalog, jax_register_meta_coco, jax_meta("coco_fewshot"))
    rng = np.random.RandomState(3)
    ids, boxes, logits = [], [], []
    for d in DatasetCatalog.get("coco_test_all"):
        xy = rng.rand(30, 2) * [d["width"] - 20, d["height"] - 20]
        wh = 2 + rng.rand(30, 2) * 60
        b = np.concatenate([xy, np.minimum(xy + wh, [d["width"], d["height"]])], 1)
        for j, a in enumerate(d["annotations"][:3]):  # near the gt, so the overlap filter removes some
            x, y, w, h = a["bbox"]
            b[j] = [x + 1, y + 1, x + w - 1, y + h - 1]
        ids.append(d["image_id"])
        boxes.append(b.astype(np.float32))
        logits.append(rng.randn(30).astype(np.float32))
    pkl = os.path.join(root, "coco_proposals_test_results.pkl")
    with open(pkl, "wb") as f:
        pickle.dump({"ids": ids, "boxes": boxes, "objectness_logits": logits}, f)
    return root, pkl


def _cfg(cfg, pkl):
    cfg.merge_from_list([
        "DATASETS.FS_TRAIN", ("coco_trainval_all",), "DATASETS.TEST", ("coco_test_all",),
        "DATASETS.PROPOSAL_FILES_TEST", (pkl,), "MODEL.LOAD_PROPOSALS", True, "SOLVER.IMS_PER_BATCH", 5,
        "DATALOADER.PROPOSALS.AREA_RNG", [30.0, 5000.0], "DATALOADER.PROPOSALS.TOPK", 25,
        "DATALOADER.PROPOSALS.IOU_THRESH", 0.5, "DATALOADER.SHOTS.AREA_RNG", [10.0, 1.0e10],
    ])
    return cfg


def _same_batches(got_loader, want_loader):
    got, want = list(got_loader), list(want_loader)
    assert len(got) == len(want) >= 2 and len(got_loader) == len(want_loader)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        assert g["image"].dtype == np.float32 and g["image"].shape[1:] == (224, 224, 3)
        np.testing.assert_array_equal(g["image"], w["image"])
        np.testing.assert_array_equal(g["image_size"], w["image_size"])
        assert g["image_id"] == w["image_id"]
        assert g.get("annotation") == w.get("annotation")
        for a, b in zip(g.get("proposal_box", []), w.get("proposal_box", [])):
            assert (a is None and b is None) or np.array_equal(a, b)
    return got


def test_shots_loader_matches_jax(tree):
    _, pkl = tree
    got = _same_batches(tcrop.build_crop_shots_loader(_cfg(get_cfg(), pkl)),
                        jcrop.build_crop_shots_loader(_cfg(jax_get_cfg(), pkl)))
    assert all("annotation" in b and "proposal_box" not in b for b in got)


def test_test_loader_matches_jax(tree):
    _, pkl = tree
    got = _same_batches(tcrop.build_crop_test_loader(_cfg(get_cfg(), pkl), "coco_test_all"),
                        jcrop.build_crop_test_loader(_cfg(jax_get_cfg(), pkl), "coco_test_all"))
    n = sum(len(b["image"]) for b in got)
    assert 8 < n < 4 * 25  # the filters removed some proposals


def test_exemplar_loader_matches_jax(tree):
    _, pkl = tree
    got = _same_batches(tcrop.build_crop_exem_loader(_cfg(get_cfg(), pkl), "coco_test_all"),
                        jcrop.build_crop_exem_loader(_cfg(jax_get_cfg(), pkl), "coco_test_all"))
    for b in got:  # 4 proposal crops, then one shot
        assert len(b["image"]) == 5
        assert all(p is not None for p in b["proposal_box"][:4]) and b["proposal_box"][4] is None
        assert all(a is None for a in b["annotation"][:4]) and b["annotation"][4] is not None


def test_rpn_pickle_dataset_matches_jax(tree):
    root, _ = tree
    test = DatasetCatalog.get("coco_test_all")
    dataset = {"images": [{"id": d["image_id"], "file_name": os.path.basename(d["file_name"]), "height": d["height"],
                           "width": d["width"]} for d in test],
               "annotations": [{"id": 10 * i + j, "image_id": d["image_id"], "category_id": a["category_id"],
                                "bbox": a["bbox"], "iscrowd": 0} for i, d in enumerate(test)
                               for j, a in enumerate(d["annotations"])]}
    path = os.path.join(root, "rpn_coco.pkl")
    with open(path, "wb") as f:
        pickle.dump(dataset, f)
    img_dir = os.path.join(root, "coco", "val2014")
    got, want = tcrop.load_coco_rpn_pkl(path, img_dir), jcrop.load_coco_rpn_pkl(path, img_dir)
    assert got == want and len(got) == 4 and all(d["annotations"] for d in got)
    for catalog, meta, register in ((DatasetCatalog, MetadataCatalog, tcrop.register_rpn_coco),
                                    (JaxDatasetCatalog, JaxMetadataCatalog, jcrop.register_rpn_coco)):
        if "rpn_probe" in catalog:
            catalog.remove("rpn_probe")
        register("rpn_probe", {"thing_classes": ["a"]}, img_dir, path)
    assert DatasetCatalog.get("rpn_probe") == JaxDatasetCatalog.get("rpn_probe")
    assert MetadataCatalog.get("rpn_probe").as_dict() == JaxMetadataCatalog.get("rpn_probe").as_dict()
