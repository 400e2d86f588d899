"""The LVIS data and evaluation against the JAX package on the CPU.

A seeded LVIS-style json (8 images of 100x120, 7 categories with synonyms,
boxes of 1-4 categories an image; each image lists some absent categories
in ``neg_category_ids`` and one in ``not_exhaustive_category_ids``, so the
LVIS ignore rule changes the result) in two variants: category frequency
from ``frequency`` and from ``image_count``.

- ``load_lvis_json`` and ``register_meta_lvis``'s lazy ``thing_classes``:
  equal records and metadata.
- ``LVISEvaluator`` on the same seeded detections: every key within abs
  1e-9, the written ``lvis_instances_results.json`` equal.
- Its merge over 2 gloo ranks, each fed its contiguous shard: equal to one
  process fed all images.
"""
import json
import os

import numpy as np
import pytest
import torch

from lvc_tpu.data import meta_lvis as jlvis
from lvc_tpu.data.catalog import DatasetCatalog as JaxDatasetCatalog
from lvc_tpu.data.catalog import MetadataCatalog as JaxMetadataCatalog
from lvc_tpu.evaluation import lvis_evaluation as jeval
from lvc_tpu.modeling.roi_heads.fast_rcnn import Detections as JaxDetections

from lvc_tpu_torch.data import meta_lvis as tlvis
from lvc_tpu_torch.data.catalog import DatasetCatalog, MetadataCatalog
from lvc_tpu_torch.data.samplers import InferenceSampler
from lvc_tpu_torch.engine.launch import launch
from lvc_tpu_torch.evaluation import lvis_evaluation as teval
from lvc_tpu_torch.modeling.roi_heads.fast_rcnn import Detections
from lvc_tpu_torch.utils import comm

CATS = [3, 5, 8, 13, 21, 34, 55]  # LVIS category ids (sorted: contiguous = position)
N_IMAGES = 8


def _write_json(path, frequency: bool, seed=0):
    rng = np.random.RandomState(seed)
    images, anns = [], []
    for i in range(N_IMAGES):
        img_id = 100 + i
        present = sorted(rng.choice(CATS, rng.randint(1, 5), replace=False).tolist())
        absent = [c for c in CATS if c not in present]
        for c in present:
            for _ in range(rng.randint(1, 3)):
                x, y = rng.rand(2) * 60
                w, h = 8 + rng.rand(2) * 50
                anns.append({"id": len(anns) + 1, "image_id": img_id, "category_id": int(c),
                             "bbox": [float(x), float(y), float(w), float(h)], "area": float(w * h), "iscrowd": 0})
        images.append({"id": img_id, "file_name": f"img_{img_id}.jpg", "height": 100, "width": 120,
                       "neg_category_ids": [int(c) for c in absent[: len(absent) // 2]],
                       "not_exhaustive_category_ids": [int(present[0])]})
    cats = []
    for k, c in enumerate(CATS):
        cat = {"id": c, "name": f"name_{c}", "synonyms": [f"syn_{c}", f"other_{c}"]}
        if frequency:
            cat["frequency"] = "rcf"[k % 3]
        else:
            cat["image_count"] = (3, 40, 400)[k % 3]
        cats.append(cat)
    with open(path, "w") as f:
        json.dump({"images": images, "annotations": anns, "categories": cats}, f)
    return path


@pytest.fixture(scope="module", params=["frequency", "image_count"])
def lvis(request, tmp_path_factory):
    root = str(tmp_path_factory.mktemp("lvis"))
    path = _write_json(os.path.join(root, "lvis.json"), request.param == "frequency")
    name = f"lvis_probe_{request.param}"
    for catalog, register in ((DatasetCatalog, tlvis.register_meta_lvis), (JaxDatasetCatalog, jlvis.register_meta_lvis)):
        if name not in catalog:
            register(name, {}, path, os.path.join(root, "images"))
    return root, name


def _detections(records, seed=1):
    """Per image: the meta and seeded detections (jittered gt boxes and a few
    boxes of absent categories) in a canvas scaled by 0.5."""
    rng = np.random.RandomState(seed)
    out = []
    for d in records:
        meta = {"image_id": d["image_id"], "orig_size": np.array([100, 120]), "image_size": np.array([50, 60]),
                "padding": False}
        rows = []
        for a in d["annotations"]:
            x, y, w, h = a["bbox"]
            rows.append((np.array([x, y, x + w, y + h]) + rng.randn(4) * 3, a["category_id"]))
        rows += [(np.r_[xy, xy + 20], rng.randint(len(CATS))) for xy in rng.rand(3, 2) * 70]
        D = 12
        fields = [np.zeros((1, D, 4), np.float32), np.zeros((1, D), np.float32), np.zeros((1, D), np.int64),
                  np.zeros((1, D), bool)]
        for j, (b, c) in enumerate(rows[:D]):
            fields[0][0, j], fields[1][0, j], fields[2][0, j], fields[3][0, j] = b * 0.5, rng.rand(), c, True
        out.append((meta, fields))
    return out


def _port_eval(name, items, out_dir=None):
    ev = teval.LVISEvaluator(name, output_dir=out_dir)
    ev.reset()
    for meta, f in items:
        ev.process_detections(Detections(*[torch.from_numpy(x) for x in f], torch.zeros(f[2].shape, dtype=torch.long)),
                              [meta])
    return ev.evaluate()


def test_load_lvis_json_matches_jax(lvis):
    root, name = lvis
    got, want = DatasetCatalog.get(name), JaxDatasetCatalog.get(name)
    assert got == want and len(got) == N_IMAGES
    assert all(d["neg_category_ids"] is not None and d["not_exhaustive_category_ids"] for d in got)
    assert MetadataCatalog.get(name).as_dict() == JaxMetadataCatalog.get(name).as_dict()
    assert MetadataCatalog.get(name).thing_classes == [f"syn_{c}" for c in CATS]
    assert MetadataCatalog.get(name).evaluator_type == "lvis"


def test_lvis_evaluator_matches_jax(lvis, tmp_path):
    root, name = lvis
    items = _detections(DatasetCatalog.get(name))
    got = _port_eval(name, items, str(tmp_path / "port"))
    ev = jeval.LVISEvaluator(name, output_dir=str(tmp_path / "jax"))
    for meta, f in items:
        ev.process_detections(JaxDetections(*f, np.zeros(f[2].shape, np.int32)), [meta])
    want = ev.evaluate()
    assert list(got["bbox"]) == list(want["bbox"]) == ["AP", "AP50", "AP75", "APs", "APm", "APl", "APr", "APc", "APf"]
    for k, v in want["bbox"].items():
        assert got["bbox"][k] == pytest.approx(v, abs=1e-9, nan_ok=True), k
    assert want["bbox"]["AP50"] > 20
    rows = [json.load(open(tmp_path / d / "lvis_instances_results.json")) for d in ("port", "jax")]
    assert rows[0] == rows[1] and {r["category_id"] for r in rows[0]} <= set(CATS)


def test_lvis_ignore_rule_takes_effect(lvis):
    """The not-exhaustive and unlisted categories' unmatched detections are
    ignored: the plain COCOeval counts them as false positives."""
    root, name = lvis
    from lvc_tpu_torch.data.coco_api import COCO
    from lvc_tpu_torch.evaluation.coco_eval import COCOeval

    items = _detections(DatasetCatalog.get(name))
    ev = teval.LVISEvaluator(name)
    for meta, f in items:
        ev.process_detections(Detections(*[torch.from_numpy(x) for x in f], torch.zeros(f[2].shape, dtype=torch.long)),
                              [meta])
    rows = [dict(r, category_id=CATS[r["category_id"]]) for r in ev._predictions]
    api = COCO(MetadataCatalog.get(name).json_file)
    lvis_eval, coco_eval = teval.LVISEval(api, api.loadRes(rows)), COCOeval(api, api.loadRes(rows))
    coco_eval.params.maxDets = [300]
    for e in (lvis_eval, coco_eval):
        e.evaluate()
        e.accumulate()
    ignored = sum(int(np.asarray(e["dtIgnore"]).sum()) for e in lvis_eval.evalImgs.values() if e)
    plain = sum(int(np.asarray(e["dtIgnore"]).sum()) for e in coco_eval.evalImgs.values() if e)
    assert ignored > plain


def _rank_main(root, name, out):
    if name not in DatasetCatalog:
        tlvis.register_meta_lvis(name, {}, os.path.join(root, "lvis.json"), os.path.join(root, "images"))
    items = _detections(DatasetCatalog.get(name))
    shard = [items[i] for i in InferenceSampler(len(items), comm.get_rank(), comm.get_world_size())]
    torch.save(_port_eval(name, shard), os.path.join(out, f"lvis_rank{comm.get_rank()}.pt"))


def test_lvis_evaluator_merge_equals_one_process(lvis, tmp_path):
    root, name = lvis
    launch(_rank_main, 2, args=(root, name, str(tmp_path)), devices=["cpu", "cpu"])
    r0, r1 = (torch.load(os.path.join(tmp_path, f"lvis_rank{r}.pt"), weights_only=False) for r in range(2))
    assert r0 == _port_eval(name, _detections(DatasetCatalog.get(name))) and r1 == {}
