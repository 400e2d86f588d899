"""Dataset-dict utilities and the host-side plumbing of the verification CLI.

A copy of the parts of ``lvc_tpu/data/utils.py`` that the port's paths use,
kept so that the port never imports the JAX package: the training-set merge
of ``data/build.py::get_dataset_dicts_all`` (``remove_ignore_overlap``,
``filter_image_annotations``, ``combine_datasets``, ``unseen_sample``),
the crop loaders' filters (``filter_annotations``, ``filter_proposal_boxes``,
``remove_overlap_proposals``), result-JSON registration (``register_individual``, ``register_results``),
the DINO crop helpers (``get_padding``, ``get_crops_qe``), the seen-gt
overlap check (``iou_check_gt``) and the per-class precision report
(``iou_check``, ``print_precision_per_class``).
"""
from __future__ import annotations

import os
import random
from collections import defaultdict
from typing import Dict, List, Sequence

import numpy as np

from lvc_tpu_torch.data.builtin_meta import COCO_UNSEEN_IDS, _get_builtin_metadata
from lvc_tpu_torch.data.catalog import DatasetCatalog, MetadataCatalog
from lvc_tpu_torch.data.coco_api import COCO
from lvc_tpu_torch.data.meta_coco import load_coco_json
from lvc_tpu_torch.structures.boxes import BoxMode


def _iou_xyxy(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)))
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    union = area_a[:, None] + area_b[None, :] - inter
    return np.where(inter > 0, inter / np.maximum(union, 1e-12), 0.0)


def _anns_xyxy(annos: List[dict]) -> np.ndarray:
    boxes = np.array([a["bbox"] for a in annos], np.float64)
    mode = annos[0].get("bbox_mode", BoxMode.XYWH_ABS)
    return np.asarray(BoxMode.convert(boxes, mode, BoxMode.XYXY_ABS))


def remove_ignore_overlap(dataset_dicts: List[dict], thresh: float = 0.5) -> List[dict]:
    """Drop ignore_qe boxes overlapping a real annotation with IoU >= thresh
    (lvc utils.py:27-56)."""
    for d in dataset_dicts:
        annos_ig = [a for a in d["annotations"] if a.get("ignore_qe", 0)]
        if not annos_ig:
            continue
        annos_real = [a for a in d["annotations"] if not a.get("ignore_qe", 0)]
        if not annos_real:
            continue
        ious = _iou_xyxy(_anns_xyxy(annos_real), _anns_xyxy(annos_ig))
        keep = ious.max(axis=0) < thresh
        d["annotations"] = [a for a, k in zip(annos_ig, keep) if k] + annos_real
    return dataset_dicts


def filter_image_annotations(
    dataset_dicts: List[dict],
    dataset_name: str,
    drop_class_names: Sequence[str],
    test: bool = False,
) -> List[dict]:
    """Remove annotations of the given classes; drop images left empty
    (lvc utils.py:386-412)."""
    metadata = MetadataCatalog.get(dataset_name)
    class_names = metadata.thing_classes
    assert all(c in class_names for c in drop_class_names), "unknown class in filter"
    drop_ids = {class_names.index(c) for c in drop_class_names}
    for d in dataset_dicts:
        d["annotations"] = [a for a in d["annotations"] if a["category_id"] not in drop_ids]
    if not test:
        dataset_dicts = [d for d in dataset_dicts if len(d["annotations"])]
    return dataset_dicts


def combine_datasets(list_of_dataset_dicts: List[List[dict]]) -> List[dict]:
    """Merge per-image annotation lists keyed by image_id; the largest
    dataset is the base (lvc utils.py:415-437)."""
    indexed = []
    for dicts in list_of_dataset_dicts:
        m: Dict = {}
        for d in dicts:
            if d["image_id"] in m:
                m[d["image_id"]]["annotations"].extend(d["annotations"])
            else:
                m[d["image_id"]] = d
        indexed.append(m)
    base = indexed.pop(int(np.argmax([len(m) for m in indexed])))
    for rest in indexed:
        for img_id, d in rest.items():
            if img_id in base:
                base[img_id]["annotations"].extend(d["annotations"])
            else:
                base[img_id] = d
    return list(base.values())


def filter_annotations(
    dataset_dicts: List[dict],
    area_rng=(0.0, 1.0e10),
    rel_area_rng=(0.0, 1.0),
    x_rng=(0.0, 1.0e10),
    y_rng=(0.0, 1.0e10),
    check_longest_side_only: bool = True,
) -> List[dict]:
    """Area/side-range annotation filter (lvc utils.py:86-130)."""
    for d in dataset_dicts:
        annos = d["annotations"]
        if not annos:
            continue
        boxes = _anns_xyxy(annos)
        areas = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
        rel = areas / (d["width"] * d["height"])
        ws = boxes[:, 2] - boxes[:, 0]
        hs = boxes[:, 3] - boxes[:, 1]
        ok = (areas > area_rng[0]) & (areas <= area_rng[1])
        ok &= (rel > rel_area_rng[0]) & (rel <= rel_area_rng[1])
        if check_longest_side_only:
            longest = np.maximum(ws, hs)
            ok &= (longest > x_rng[0]) & (longest <= x_rng[1])
        else:
            ok &= (ws > x_rng[0]) & (ws <= x_rng[1])
            ok &= (hs > y_rng[0]) & (hs <= y_rng[1])
        d["annotations"] = [a for a, k in zip(annos, ok) if k]
    return dataset_dicts


def filter_proposal_boxes(
    dataset_dicts: List[dict],
    area_rng=(0.0, 1.0e10),
    rel_area_rng=(0.0, 2.0),
    x_rng=(0.0, 1.0e10),
    y_rng=(0.0, 1.0e10),
    topk: int = int(1e10),
) -> List[dict]:
    """Geometric filter on loaded proposals (lvc utils.py:59-83): keep the
    first ``topk`` per image, then gate by absolute/relative area and
    width/height ranges."""
    for d in dataset_dicts:
        boxes = np.asarray(d.get("proposal_boxes", np.zeros((0, 4), np.float32)))
        logits = np.asarray(d.get("proposal_objectness_logits", np.zeros((0,), np.float32)))
        if not len(boxes):
            continue
        areas = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
        rel = areas / float(d["height"] * d["width"])
        ws = boxes[:, 2] - boxes[:, 0]
        hs = boxes[:, 3] - boxes[:, 1]
        keep = (areas > area_rng[0]) & (areas <= area_rng[1])
        keep &= (rel > rel_area_rng[0]) & (rel <= rel_area_rng[1])
        keep &= (ws > x_rng[0]) & (ws <= x_rng[1])
        keep &= (hs > y_rng[0]) & (hs <= y_rng[1])
        d["proposal_boxes"] = boxes[:topk][keep[:topk]]
        d["proposal_objectness_logits"] = logits[:topk][keep[:topk]]
    return dataset_dicts


def remove_overlap_proposals(dataset_dicts: List[dict], iou_thresh: float) -> List[dict]:
    """Drop proposals overlapping any gt annotation at IoU >= thresh
    (lvc utils.py:125-143)."""
    for d in dataset_dicts:
        annos = d.get("annotations", [])
        boxes = np.asarray(d.get("proposal_boxes", np.zeros((0, 4), np.float32)))
        if not (len(annos) and len(boxes)):
            continue
        gt = _anns_xyxy(annos)
        ious = _iou_xyxy(gt, boxes)
        keep = ious.max(axis=0) < iou_thresh
        d["proposal_boxes"] = boxes[keep]
        d["proposal_objectness_logits"] = np.asarray(
            d["proposal_objectness_logits"]
        )[keep]
    return dataset_dicts


def unseen_sample(dataset_dicts: List[dict]) -> List[dict]:
    """Balanced subsetting: cap each category's image count at the largest
    unseen-class count (lvc utils.py:281-308)."""
    rng = random.Random(20000)
    cat2imgs = defaultdict(list)
    for i, d in enumerate(dataset_dicts):
        cat_ids, counts = np.unique(
            [a["category_id"] for a in d["annotations"]], return_counts=True
        )
        for cid, cnt in zip(cat_ids, counts):
            cat2imgs[cid].append([i, cnt])
    samp_num = max(len(v) for k, v in cat2imgs.items() if k in COCO_UNSEEN_IDS)
    keep_ids = []
    for k, v in cat2imgs.items():
        if len(v) <= samp_num:
            keep_ids.extend([x[0] for x in v])
        else:
            inds = rng.sample(v, len(v))
            tot = 0
            for iid, cnt in inds:
                tot += cnt
                if tot > samp_num:
                    break
                keep_ids.append(iid)
    keep_ids = sorted(set(keep_ids))
    return [dataset_dicts[i] for i in keep_ids]


# ---------------------------------------------------------------- register
def register_individual(name: str, metadata: dict, imgdir: str, annofile: str):
    """Register a result JSON as a dataset keyed by its file path
    (lvc utils.py:195-215). Extra keys id/score/ignore_qe/ignore_reg ride
    along into annotations."""
    if "unlabeled" in os.path.basename(annofile):
        _root = os.getenv("DETECTRON2_DATASETS", "datasets")
        imgdir = os.path.join(_root, "coco/unlabeled2017/")
    DatasetCatalog.register(
        annofile,
        lambda: load_coco_json(
            annofile,
            imgdir,
            metadata,
            name,
            extra_annotation_keys=["id", "score", "ignore_qe", "ignore_reg"],
        ),
    )
    MetadataCatalog.get(annofile).set(
        json_file=annofile, image_root=imgdir, evaluator_type="coco", **metadata
    )


def register_results(cfg):
    """Register every DT_PATH (and NN_DSET) result JSON (lvc utils.py:146)."""
    metadata = _get_builtin_metadata("coco_fewshot")
    idx = -1
    for idx, results_file in enumerate(cfg.DATASETS.DT_PATH):
        if not os.path.isfile(results_file):
            continue
        image_root = MetadataCatalog.get(cfg.DATASETS.TRAIN[0]).image_root
        if results_file in DatasetCatalog:
            DatasetCatalog.remove(results_file)
        register_individual(
            f"query_expand{str(idx).zfill(3)}", metadata, image_root, results_file
        )
    for jdx, results_file in enumerate(cfg.QUERY_EXPAND.NN_DSET, start=idx + 1):
        if not os.path.isfile(results_file):
            continue
        image_root = MetadataCatalog.get(cfg.DATASETS.TRAIN[0]).image_root
        if results_file in DatasetCatalog:
            DatasetCatalog.remove(results_file)
        register_individual(
            f"query_expand{str(jdx).zfill(3)}", metadata, image_root, results_file
        )


# -------------------------------------------------------- crop helpers (QE)
def get_padding(box: np.ndarray, pk: float = 0.2) -> np.ndarray:
    """Square, context-padded crop window around a box
    (lvc utils.py:440-500 semantics): pad each side by pk * max_side, then
    expand the short side to square."""
    x0, y0, x1, y1 = box
    w, h = x1 - x0, y1 - y0
    side = max(w, h) * (1 + 2 * pk)
    cx, cy = (x0 + x1) / 2, (y0 + y1) / 2
    return np.array([cx - side / 2, cy - side / 2, cx + side / 2, cy + side / 2])


def get_crops_qe(
    image: np.ndarray, boxes: np.ndarray, crop_size: int = 224, pk: float = 0.2
) -> np.ndarray:
    """Cut square context-padded crops resized to crop_size^2 for the kNN
    verifier (lvc utils.py:440-519; DatasetMapperQE get_crops path)."""
    from PIL import Image

    crops = []
    h, w = image.shape[:2]
    for box in boxes:
        win = get_padding(np.asarray(box, np.float64), pk)
        x0, y0, x1, y1 = win
        # pad image virtually with zeros where the window exceeds bounds
        side = max(int(round(x1 - x0)), 1)
        canvas = np.zeros((side, side, image.shape[2]), image.dtype)
        # integer window anchored at one rounded origin; using round(x1)/
        # round(y1) independently can disagree with ``side`` by 1 px
        ix0, iy0 = int(round(x0)), int(round(y0))
        sx0, sy0 = max(0, ix0), max(0, iy0)
        sx1, sy1 = min(w, ix0 + side), min(h, iy0 + side)
        dx0, dy0 = sx0 - ix0, sy0 - iy0
        patch = image[sy0:sy1, sx0:sx1]
        canvas[dy0 : dy0 + patch.shape[0], dx0 : dx0 + patch.shape[1]] = patch
        pil = Image.fromarray(canvas).resize((crop_size, crop_size), Image.BILINEAR)
        crops.append(np.asarray(pil))
    if crops:
        return np.stack(crops)
    return np.zeros((0, crop_size, crop_size, image.shape[2]), image.dtype)


# ------------------------------------------------------- precision reports
def iou_check(dt_id: int, coco_dt: COCO, coco_gt: COCO, thresh: float = 0.5) -> int:
    """1 if the detection overlaps same-class gt above thresh, 0 otherwise,
    -1 for ignore_qe entries (lvc utils.py:555-580)."""
    ann = coco_dt.loadAnns(dt_id)[0]
    if ann.get("ignore_qe"):
        return -1
    anns_gt = coco_gt.loadAnns(
        coco_gt.getAnnIds(imgIds=ann["image_id"], catIds=ann["category_id"], iscrowd=False)
    )
    if not anns_gt:
        return 0
    dt = _anns_xyxy([ann])
    gt = _anns_xyxy(anns_gt)
    return 1 if _iou_xyxy(dt, gt).max() > thresh else 0


def iou_check_gt(dt_id: int, coco_dt: COCO, coco_gt: COCO, gt_cids, thresh: float = 0.5) -> int:
    """1 if the detection overlaps ANY gt of the given classes
    (lvc utils.py:535-553; used to drop candidates on seen-class objects)."""
    ann = coco_dt.loadAnns(dt_id)[0]
    anns_gt = coco_gt.loadAnns(coco_gt.getAnnIds(imgIds=ann["image_id"], catIds=gt_cids))
    if not anns_gt:
        return 0
    dt = _anns_xyxy([ann])
    gt = _anns_xyxy(anns_gt)
    return 1 if _iou_xyxy(dt, gt).max() > thresh else 0


def print_precision_per_class(filename_dt, filename_gt, iou_thresh: float = 0.5):
    """Per-class precision table of a result JSON vs gt
    (lvc utils.py:593-612). Returns [(name, n, precision)]."""
    coco_gt = filename_gt if isinstance(filename_gt, COCO) else COCO(filename_gt)
    coco_dt = filename_dt if isinstance(filename_dt, COCO) else COCO(filename_dt)
    precisions = defaultdict(list)
    for dt_id in coco_dt.getAnnIds():
        cid = coco_dt.loadAnns(dt_id)[0]["category_id"]
        precisions[cid].append(iou_check(dt_id, coco_dt, coco_gt, thresh=iou_thresh))
    table = []
    for cid in sorted(precisions):
        vals = np.array(precisions[cid])
        vals = vals[vals != -1]
        name = coco_gt.cats[cid]["name"] if cid in coco_gt.cats else str(cid)
        mean = float(vals.mean()) if len(vals) else float("nan")
        table.append((name, len(vals), mean))
        print(f"{name:>16s}  n={len(vals):5d}  precision={mean:.4f}")
    return table
