"""Per-box crop datasets and loaders: a copy of ``lvc_tpu/data/crop.py``
(``load_coco_rpn_pkl``:31, ``register_rpn_coco``:62, ``DatasetMapperCrop``:70,
``MapDatasetCrop``:125, ``CropLoader``:145, ``ExemplarCropLoader``:176,
``build_crop_{shots,test,exem}_loader``:199-273).

The reference's proposal and shot crop pipeline (lvc/data/rpn_coco.py,
common_rpn.py, DatasetMapperCrop at dataset_mapper.py:419-567, build_rpn.py
and build_exem.py), as JAX keeps it: every crop is resized with PIL's
bilinear filter, keeping its aspect, into ONE zero-padded square canvas, so
batches stack into a fixed (B, S, S, 3) float32 array; the exemplar loader
appends one foreground shot per batch, drawn from its own
``RandomState(seed)``. Batches are numpy: a caller moves them to its device.
"""
from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional, Sequence

import numpy as np

from lvc_tpu_torch.data.catalog import DatasetCatalog, MetadataCatalog
from lvc_tpu_torch.data.dataset_mapper import read_image
from lvc_tpu_torch.structures.boxes import BoxMode


# --------------------------------------------------------------- datasets
def load_coco_rpn_pkl(pickle_file: str, image_root: str) -> List[dict]:
    """A pickled COCO-format dict (as written by RPNEvaluator) -> dataset
    dicts (rpn_coco.py:12-71). Annotation ids/iscrowd are preserved."""
    with open(pickle_file, "rb") as fp:
        dataset = pickle.load(fp)
    imgs = {img["id"]: img for img in dataset.get("images", [])}
    anns_by_img: Dict[int, list] = {i: [] for i in imgs}
    for ann in dataset.get("annotations", []):
        anns_by_img.setdefault(ann["image_id"], []).append(ann)

    out = []
    for img_id in sorted(imgs):
        img = imgs[img_id]
        objs = []
        for ann in anns_by_img.get(img_id, []):
            obj = {k: ann[k] for k in ("iscrowd", "bbox", "category_id", "id") if k in ann}
            obj["bbox_mode"] = BoxMode.XYWH_ABS
            objs.append(obj)
        out.append(
            {
                "file_name": os.path.join(image_root, img["file_name"]),
                "height": img["height"],
                "width": img["width"],
                "image_id": img_id,
                "annotations": objs,
            }
        )
    return out


def register_rpn_coco(name: str, metadata: dict, imgdir: str, annofile: str):
    DatasetCatalog.register(name, lambda: load_coco_rpn_pkl(annofile, imgdir))
    MetadataCatalog.get(name).set(
        json_file=annofile, image_root=imgdir, evaluator_type="coco", **metadata
    )


# ----------------------------------------------------------------- mapper
class DatasetMapperCrop:
    """Crop one box out of an image and emit a fixed-square example.

    ``ret_inst=True`` crops annotation ``ind`` (shot mode); otherwise crops
    ``proposal_boxes[ind]`` (proposal mode) — mirroring
    DatasetMapperCrop.__call__ (dataset_mapper.py:524-566). The crop is
    resized (keeping aspect) into a ``crop_size`` square with zero padding.
    """

    def __init__(self, cfg, is_train: bool = False, ret_inst: bool = False,
                 crop_size: int = 224):
        self.is_train = is_train
        self.ret_inst = ret_inst
        self.fmt = cfg.INPUT.FORMAT
        self.crop_size = crop_size

    def _to_canvas(self, crop: np.ndarray) -> np.ndarray:
        from PIL import Image

        h, w = crop.shape[:2]
        s = self.crop_size
        if h == 0 or w == 0:
            return np.zeros((s, s, 3), np.float32)
        scale = s / max(h, w)
        nh, nw = max(int(round(h * scale)), 1), max(int(round(w * scale)), 1)
        img = Image.fromarray(crop.astype(np.uint8)).resize((nw, nh), Image.BILINEAR)
        out = np.zeros((s, s, 3), np.float32)
        out[:nh, :nw] = np.asarray(img, np.float32)
        return out

    def __call__(self, dataset_dict: dict, ind: int) -> dict:
        d = dict(dataset_dict)
        image = read_image(d["file_name"], self.fmt)
        if self.ret_inst:
            ann = d["annotations"][ind]
            x1, y1, w, h = ann["bbox"]
            x1, y1, x2, y2 = int(x1), int(y1), int(x1 + w), int(y1 + h)
            crop = image[y1 : y2 + 1, x1 : x2 + 1]
            out = {
                "image": self._to_canvas(crop),
                "image_size": np.array([self.crop_size, self.crop_size], np.int32),
                "annotation": ann,
                "image_id": d.get("image_id", -1),
            }
        else:
            box = np.asarray(d["proposal_boxes"][ind])
            x1, y1, x2, y2 = box.astype(int)
            crop = image[y1 : y2 + 1, x1 : x2 + 1]
            out = {
                "image": self._to_canvas(crop),
                "image_size": np.array([self.crop_size, self.crop_size], np.int32),
                "proposal_box": box,
                "image_id": d.get("image_id", -1),
            }
        return out


class MapDatasetCrop:
    """Flat dataset over the (image, box) product: global index ->
    (image_idx via searchsorted on cumulative box counts, box_idx)
    (common_rpn.py:9-41)."""

    def __init__(self, dataset_dicts: List[dict], counts: Sequence[int], map_func):
        self._dataset = dataset_dicts
        self._cumsums = np.cumsum(np.asarray(counts, np.int64))
        self._map_func = map_func

    def __len__(self) -> int:
        return int(self._cumsums[-1]) if len(self._cumsums) else 0

    def __getitem__(self, idx: int) -> dict:
        img_idx = int(np.searchsorted(self._cumsums, idx, side="right"))
        box_idx = idx - (int(self._cumsums[img_idx - 1]) if img_idx else 0)
        return self._map_func(self._dataset[img_idx], box_idx)


# ---------------------------------------------------------------- loaders
class CropLoader:
    """Sequential fixed-shape batches over a MapDatasetCrop."""

    def __init__(self, dataset: MapDatasetCrop, batch_size: int):
        self.dataset = dataset
        self.batch_size = batch_size

    def __len__(self):
        return (len(self.dataset) + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        batch = []
        for i in range(len(self.dataset)):
            batch.append(self.dataset[i])
            if len(batch) == self.batch_size:
                yield self._collate(batch)
                batch = []
        if batch:
            yield self._collate(batch)

    @staticmethod
    def _collate(examples: List[dict]) -> dict:
        out = {
            "image": np.stack([e["image"] for e in examples]),
            "image_size": np.stack([e["image_size"] for e in examples]),
        }
        # mixed batches (exemplar loader) carry proposal crops + a shot:
        # missing keys become None per element
        for k in ("annotation", "proposal_box", "image_id"):
            if any(k in e for e in examples):
                out[k] = [e.get(k) for e in examples]
        return out


class ExemplarCropLoader(CropLoader):
    """Batches of proposal crops with ONE random foreground shot appended
    per batch (AspectRatioGroupedDatasetExem, build_exem.py:26-76). The
    aspect-ratio bucketing is dropped — static square canvases make it
    moot — but each batch still carries batch_size-1 proposals + 1 shot."""

    def __init__(self, dataset: MapDatasetCrop, shots: MapDatasetCrop,
                 batch_size: int, seed: int = 42):
        super().__init__(dataset, batch_size)
        self.shots = shots
        self._rng = np.random.RandomState(seed)

    def __iter__(self):
        batch = []
        for i in range(len(self.dataset)):
            batch.append(self.dataset[i])
            if len(batch) == self.batch_size - 1:
                j = int(self._rng.randint(len(self.shots)))
                batch.append(self.shots[j])
                yield self._collate(batch)
                batch = []


def build_crop_shots_loader(cfg, mapper: Optional[DatasetMapperCrop] = None):
    """Crops of the few-shot gt annotations (build_rpn.py:43-87)."""
    from lvc_tpu_torch.data.build import get_detection_dataset_dicts
    from lvc_tpu_torch.data.utils import filter_annotations

    dataset_dicts = get_detection_dataset_dicts(cfg.DATASETS.FS_TRAIN, filter_empty=True)
    dataset_dicts = filter_annotations(
        dataset_dicts,
        area_rng=tuple(cfg.DATALOADER.SHOTS.AREA_RNG),
        rel_area_rng=tuple(cfg.DATALOADER.SHOTS.REL_AREA_RNG),
        x_rng=tuple(cfg.DATALOADER.SHOTS.X_RNG),
        y_rng=tuple(cfg.DATALOADER.SHOTS.Y_RNG),
        check_longest_side_only=cfg.DATALOADER.SHOTS.LONGEST_SIDE_ONLY,
    )
    dataset_dicts = [d for d in dataset_dicts if d.get("annotations")]
    counts = [len(d["annotations"]) for d in dataset_dicts]
    mapper = mapper or DatasetMapperCrop(cfg, is_train=False, ret_inst=True)
    return CropLoader(
        MapDatasetCrop(dataset_dicts, counts, mapper), cfg.SOLVER.IMS_PER_BATCH
    )


def build_crop_test_loader(cfg, dataset_name: str,
                           mapper: Optional[DatasetMapperCrop] = None):
    """Crops of precomputed proposals (build_rpn.py:90-162): proposal pkl
    load -> geometric filters -> seen-class filter -> gt-overlap removal."""
    from lvc_tpu_torch.data.build import (
        get_detection_dataset_dicts,
        load_proposals_into_dataset,
    )
    from lvc_tpu_torch.data.utils import (
        filter_image_annotations,
        filter_proposal_boxes,
        remove_overlap_proposals,
    )

    dataset_dicts = get_detection_dataset_dicts([dataset_name], filter_empty=False)
    if cfg.MODEL.LOAD_PROPOSALS:
        idx = list(cfg.DATASETS.TEST).index(dataset_name)
        dataset_dicts = load_proposals_into_dataset(
            dataset_dicts, [cfg.DATASETS.PROPOSAL_FILES_TEST[idx]]
        )
    dataset_dicts = filter_proposal_boxes(
        dataset_dicts,
        area_rng=tuple(cfg.DATALOADER.PROPOSALS.AREA_RNG),
        rel_area_rng=tuple(cfg.DATALOADER.PROPOSALS.REL_AREA_RNG),
        x_rng=tuple(cfg.DATALOADER.PROPOSALS.X_RNG),
        y_rng=tuple(cfg.DATALOADER.PROPOSALS.Y_RNG),
        topk=cfg.DATALOADER.PROPOSALS.TOPK,
    )
    dataset_dicts = filter_image_annotations(
        dataset_dicts, dataset_name, cfg.DATASETS.UNSEEN_CLASSES, test=True
    )
    dataset_dicts = remove_overlap_proposals(
        dataset_dicts, cfg.DATALOADER.PROPOSALS.IOU_THRESH
    )
    dataset_dicts = [d for d in dataset_dicts if len(d.get("proposal_boxes", []))]
    counts = [len(d["proposal_boxes"]) for d in dataset_dicts]
    mapper = mapper or DatasetMapperCrop(cfg, is_train=False, ret_inst=False)
    return CropLoader(
        MapDatasetCrop(dataset_dicts, counts, mapper), cfg.SOLVER.IMS_PER_BATCH
    )


def build_crop_exem_loader(cfg, dataset_name: str):
    """Proposal crops + an injected random shot per batch (build_exem.py)."""
    proposals = build_crop_test_loader(cfg, dataset_name)
    shots = build_crop_shots_loader(cfg)
    return ExemplarCropLoader(
        proposals.dataset, shots.dataset, cfg.SOLVER.IMS_PER_BATCH
    )
