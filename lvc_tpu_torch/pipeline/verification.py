"""Label verification: descriptor extraction and kNN confirmation.

Counterpart of ``lvc_tpu/pipeline/verification.py``: cut square
context-padded crops per candidate box (``get_crops_qe``), embed them with the
DINO ViT (CLS token), vote over the k most similar shots, and keep the
candidates whose detector label equals the vote. The ViT's attention is the
Hopper flash-attention kernel on the card (``ops/attention.py``).
"""
from __future__ import annotations

import functools
import logging
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional

import numpy as np
import torch

from lvc_tpu_torch.data.catalog import DatasetCatalog
from lvc_tpu_torch.data.dataset_mapper import read_image
from lvc_tpu_torch.data.utils import get_crops_qe
from lvc_tpu_torch.modeling.backbone.vit import (
    VisionTransformer,
    dino_vits8,
    dino_vits16,
    load_dino_state_dict,
    random_init,
)
from lvc_tpu_torch.modeling.meta_arch.build import resolve_device
from lvc_tpu_torch.ops.knn import knn_vote, sharded_knn_vote
from lvc_tpu_torch.structures.boxes import BoxMode

logger = logging.getLogger(__name__)


def build_dino(
    name: str = "dino_vits8",
    weights_path: Optional[str] = None,
    device=None,
    compute_dtype: torch.dtype = torch.float32,
) -> VisionTransformer:
    """The verifier ViT in eval mode on ``device`` (default ``cuda``; raises
    without a GPU unless asked for the CPU). DINO torch weights come from the
    first file found among ``weights_path``, ``$DINO_WEIGHTS`` and
    ``checkpoints/<name>.pth``; with none it warns and uses a seeded random
    init."""
    device = resolve_device(device)
    model = {"dino_vits8": dino_vits8, "dino_vits16": dino_vits16}[name](compute_dtype)
    candidates = [
        weights_path,
        os.environ.get("DINO_WEIGHTS"),
        os.path.join("checkpoints", f"{name}.pth"),
    ]
    path = next((c for c in candidates if c and os.path.isfile(c)), None)
    if path:
        sd = torch.load(path, map_location="cpu", weights_only=False)
        if isinstance(sd, dict) and "state_dict" in sd:
            sd = sd["state_dict"]
        load_dino_state_dict(model, sd)
        logger.info("Loaded DINO weights from %s", path)
    else:
        logger.warning(
            "No DINO weights found (looked at %s); using RANDOM init — "
            "verification quality will be meaningless until weights are provided",
            candidates,
        )
        random_init(model, seed=0)
    return model.to(device).eval()


class DescriptorExtractor:
    """Batched crop embedding: host normalisation in float32 numpy, each
    chunk padded to ``batch`` crops (one shape per forward), the ViT on its
    device."""

    def __init__(self, model: VisionTransformer, pixel_mean, pixel_std, batch: int = 64, crop_size: int = 224):
        self.model = model
        self.device = next(model.parameters()).device
        self.mean = np.asarray(pixel_mean, np.float32)
        self.std = np.asarray(pixel_std, np.float32)
        self.batch = batch
        self.crop_size = crop_size

    @torch.inference_mode()
    def embed_crops(self, crops: np.ndarray) -> np.ndarray:
        """(N, S, S, 3) uint8 RGB -> (N, D) float32."""
        n = len(crops)
        if n == 0:
            return np.zeros((0, self.model.embed_dim), np.float32)
        out = []
        for i in range(0, n, self.batch):
            chunk = crops[i : i + self.batch]
            pad = self.batch - len(chunk)
            x = (chunk.astype(np.float32) - self.mean) / self.std
            if pad:
                x = np.concatenate([x, np.zeros((pad,) + x.shape[1:], np.float32)])
            feats = self.model(torch.from_numpy(x).to(self.device)).float().cpu().numpy()
            out.append(feats[: len(chunk)])
        return np.concatenate(out, axis=0)

    def extract_dataset(self, dataset_name: str, num_workers: int = 8, pk: float = 0.2):
        """-> dict with descriptors (N, D), classes (N,), ids (N,),
        boxes (N, 4 xyxy), image_ids (N,)."""
        dicts = DatasetCatalog.get(dataset_name)

        def load(d):
            img = read_image(d["file_name"], "RGB")
            boxes, classes, ids = [], [], []
            for a in d["annotations"]:
                # crowd regions are never verification queries (reference
                # lvc/data/dataset_mapper.py:379-393)
                if a.get("iscrowd", 0):
                    continue
                b = a["bbox"]
                if a.get("bbox_mode", BoxMode.XYWH_ABS) == BoxMode.XYWH_ABS:
                    b = [b[0], b[1], b[0] + b[2], b[1] + b[3]]
                boxes.append(b)
                classes.append(a["category_id"])
                ids.append(a.get("id", -1))
            boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
            crops = get_crops_qe(img, boxes, crop_size=self.crop_size, pk=pk)
            return d["image_id"], crops, np.asarray(classes), np.asarray(ids), boxes

        all_desc, all_cls, all_ids, all_boxes, all_img = [], [], [], [], []
        with ThreadPoolExecutor(num_workers) as pool:
            for image_id, crops, classes, ids, boxes in pool.map(load, dicts):
                if len(crops) == 0:
                    continue
                desc = self.embed_crops(crops)
                all_desc.append(desc)
                all_cls.append(classes)
                all_ids.append(ids)
                all_boxes.append(boxes)
                all_img.append(np.full(len(desc), image_id, dtype=np.int64))
        if not all_desc:
            return {
                "descriptors": np.zeros((0, self.model.embed_dim), np.float32),
                "classes": np.zeros((0,), np.int64),
                "ids": np.zeros((0,), np.int64),
                "boxes": np.zeros((0, 4), np.float32),
                "image_ids": np.zeros((0,), np.int64),
            }
        return {
            "descriptors": np.concatenate(all_desc),
            "classes": np.concatenate(all_cls),
            "ids": np.concatenate(all_ids),
            "boxes": np.concatenate(all_boxes),
            "image_ids": np.concatenate(all_img),
        }


def verify_candidates(
    shots: Dict[str, np.ndarray],
    queries: Dict[str, np.ndarray],
    k: int = 10,
    cosine: bool = True,
    device=None,
    group=None,
) -> np.ndarray:
    """Keep mask over queries: detector label == mode of the k nearest shot
    labels (get_nn_class_confirmatory, run_nearest_neighbours.py:214-227),
    on one device (default ``cuda``). With a process ``group``, every rank
    of which passes the same shots and queries, the vote is
    ``sharded_knn_vote`` over it (JAX's ``mesh=``, :145-175)."""
    device = resolve_device(device)
    num_classes = int(max(shots["classes"].max(initial=0), queries["classes"].max(initial=0))) + 1
    vote = knn_vote if group is None else functools.partial(sharded_knn_vote, group=group)
    _, mode = vote(
        torch.from_numpy(np.asarray(shots["descriptors"], np.float32)).to(device),
        torch.from_numpy(shots["classes"].astype(np.int64)).to(device),
        torch.from_numpy(np.asarray(queries["descriptors"], np.float32)).to(device),
        k=k,
        cosine=cosine,
        num_classes=num_classes,
    )
    return mode.cpu().numpy() == queries["classes"]
