"""The box corrector's output file (the port's copy of
``lvc_tpu/evaluation/ubbr_saver.py``; lvc/evaluation/coco_evaluation.py
UBBRSaver:500-563, instances_to_coco_json_ubbr:606-642).

``UBBRSaver`` takes ``RegOnlyOutput`` batches and writes one row per valid
candidate to ``<dataset json path with .json -> _ubbr.json>``: the corrected
box (XYWH, in the original image's pixels) as ``bbox``, the candidate as
``bbox_orig``, the preserved annotation ``id`` and the dataset category id.
In a data-parallel run the main rank gathers every rank's rows (in rank
order) and writes the file alone; JAX's saver has no merge, as its one
process per host holds every row.
"""
from __future__ import annotations

import json
import logging
from collections import OrderedDict
from typing import List, Optional

import numpy as np

from lvc_tpu_torch.data.catalog import MetadataCatalog
from lvc_tpu_torch.utils import comm

logger = logging.getLogger(__name__)


class UBBRSaver:
    def __init__(self, dataset_name: str, cfg=None, output_dir: Optional[str] = None):
        self._dataset_name = dataset_name  # for DT_PATH sets this is the json path
        self._metadata = MetadataCatalog.get(dataset_name)
        self._results: List[dict] = []

    def reset(self):
        self._results = []

    def process_detections(self, out, metas: List[dict]):
        """out: ``RegOnlyOutput`` (boxes aligned to the candidate slots), on
        any device."""
        boxes = out.boxes.cpu().double().numpy()
        classes = out.classes.cpu().numpy()
        valid = out.valid.cpu().numpy()
        for i, meta in enumerate(metas):
            if meta.get("padding"):
                continue
            rh, rw = [int(x) for x in meta["image_size"]]
            oh, ow = [int(x) for x in meta["orig_size"]]
            sx, sy = ow / rw, oh / rh
            ids = np.asarray(meta["gt_ids"])
            orig = meta.get("gt_boxes_orig")
            for k in np.nonzero(valid[i])[0]:
                x0, y0, x1, y1 = boxes[i, k]
                x0, x1 = x0 * sx, x1 * sx
                y0, y1 = y0 * sy, y1 * sy
                row = {
                    "image_id": int(meta["image_id"]),
                    "category_id": int(classes[i, k]),
                    "bbox": [float(x0), float(y0), float(x1 - x0), float(y1 - y0)],
                    "id": int(ids[k]),
                }
                if orig is not None:
                    bx = np.asarray(orig[k], np.float64)
                    row["bbox_orig"] = [float(bx[0]), float(bx[1]), float(bx[2] - bx[0]), float(bx[3] - bx[1])]
                self._results.append(row)

    def evaluate(self) -> OrderedDict:
        results = list(self._results)
        if comm.get_world_size() > 1:
            shards = comm.gather_objects(results)
            if not comm.is_main_process():
                return OrderedDict()
            results = [r for shard in shards for r in shard]
        id_map = self._metadata.get("thing_dataset_id_to_contiguous_id")
        if id_map:
            reverse = {v: k for k, v in id_map.items()}
            for r in results:
                r["category_id"] = reverse.get(r["category_id"], r["category_id"])
        out_path = self._dataset_name.replace(".json", "_ubbr.json")
        with open(out_path, "w") as f:
            json.dump(results, f)
        logger.info("Saved %d corrected boxes to %s", len(results), out_path)
        return OrderedDict()
