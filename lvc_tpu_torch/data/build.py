"""Train/test data loader construction (the port's copy of
``lvc_tpu/data/build.py``).

Counterpart of lvc/data/build.py (get_dataset_dicts_all:106-162,
build_detection_train_loader:165, build_detection_test_loader:296) and
d2's build_batch_data_loader. Examples are padded fixed-shape numpy arrays
bucketed by canvas; a thread pool decodes/augments ahead of the train step
(no worker processes: the heavy lifting is the native decoder, PIL and
numpy, which release the GIL), and the train loader assembles its batches
on a thread of its own. The loaders yield numpy arrays; the trainer moves
each batch to its device. ``INPUT.MOSAIC > 0`` wraps the default
train mapper in ``MosaicDatasetMapper`` (``lvc_tpu/data/build.py:241-250``).

In a data-parallel run each rank builds its own loaders from its ``rank``
and the ``world_size`` (``lvc_tpu/data/build.py:237-266``): the train
sampler strides the index stream by rank, the batch is the rank's share
``IMS_PER_BATCH // world_size`` and the mapper's seed is ``SEED + rank``;
the test loader's ``InferenceSampler`` gives each rank a contiguous shard.
"""
from __future__ import annotations

import itertools
import pickle
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from lvc_tpu_torch.data import utils as data_utils
from lvc_tpu_torch.data.catalog import DatasetCatalog
from lvc_tpu_torch.data.dataset_mapper import MODEL_KEYS, DatasetMapper, collate
from lvc_tpu_torch.data.mosaic import MosaicDatasetMapper
from lvc_tpu_torch.data.samplers import (
    CategoryAreaAwareSampler,
    CategoryAwareSampler,
    InferenceSampler,
    RepeatFactorTrainingSampler,
    TrainingSampler,
)
from lvc_tpu_torch.structures.boxes import BoxMode
from lvc_tpu_torch.utils.tracing import count, span

# finished train batches the assembler may hold ahead of the consumer
_READY_DEPTH = 2
# seconds a closing train loader waits for its assembler to stop
_JOIN_S = 10.0


def get_detection_dataset_dicts(names, filter_empty: bool = True) -> List[dict]:
    if isinstance(names, str):
        names = [names]
    assert len(names)
    dicts = [DatasetCatalog.get(n) for n in names]
    dataset_dicts = list(itertools.chain.from_iterable(dicts))
    if filter_empty:
        dataset_dicts = [d for d in dataset_dicts if len(d.get("annotations", []))]
    return dataset_dicts


def load_proposals_into_dataset(dataset_dicts: List[dict], proposal_files) -> List[dict]:
    """Attach precomputed proposals from RPNEvaluator pickles
    (lvc build.py:49-103)."""
    if isinstance(proposal_files, str):
        proposal_files = [proposal_files]
    proposals: Dict = {"ids": [], "boxes": [], "objectness_logits": []}
    for f in proposal_files:
        with open(f, "rb") as fp:
            p = pickle.load(fp)
        for k in proposals:
            proposals[k].extend(p[k])
    id_to_idx = {int(i): n for n, i in enumerate(proposals["ids"])}
    out = []
    for d in dataset_dicts:
        idx = id_to_idx.get(int(d["image_id"]))
        if idx is None:
            continue
        boxes = np.asarray(proposals["boxes"][idx]).reshape(-1, 4)
        logits = np.asarray(proposals["objectness_logits"][idx]).reshape(-1)
        inds = np.argsort(-logits, kind="stable")
        d = dict(d)
        d["proposal_boxes"] = boxes[inds]
        d["proposal_objectness_logits"] = logits[inds]
        d["proposal_bbox_mode"] = BoxMode.XYXY_ABS
        out.append(d)
    return out


def get_dataset_dicts_all(cfg) -> List[dict]:
    """The LVC training-set merge (lvc build.py:106-162): base set filtered
    of unseen classes + few-shot set filtered of seen classes + optional
    pseudo-annotation sets, with ignore-overlap removal."""
    dataset_dicts = get_detection_dataset_dicts(
        cfg.DATASETS.TRAIN, filter_empty=cfg.DATALOADER.FILTER_EMPTY_ANNOTATIONS
    )
    if "all" in cfg.DATASETS.TRAIN[0]:
        dataset_dicts = data_utils.filter_image_annotations(
            dataset_dicts, cfg.DATASETS.TRAIN[0], cfg.DATASETS.UNSEEN_CLASSES
        )
        fs_dataset_dicts = get_detection_dataset_dicts(
            cfg.DATASETS.FS_TRAIN, filter_empty=cfg.DATALOADER.FILTER_EMPTY_ANNOTATIONS
        )
        fs_dataset_dicts = data_utils.filter_image_annotations(
            fs_dataset_dicts, cfg.DATASETS.FS_TRAIN[0], cfg.DATASETS.SEEN_CLASSES
        )
        dataset_dicts_new = data_utils.combine_datasets([fs_dataset_dicts, dataset_dicts])
    else:
        dataset_dicts_new = data_utils.combine_datasets([dataset_dicts])
    if cfg.QUERY_EXPAND.ENABLED:
        dataset_dicts_det = get_detection_dataset_dicts(
            cfg.DATASETS.DT_PATH, filter_empty=cfg.DATALOADER.FILTER_EMPTY_ANNOTATIONS
        )
        dataset_dicts_new = data_utils.combine_datasets([dataset_dicts_new, dataset_dicts_det])
        dataset_dicts_new = data_utils.remove_ignore_overlap(dataset_dicts_new)
    if cfg.DATASETS.SUBSET:
        dataset_dicts_new = data_utils.unseen_sample(dataset_dicts_new)
    if cfg.MODEL.LOAD_PROPOSALS:
        dataset_dicts_new = load_proposals_into_dataset(
            dataset_dicts_new, list(cfg.DATASETS.PROPOSAL_FILES_TRAIN)
        )
    return dataset_dicts_new


def _build_sampler(cfg, dataset_dicts, rank: int = 0, world_size: int = 1):
    name = cfg.DATALOADER.SAMPLER_TRAIN
    shard = dict(seed=max(cfg.SEED, 0), rank=rank, world_size=world_size)
    if name == "TrainingSampler":
        return TrainingSampler(len(dataset_dicts), **shard)
    if name == "RepeatFactorTrainingSampler":
        return RepeatFactorTrainingSampler(dataset_dicts, cfg.DATALOADER.REPEAT_THRESHOLD, **shard)
    if name == "CategoryAwareSampler":
        return CategoryAwareSampler(dataset_dicts, **shard)
    if name == "CategoryAreaAwareSampler":
        return CategoryAreaAwareSampler(dataset_dicts, **shard)
    raise ValueError(f"Unknown sampler: {name}")


def _bounded_map(fn, iterable, pool: ThreadPoolExecutor, prefetch: int):
    """In-order map with a bounded number of in-flight tasks (plain
    Executor.map would eagerly consume an infinite iterator). The wait for
    each result is the span ``loader.wait``: the consumer starved by the
    workers."""
    from collections import deque

    it = iter(iterable)
    inflight = deque()
    try:
        for _ in range(prefetch):
            inflight.append(pool.submit(fn, next(it)))
    except StopIteration:
        it = None
    while inflight:
        with span("loader.wait", device=False):
            out = inflight.popleft().result()
        if it is not None:
            try:
                inflight.append(pool.submit(fn, next(it)))
            except StopIteration:
                it = None
        yield out


def _collate_into(examples: List[Dict[str, np.ndarray]], pinned: bool) -> Dict[str, np.ndarray]:
    """``collate(examples, train=True)``, its images copied into a fresh
    array. ``pinned``: a view of a page-locked block of torch's caching host
    allocator, which takes the block back for reuse once nothing refers to
    the array, so the copy to the card goes by DMA with no staging copy and
    no page is faulted in anew."""
    first = examples[0]["image"]
    shape = (len(examples),) + first.shape
    if pinned:
        block = torch.empty(len(examples) * first.nbytes, dtype=torch.uint8, pin_memory=True)
        image = block.numpy().view(first.dtype).reshape(shape)
    else:
        image = np.empty(shape, first.dtype)
    for i, e in enumerate(examples):
        image[i] = e["image"]
    batch = {"image": image}
    batch.update((k, np.stack([e[k] for e in examples])) for k in MODEL_KEYS)
    return batch


class TrainLoader:
    """Iterator of collated train batches, bucketed by canvas, as long as
    the sampler (the training samplers are infinite).

    A thread pool maps dataset dicts ahead; batches are formed from
    examples sharing a canvas bucket (the fixed-shape analogue of
    AspectRatioGroupedDataset, d2 common.py:115). An assembler thread
    consumes the mapped examples in order, collates each full bucket (the
    span ``loader.collate``) into a fresh image array, page-locked where
    CUDA is present, and queues up to ``_READY_DEPTH`` finished batches.
    The iterating thread takes them (the span ``loader.take``, with the
    counter ``loader.ready`` when a batch was already waiting); a worker's
    or the assembler's exception is raised from its ``next()``. Closing
    the iterator (or collecting it) stops the assembler and the pool."""

    def __init__(self, dataset_dicts, mapper: DatasetMapper, batch_size: int, num_workers: int = 4, sampler=None):
        self.dataset_dicts = dataset_dicts
        self.mapper = mapper
        self.batch_size = batch_size
        self.sampler = sampler or TrainingSampler(len(dataset_dicts))
        self.num_workers = max(1, num_workers)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        pool = ThreadPoolExecutor(self.num_workers)
        ready: queue.Queue = queue.Queue(_READY_DEPTH)
        stop = threading.Event()
        assembler = threading.Thread(target=self._assemble, args=(pool, ready, stop, torch.cuda.is_available()),
                                     name="TrainLoader-assembler", daemon=True)
        assembler.start()
        try:
            while True:
                with span("loader.take", device=False):
                    try:
                        item = ready.get_nowait()
                        count("loader.ready")
                    except queue.Empty:
                        item = ready.get()
                if item is None:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            try:  # wakes an assembler blocked on the full queue
                while True:
                    ready.get_nowait()
            except queue.Empty:
                pass
            assembler.join(_JOIN_S)
            pool.shutdown(wait=False, cancel_futures=True)

    def _assemble(self, pool: ThreadPoolExecutor, ready: queue.Queue, stop: threading.Event, pinned: bool) -> None:
        """The assembler thread: queues each finished batch, then None where
        the sampler ends, or the exception that stopped it; returns once
        ``stop`` is set."""
        try:
            examples = _bounded_map(self.mapper, (self.dataset_dicts[i] for i in self.sampler), pool,
                                    prefetch=4 * self.num_workers)
            buckets: Dict[Tuple[int, int], List] = {}
            for ex in examples:
                if stop.is_set():
                    return
                b = buckets.setdefault(ex["canvas"], [])
                b.append(ex)
                if len(b) == self.batch_size:
                    with span("loader.collate", device=False):
                        batch = _collate_into(b, pinned)
                    buckets[ex["canvas"]] = []
                    ready.put(batch)
            ready.put(None)
        except Exception as e:  # raised again on the iterating thread
            ready.put(e)


class EvalLoader:
    """Finite iterator over (batch, metadata list). The final partial batch
    is padded by repeating the last example; metadata marks padding."""

    def __init__(self, dataset_dicts, mapper: DatasetMapper, batch_size: int = 1, num_workers: int = 4,
                 rank: int = 0, world_size: int = 1, with_gt: bool = False):
        self.dataset_dicts = dataset_dicts
        self.mapper = mapper
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        self.sampler = InferenceSampler(len(dataset_dicts), rank, world_size)
        self.with_gt = with_gt

    def __len__(self):
        return len(self.sampler)

    def __iter__(self):
        idxs = list(self.sampler)
        with ThreadPoolExecutor(self.num_workers) as pool:
            examples = _bounded_map(
                self.mapper,
                (self.dataset_dicts[i] for i in idxs),
                pool,
                prefetch=4 * self.num_workers,
            )
            buckets: Dict[Tuple[int, int], List] = {}
            for ex in examples:
                b = buckets.setdefault(ex["canvas"], [])
                b.append(ex)
                if len(b) == self.batch_size:
                    yield self._emit(b)
                    buckets[ex["canvas"]] = []
        for b in buckets.values():
            if b:
                yield self._emit(b, pad=True)

    def _emit(self, exs, pad: bool = False):
        metas = [
            {
                "image_id": e["image_id"],
                "orig_size": e["orig_size"],
                "image_size": e["image_size"],
                "gt_ids": e["gt_ids"],
                "gt_scores": e["gt_scores"],
                "gt_boxes_orig": e["gt_boxes_orig"],
                "padding": False,
            }
            for e in exs
        ]
        if pad and len(exs) < self.batch_size:
            n_pad = self.batch_size - len(exs)
            exs = exs + [exs[-1]] * n_pad
            metas = metas + [dict(metas[-1], padding=True) for _ in range(n_pad)]
        return collate(exs, train=False, with_gt=self.with_gt), metas


def build_detection_train_loader(cfg, mapper: Optional[DatasetMapper] = None,
                                 rank: int = 0, world_size: int = 1) -> TrainLoader:
    """The loader of rank ``rank``: batches of ``IMS_PER_BATCH // world_size``
    (it raises when that does not divide). A given ``mapper`` keeps its own
    seed."""
    if cfg.SOLVER.IMS_PER_BATCH % world_size:
        raise ValueError(
            f"SOLVER.IMS_PER_BATCH {cfg.SOLVER.IMS_PER_BATCH} does not divide over {world_size} ranks"
        )
    dataset_dicts = get_dataset_dicts_all(cfg)
    if mapper is None:
        mapper = DatasetMapper(cfg, is_train=True, seed=max(cfg.SEED, 0) + rank)
        if cfg.INPUT.MOSAIC > 0:
            # the mosaic loader switch (lvc defaults.py:518-520 / mosaic.py:130)
            mapper = MosaicDatasetMapper(
                mapper, dataset_dicts, cfg.INPUT.MOSAIC, cfg.INPUT.MOSAIC49SPLIT, seed=max(cfg.SEED, 0) + rank
            )
    return TrainLoader(
        dataset_dicts, mapper, cfg.SOLVER.IMS_PER_BATCH // world_size, cfg.DATALOADER.NUM_WORKERS,
        _build_sampler(cfg, dataset_dicts, rank, world_size),
    )


def build_detection_test_loader(cfg, dataset_name: str, mapper: Optional[DatasetMapper] = None,
                                batch_size: int = 1, rank: int = 0, world_size: int = 1,
                                with_gt: bool = False) -> EvalLoader:
    """The loader of rank ``rank``'s contiguous shard of ``dataset_name``."""
    dataset_dicts = get_detection_dataset_dicts([dataset_name], filter_empty=False)
    if mapper is None:
        mapper = DatasetMapper(cfg, is_train=False, keep_ignore=with_gt)
    return EvalLoader(
        dataset_dicts, mapper, batch_size, cfg.DATALOADER.NUM_WORKERS, rank, world_size, with_gt=with_gt,
    )
