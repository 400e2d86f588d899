"""Index samplers (a copy of ``lvc_tpu/data/samplers.py``; the port keeps
its own). Each is a numpy ``RandomState`` stream, so a seed gives the JAX
package's indices.

Counterparts of detectron2/data/samplers/distributed_sampler.py
(TrainingSampler:12, RepeatFactorTrainingSampler:57, InferenceSampler:173)
and lvc/data/samplers.py (CategoryAwareSampler:11,
CategoryAreaAwareSampler:88). Sharding is by ``rank`` and ``world_size``
args; the trainer passes its process's.
"""
from __future__ import annotations

import itertools
import math
from collections import defaultdict
from typing import Iterator, List

import numpy as np


class TrainingSampler:
    """Infinite shuffled index stream, strided by rank."""

    def __init__(self, size: int, shuffle: bool = True, seed: int = 0, rank: int = 0, world_size: int = 1):
        self._size = size
        self._shuffle = shuffle
        self._seed = seed
        self._rank = rank
        self._world = world_size

    def __iter__(self) -> Iterator[int]:
        return itertools.islice(self._infinite(), self._rank, None, self._world)

    def _infinite(self):
        rng = np.random.RandomState(self._seed)
        while True:
            if self._shuffle:
                yield from rng.permutation(self._size)
            else:
                yield from range(self._size)


class InferenceSampler:
    """Contiguous per-rank shard covering the dataset exactly once."""

    def __init__(self, size: int, rank: int = 0, world_size: int = 1):
        shard = int(math.ceil(size / world_size))
        self._begin = min(rank * shard, size)
        self._end = min(self._begin + shard, size)

    def __iter__(self) -> Iterator[int]:
        return iter(range(self._begin, self._end))

    def __len__(self):
        return self._end - self._begin


def _repeat_factors_from_category_frequency(dataset_dicts, repeat_thresh: float) -> np.ndarray:
    counts: dict = defaultdict(int)
    for d in dataset_dicts:
        for cid in {a["category_id"] for a in d["annotations"]}:
            counts[cid] += 1
    num_images = len(dataset_dicts)
    freq = {cid: c / num_images for cid, c in counts.items()}
    cat_rep = {cid: max(1.0, math.sqrt(repeat_thresh / f)) for cid, f in freq.items()}
    rep = np.ones(num_images)
    for i, d in enumerate(dataset_dicts):
        cats = {a["category_id"] for a in d["annotations"]}
        if cats:
            rep[i] = max(cat_rep[c] for c in cats)
    return rep


class RepeatFactorTrainingSampler(TrainingSampler):
    """LVIS-style repeat-factor oversampling (distributed_sampler.py:57)."""

    def __init__(self, dataset_dicts, repeat_thresh: float, seed: int = 0, rank: int = 0, world_size: int = 1):
        self._rep = _repeat_factors_from_category_frequency(dataset_dicts, repeat_thresh)
        self._int_part = np.floor(self._rep)
        self._frac_part = self._rep - self._int_part
        super().__init__(len(dataset_dicts), True, seed, rank, world_size)

    def _infinite(self):
        rng = np.random.RandomState(self._seed)
        while True:
            rands = rng.rand(len(self._rep))
            reps = (self._int_part + (rands < self._frac_part)).astype(int)
            indices = np.repeat(np.arange(len(reps)), reps)
            yield from rng.permutation(indices)


def repeat_for_balanced_sampling(dataset_dicts, key_fn) -> np.ndarray:
    """Per-image integer repeats so that every key (category or category x
    area bucket) appears as often as the most frequent one
    (lvc samplers.py:57-70)."""
    key_counts: dict = defaultdict(int)
    img_keys: List[set] = []
    for d in dataset_dicts:
        keys = {key_fn(a) for a in d["annotations"]}
        img_keys.append(keys)
        for k in keys:
            key_counts[k] += 1
    max_count = max(key_counts.values()) if key_counts else 1
    rep = np.ones(len(dataset_dicts))
    for i, keys in enumerate(img_keys):
        if keys:
            rep[i] = max(max_count / key_counts[k] for k in keys)
    return rep


class CategoryAwareSampler(TrainingSampler):
    """Oversample so every category appears as often as the most frequent
    one (lvc samplers.py:11-86)."""

    def __init__(self, dataset_dicts, seed: int = 0, rank: int = 0, world_size: int = 1, key_fn=None):
        key_fn = key_fn or (lambda a: a["category_id"])
        self._rep = repeat_for_balanced_sampling(dataset_dicts, key_fn)
        self._int_part = np.floor(self._rep)
        self._frac_part = self._rep - self._int_part
        super().__init__(len(dataset_dicts), True, seed, rank, world_size)

    def _infinite(self):
        rng = np.random.RandomState(self._seed)
        while True:
            rands = rng.rand(len(self._rep))
            reps = (self._int_part + (rands < self._frac_part)).astype(int)
            indices = np.repeat(np.arange(len(reps)), reps)
            yield from rng.permutation(indices)


def _area_bucket(area: float) -> int:
    if area < 32**2:
        return 0
    if area < 96**2:
        return 1
    return 2


class CategoryAreaAwareSampler(CategoryAwareSampler):
    """Balanced over (category x small/medium/large) keys
    (lvc samplers.py:88)."""

    def __init__(self, dataset_dicts, seed: int = 0, rank: int = 0, world_size: int = 1):
        super().__init__(
            dataset_dicts,
            seed,
            rank,
            world_size,
            key_fn=lambda a: (a["category_id"], _area_bucket(a.get("area", 0.0))),
        )
