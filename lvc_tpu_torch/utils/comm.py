"""Cross-process communication helpers (counterpart of
``lvc_tpu/utils/comm.py``; detectron2/utils/comm.py).

One process drives one device; the processes of a run form the default
``torch.distributed`` group that ``engine/launch.py`` initialises (NCCL on
the cards, gloo on the CPU or for ranks that share a card). Every function
gives its one-process answer when ``torch.distributed`` is not initialised.

These are host-side helpers: evaluator shard merges, seeds, barriers and
metric averages. The train step's collectives (the loss normalisers'
sums and DDP's gradient all-reduce) live in ``modeling/sampling.py`` and
``engine/train_loop.py``.
"""
from __future__ import annotations

from typing import Any, List

import numpy as np
import torch
import torch.distributed as dist


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def get_world_size() -> int:
    return dist.get_world_size() if _initialized() else 1


def get_rank() -> int:
    return dist.get_rank() if _initialized() else 0


def is_main_process() -> bool:
    return get_rank() == 0


def _collective_device() -> torch.device:
    """Where a collective's tensors live: the rank's card under NCCL, else
    the CPU."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def synchronize() -> None:
    """Barrier across processes (no-op with one process)."""
    if get_world_size() == 1:
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def all_gather_objects(obj: Any) -> List[Any]:
    """A picklable object from every process, in rank order, on every
    process (``all_gather_object``; payloads may differ in size)."""
    world = get_world_size()
    if world == 1:
        return [obj]
    out: List[Any] = [None] * world
    dist.all_gather_object(out, obj)
    return out


def gather_objects(obj: Any) -> List[Any]:
    """Gather to the main process; the others get []. (An all-gather with
    the result dropped off the main process, as in JAX: one collective
    whatever the backend.)"""
    out = all_gather_objects(obj)
    return out if is_main_process() else []


def shared_random_seed() -> int:
    """A random seed that every process agrees on (rank 0's draw)."""
    return int(all_gather_objects(int(np.random.randint(2 ** 31)))[0])


def reduce_dict(d: dict, average: bool = True) -> dict:
    """The mean (or sum) over processes of every value of ``d``: floats,
    or 0-dim tensors, which stay on their device. Every process gets the
    result and must pass the same keys."""
    if get_world_size() == 1 or not d:
        return d
    keys = sorted(d)
    device = _collective_device()
    stacked = torch.stack([torch.as_tensor(d[k]).detach().to(device, torch.float64) for k in keys])
    dist.all_reduce(stacked)
    if average:
        stacked /= get_world_size()
    return {
        k: stacked[i].to(d[k].device, d[k].dtype) if isinstance(d[k], torch.Tensor) else float(stacked[i])
        for i, k in enumerate(keys)
    }
