"""Process launch for data-parallel runs (counterpart of
``lvc_tpu/engine/launch.py``; detectron2/engine/launch.py).

The reference's idiom, not JAX's: one process per card, spawned with
``torch.multiprocessing``, each joining the default ``torch.distributed``
group over a ``tcp://`` URL (``"auto"``: a free port on this machine). The
backend is NCCL when every rank has a card of its own and gloo otherwise:
ranks on the CPU (``MODEL.DEVICE cpu``, as the tests run) or ranks that share
a card (NCCL refuses two ranks on one device; gloo moves CUDA tensors through
the host). The rank and world size are ``utils/comm.py``'s.
"""
from __future__ import annotations

import argparse
import datetime
import logging
import socket
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from lvc_tpu_torch.utils import comm
from lvc_tpu_torch.utils.comm import get_rank, get_world_size, is_main_process  # noqa: F401

logger = logging.getLogger(__name__)

# the reference's collective timeout (detectron2/engine/launch.py): a rank may
# wait this long at a barrier while the main rank evaluates alone
DEFAULT_TIMEOUT = datetime.timedelta(minutes=30)


def _find_free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _config_device_type(args: Tuple) -> str:
    """``MODEL.DEVICE``'s type in the config that a CLI's parsed arguments
    name (``--config-file`` and the trailing opts), else ``cuda``."""
    from lvc_tpu_torch.config import get_cfg

    for a in args:
        if isinstance(a, argparse.Namespace) and hasattr(a, "opts"):
            cfg = get_cfg()
            if getattr(a, "config_file", ""):
                cfg.merge_from_file(a.config_file)
            cfg.merge_from_list(a.opts or [])
            return torch.device(cfg.MODEL.DEVICE).type
    return "cuda"


def _backend(devices: Sequence[str]) -> str:
    devs = [torch.device(d) for d in devices]
    if all(d.type == "cuda" for d in devs) and len({d.index for d in devs}) == len(devs):
        return "nccl"
    return "gloo"


def launch(
    main_func: Callable,
    num_gpus_per_machine: int,
    num_machines: int = 1,
    machine_rank: int = 0,
    dist_url: Optional[str] = None,
    args: Tuple = (),
    devices: Optional[List[str]] = None,
):
    """Run ``main_func(*args)`` in ``num_gpus_per_machine`` processes on this
    machine, ranks ``machine_rank * num_gpus_per_machine + i``.

    With one process in all and no ``devices`` it runs in this process with
    no process group. Otherwise rank i's device is ``cuda:i`` (the CLI's
    ``MODEL.DEVICE cuda``; it raises when this machine has fewer cards than
    ranks) or the CPU (``MODEL.DEVICE cpu`` in the config that ``args``
    name). ``devices`` places the local ranks explicitly (one entry each, e.g.
    ``["cuda:0", "cuda:0"]``); then a process group is made even for one
    rank."""
    world_size = num_machines * num_gpus_per_machine
    if devices is None:
        if world_size == 1:
            return main_func(*args)
        if _config_device_type(args) == "cpu":
            devices = ["cpu"] * num_gpus_per_machine
        else:
            found = torch.cuda.device_count() if torch.cuda.is_available() else 0
            if found < num_gpus_per_machine:
                raise RuntimeError(
                    f"{num_gpus_per_machine} ranks a machine asked for and {found} cards found; "
                    "set MODEL.DEVICE cpu to run the ranks on the CPU"
                )
            devices = [f"cuda:{i}" for i in range(num_gpus_per_machine)]
    devices = list(devices)
    if len(devices) != num_gpus_per_machine:
        raise ValueError(f"{len(devices)} devices given for {num_gpus_per_machine} ranks a machine")
    if dist_url in (None, "auto"):
        if num_machines > 1:
            raise ValueError('dist_url "auto" needs one machine; give tcp://<host>:<port>')
        dist_url = f"tcp://127.0.0.1:{_find_free_port()}"
    backend = _backend(devices)
    logger.info("launch: %d ranks (%s) over %s with %s", world_size, ", ".join(devices), dist_url, backend)
    mp.spawn(
        _distributed_worker,
        nprocs=num_gpus_per_machine,
        args=(main_func, world_size, num_gpus_per_machine, machine_rank, dist_url, args, devices, backend),
        daemon=False,
    )


def _distributed_worker(local_rank, main_func, world_size, num_gpus_per_machine, machine_rank,
                        dist_url, args, devices, backend):
    device = torch.device(devices[local_rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    else:
        # CPU ranks share this machine's cores: oversubscribed OpenMP pools stall each other
        torch.set_num_threads(max(1, torch.get_num_threads() // len(devices)))
    rank = machine_rank * num_gpus_per_machine + local_rank
    dist.init_process_group(backend, init_method=dist_url, world_size=world_size, rank=rank, timeout=DEFAULT_TIMEOUT)
    try:
        comm.synchronize()
        main_func(*args)
    finally:
        dist.destroy_process_group()
