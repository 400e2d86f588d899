"""Checkpoint save, load and resume (counterpart of
``lvc_tpu/checkpoint/checkpointer.py:21-125``; the reference's fvcore
Checkpointer stack, lvc/checkpoint/detection_checkpoint.py:9).

The native format is ``torch.save`` of ``{"model": state_dict, "optimizer",
"scheduler", "iteration"}`` as ``<save_dir>/<name>.pth``, plus a
``last_checkpoint`` file naming it. ``model`` holds detectron2 names, so
``lvc_tpu/checkpoint/convert.py:149`` (``load_torch_checkpoint``) reads a
port checkpoint into the JAX package too. ``iteration`` counts the steps
taken, which is the iteration a resumed run starts at (the JAX state's
``step``).

``resume_or_load`` restores the model, the optimizer, the scheduler and the
start iteration from ``last_checkpoint`` when asked to resume; otherwise it
loads the model weights of ``MODEL.WEIGHTS``. A ``.pth`` or ``.pkl`` state
dict of detectron2 names loads by name and partially, with the JAX
package's messages for missing and unexpected keys and its shape check. A
JAX checkpoint (``.ckpt``, flax msgpack) is read with ``msgpack`` and numpy
(``convert.load_flax_checkpoint``) and mapped by ``convert.from_flax``, as
``tools/convert_reference_ckpt.py`` converts it.
"""
from __future__ import annotations

import os
import pickle
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn


def load_state_dict_file(path: str) -> Dict[str, torch.Tensor]:
    """A ``.pth`` (``torch.save``), ``.pkl`` (detectron2 model zoo) or
    ``.ckpt`` (the JAX package's flax msgpack) file -> its flat state dict of
    detectron2 names on the CPU; ``{"model": ...}`` wrappers and a ``model.``
    key prefix are taken off."""
    if path.endswith(".ckpt"):
        from lvc_tpu_torch.checkpoint.convert import from_flax, load_flax_checkpoint

        return from_flax(load_flax_checkpoint(path))
    if path.endswith(".pkl"):
        with open(path, "rb") as f:
            data = pickle.load(f, encoding="latin1")
    else:
        data = torch.load(path, map_location="cpu", weights_only=False)
    sd = data.get("model", data)
    out = {}
    for k, v in sd.items():
        if not (isinstance(v, torch.Tensor) or hasattr(v, "shape")):
            continue
        k = k[len("model."):] if k.startswith("model.") else k
        out[k] = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v))
    return out


# detectron2 state-dict entries that are no weights of the port's models
IGNORED_KEYS = ("num_batches_tracked", "anchor_generator.cell_anchors", "pixel_mean", "pixel_std")


def load_into_model(model: nn.Module, sd: Dict[str, torch.Tensor]) -> None:
    """Copy the tensors of ``sd`` whose names ``model`` has into it. Unexpected
    and missing keys are printed, as the JAX package's partial load does
    (missing ones keep their initial values); a shape that differs raises."""
    target = model.state_dict()
    incoming = {k: v for k, v in sd.items() if not any(s in k for s in IGNORED_KEYS)}
    for k in incoming.keys() - target.keys():
        print(f"[checkpoint] unexpected key in model: {k}")
    for k in sorted(target.keys() - incoming.keys()):
        print(f"[checkpoint] missing key in model (kept init): {k}")
    with torch.no_grad():
        for k, v in incoming.items():
            if k not in target:
                continue
            t = target[k]
            if tuple(v.shape) != tuple(t.shape):
                raise ValueError(
                    f"shape mismatch for {k}: ckpt {tuple(v.shape)} vs model {tuple(t.shape)}"
                )
            t.copy_(v.to(dtype=t.dtype))


class DetectionCheckpointer:
    """``save_to_disk``: False on every rank of a data-parallel run but the
    main one (fvcore's flag), whose ``save`` then writes nothing."""

    def __init__(self, model: nn.Module, save_dir: str = "", optimizer=None, scheduler=None,
                 save_to_disk: bool = True):
        self.model = model
        self.save_dir = save_dir
        self.optimizer = optimizer
        self.scheduler = scheduler
        self.save_to_disk = save_to_disk

    # ------------------------------------------------------------------ save
    def save(self, name: str, iteration: int) -> str:
        """Write ``<save_dir>/<name>.pth`` and point ``last_checkpoint`` at it."""
        path = os.path.join(self.save_dir, f"{name}.pth")
        if not self.save_to_disk:
            return path
        os.makedirs(self.save_dir, exist_ok=True)
        data = {"model": self.model.state_dict(), "iteration": int(iteration)}
        if self.optimizer is not None:
            data["optimizer"] = self.optimizer.state_dict()
        if self.scheduler is not None:
            data["scheduler"] = self.scheduler.state_dict()
        tmp = path + ".tmp"
        torch.save(data, tmp)
        os.replace(tmp, path)
        with open(os.path.join(self.save_dir, "last_checkpoint"), "w") as f:
            f.write(f"{name}.pth")
        return path

    # ------------------------------------------------------------------ load
    def load(self, path: str, resume: bool = False) -> Optional[int]:
        """Load the model weights of ``path``. With ``resume`` and a native
        checkpoint, also the optimizer and the scheduler; returns the
        checkpoint's iteration then, else None."""
        if not resume:
            load_into_model(self.model, load_state_dict_file(path))
            return None
        data = torch.load(path, map_location="cpu", weights_only=False)
        load_into_model(self.model, data["model"])
        if self.optimizer is not None and "optimizer" in data:
            self.optimizer.load_state_dict(data["optimizer"])
        if self.scheduler is not None and "scheduler" in data:
            self.scheduler.load_state_dict(data["scheduler"])
        return int(data["iteration"])

    # ------------------------------------------------------------ resume API
    def has_checkpoint(self) -> bool:
        return os.path.exists(os.path.join(self.save_dir, "last_checkpoint"))

    def get_checkpoint_file(self) -> Optional[str]:
        f = os.path.join(self.save_dir, "last_checkpoint")
        if not os.path.exists(f):
            return None
        with open(f) as fp:
            return os.path.join(self.save_dir, fp.read().strip())

    def resume_or_load(self, path: str, resume: bool = True) -> Tuple[bool, int]:
        """``resume`` and a ``last_checkpoint`` -> restore the whole training
        state; otherwise load the model weights of ``path``
        (lvc/engine/defaults.py:351-364). Returns (resumed, start iteration)."""
        if resume and self.has_checkpoint():
            return True, self.load(self.get_checkpoint_file(), resume=True)
        if path:
            self.load(path)
        return False, 0
