"""Checkpoint save, load and resume (counterpart of
``lvc_tpu/checkpoint/checkpointer.py:21-125``; the reference's fvcore
Checkpointer stack, lvc/checkpoint/detection_checkpoint.py:9).

The native format is ``torch.save`` of ``{"model": state_dict, "norms",
"optimizer", "scheduler", "iteration"}`` as ``<save_dir>/<name>.pth``, plus
a ``last_checkpoint`` file naming it. ``model`` holds detectron2 names, so
``lvc_tpu/checkpoint/convert.py:149`` (``load_torch_checkpoint``) reads a
port checkpoint into the JAX package too; ``norms`` names the flax norm of
each norm entry (``FrozenBatchNorm_0``, ``SyncBatchNorm_0``,
``GroupNorm_0``), which a state dict alone does not tell. ``iteration``
counts the steps taken, which is the iteration a resumed run starts at (the
JAX state's ``step``).

``resume_or_load`` restores the model, the optimizer, the scheduler and the
start iteration from ``last_checkpoint`` when asked to resume; otherwise it
loads the model weights of ``MODEL.WEIGHTS`` (``load_for_model``). A
``.pth`` or ``.pkl`` state dict of detectron2 names loads by name and
partially, with the JAX package's messages for missing and unexpected keys
and its shape check. A JAX checkpoint (``.ckpt``, flax msgpack) is read
with ``msgpack`` and numpy (``convert.load_flax_checkpoint``) and mapped by
``convert.from_flax``, as ``tools/convert_reference_ckpt.py`` converts it.
Each norm entry fills only a norm of its own flax kind, as JAX's
checkpointer matches flax names: the port's own files and a ``.ckpt`` say
the kind, and JAX's ``torch_to_flax`` names every ``.norm`` of any other
``.pth``/``.pkl`` ``FrozenBatchNorm_0``, so a ``SyncBatchNorm`` of the model
takes none of a detectron2 file's entries: they are unexpected and the norm
keeps its values.
"""
from __future__ import annotations

import os
import pickle
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn


def read_checkpoint(path: str) -> Tuple[Dict[str, torch.Tensor], Dict[str, str]]:
    """A ``.pth`` (``torch.save``), ``.pkl`` (detectron2 model zoo) or
    ``.ckpt`` (the JAX package's flax msgpack) file -> its flat state dict of
    detectron2 names on the CPU (``{"model": ...}`` wrappers and a
    ``model.`` key prefix taken off), and the flax norm of each norm entry:
    a ``.ckpt``'s own, those a port file records under ``"norms"``
    (``DetectionCheckpointer.save``, the converter), and for any other
    ``.pth``/``.pkl`` (detectron2's, ckpt surgery's) ``FrozenBatchNorm_0``
    for every ``.norm.`` entry, JAX's ``torch_to_flax`` rule."""
    if path.endswith(".ckpt"):
        from lvc_tpu_torch.checkpoint.convert import flax_state_dict, load_flax_checkpoint

        return flax_state_dict(load_flax_checkpoint(path))
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
    norms = data.get("norms") or {k: "FrozenBatchNorm_0" for k in out if ".norm." in k}
    return out, norms


def load_state_dict_file(path: str) -> Dict[str, torch.Tensor]:
    """``read_checkpoint``'s state dict."""
    return read_checkpoint(path)[0]


# detectron2 state-dict entries that are no weights of the port's models
IGNORED_KEYS = ("num_batches_tracked", "anchor_generator.cell_anchors", "pixel_mean", "pixel_std")


def flax_norms(model: nn.Module) -> Dict[str, str]:
    """The flax norm of each of ``model``'s norm entries, by state-dict key."""
    from lvc_tpu_torch.modeling.layers import FrozenBatchNorm, GroupNorm, SyncBatchNorm

    kinds = ((SyncBatchNorm, "SyncBatchNorm_0"), (FrozenBatchNorm, "FrozenBatchNorm_0"), (GroupNorm, "GroupNorm_0"))
    return {f"{n}.{k}": name for n, m in model.named_modules() for cls, name in kinds if isinstance(m, cls)
            for k in m.state_dict()}


def misplaced_norms(model: nn.Module, norms: Dict[str, str]) -> Dict[str, str]:
    """The norm entries of a file (``norms``: ``read_checkpoint``'s) that
    the JAX package's checkpointer does not place in ``model``, each with the
    model's norm there. JAX matches flax names, so an entry fills only a
    norm of its own kind: a detectron2 file's norms are all FrozenBN to it,
    and a SyncBN norm takes none of them. One exception stays the port's: a
    FrozenBN entry fills a GroupNorm by name (a detectron2 GN file, which
    JAX cannot load)."""
    kinds = flax_norms(model)
    return {k: kinds[k] for k, kind in norms.items() if kinds.get(k, kind) != kind
            and (kind, kinds[k]) != ("FrozenBatchNorm_0", "GroupNorm_0")}


def load_for_model(model: nn.Module, path: str) -> Dict[str, torch.Tensor]:
    """The entries of ``path`` that fill ``model`` as the JAX package's
    checkpointer fills it (``misplaced_norms``); the others are printed as
    unexpected and left out."""
    sd, norms = read_checkpoint(path)
    off = misplaced_norms(model, norms)
    for k in sorted(off):
        print(f"[checkpoint] unexpected key in model: {k} ({norms[k]} to JAX, not the model's {off[k]})")
    return {k: v for k, v in sd.items() if k not in off}


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
        data = {"model": self.model.state_dict(), "norms": flax_norms(self.model), "iteration": int(iteration)}
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
        checkpoint's iteration then, else None. Without ``resume``, the
        file's norms load as JAX loads them (``load_for_model``)."""
        if not resume:
            load_into_model(self.model, load_for_model(self.model, path))
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
