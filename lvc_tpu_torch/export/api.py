"""Model export for deployment: ``torch.export``.

Counterpart of ``lvc_tpu/export/api.py``, which traces the jitted inference
function with ``jax.export`` into StableHLO. The port traces the eval forward
with ``torch.export`` (non-strict) at the example batch's shapes into an
``ExportedProgram`` of ATen operators, which ``save_exported`` writes as a
``.pt2`` archive with its weights. The program runs without the model's
Python code: ``load_exported(path).module()(batch)``.

The hand kernels and the NMS fixpoint are custom ops in the graph
(``lvc_tpu_torch::roi_align_band_fwd``, ``roi_align_paired_fwd``,
``matmul_affine_residual``, ``flash_attention_fwd``, ``nms_fixpoint``):
a program exported on the CPU runs their plain versions, one exported on the
card launches the kernels, and their wrappers count those launches as in the
eager forward. Loading a ``.pt2`` needs them registered: ``load_exported``
imports ``lvc_tpu_torch.ops`` first, and a caller of ``torch.export.load``
must import it too.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch import nn

import lvc_tpu_torch.ops  # noqa: F401  (registers the custom ops)


def _flat(out: Any) -> Any:
    """Detections (a NamedTuple) as a dict of its tensor fields, as JAX
    returns ``Detections._asdict()``; ``None`` fields are left out."""
    if hasattr(out, "_asdict"):
        return {k: v for k, v in out._asdict().items() if v is not None}
    if isinstance(out, dict):
        return {k: _flat(v) for k, v in out.items()}
    return out


class _Inference(nn.Module):
    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, batch):
        return _flat(self.model(batch))


def _device(model: nn.Module) -> torch.device:
    for t in model.parameters():
        return t.device
    for t in model.buffers():
        return t.device
    return torch.device("cpu")


def _to_device(batch: Any, device: torch.device) -> Any:
    if isinstance(batch, dict):
        return {k: _to_device(v, device) for k, v in batch.items()}
    if isinstance(batch, np.ndarray):
        batch = torch.from_numpy(batch)
    return batch.to(device) if isinstance(batch, torch.Tensor) else batch


def export_model(model: nn.Module, example_batch: Any) -> torch.export.ExportedProgram:
    """Trace ``model(batch)`` in eval mode, without gradients, at the example
    batch's shapes on the model's device (numpy arrays become tensors there),
    and return the ``ExportedProgram``. Detections come back as a dict of
    flat tensors; a model that returns a tensor (the ViT) returns it."""
    batch = _to_device(example_batch, _device(model))
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            return torch.export.export(_Inference(model), (batch,), strict=False)
    finally:
        model.train(was_training)


def save_exported(exported: torch.export.ExportedProgram, path: str) -> None:
    """Write the program and its weights to a ``.pt2`` archive."""
    torch.export.save(exported, path)


def load_exported(path: str) -> torch.export.ExportedProgram:
    """Load an archive written by :func:`save_exported`; run it with
    ``loaded.module()(batch)`` on the device it was exported on."""
    return torch.export.load(path)


def export_stablehlo_text(model: nn.Module, example_batch: Any) -> str:
    """The exported inference program as text. It keeps the JAX package's
    name so that readers find it, but the text is the ATen IR of
    ``torch.export`` (the graph, its signature and the custom ops it calls),
    not StableHLO."""
    return str(export_model(model, example_batch))
