"""The training step (counterpart of ``lvc_tpu/engine/train_loop.py:23-121``,
``make_train_step``, one process).

Each step runs the model in training mode to its loss dict, sums
``total_loss``, back-propagates, steps the optimizer and the schedule. A
non-finite ``total_loss`` raises ``FloatingPointError`` after the step, as
the JAX trainer's ``run_step`` does (``engine/defaults.py:275-278``).

``mixed_precision`` mirrors the JAX step's AMP (``train_loop.py:75-97``):
the parameters stay float32 masters; the raw image is cast to bf16 and
normalized in bf16, and the forward runs in bf16 through the model's compute
dtype (every conv and linear casts its weight to its input's dtype, so the
gradients come back float32); the losses are float32. ``torch.autocast`` is
not used: its per-op dtype lists are not the JAX package's.

The backward and the optimizer step run in profiler ranges ``backward`` and
``optimizer``; the model's forward adds ``backbone``, ``rpn`` and
``roi_heads``.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
from torch.profiler import record_function


def make_train_step(
    model, optimizer: torch.optim.Optimizer, scheduler, mixed_precision: bool = False
) -> Callable[..., Dict[str, torch.Tensor]]:
    """Returns ``train_step(batch, generator=None) -> metrics``: the losses
    and ``total_loss`` (detached, on the model's device). ``generator``
    draws the sampling priorities. The model must be in training mode."""

    def train_step(batch: Dict, generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        saved = model.compute_dtype
        if mixed_precision:
            model.compute_dtype = torch.bfloat16
            batch = dict(batch, image=torch.as_tensor(batch["image"]).to(torch.bfloat16))
        try:
            losses = model(batch, generator=generator)
        finally:
            model.compute_dtype = saved
        losses = {k: v.float() for k, v in losses.items()}
        total = sum(losses.values())
        with record_function("backward"):
            optimizer.zero_grad(set_to_none=True)
            total.backward()
        with record_function("optimizer"):
            optimizer.step()
            scheduler.step()
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["total_loss"] = total.detach()
        if not bool(torch.isfinite(metrics["total_loss"])):
            raise FloatingPointError(
                f"Loss became infinite or NaN: { {k: float(v) for k, v in metrics.items()} }"
            )
        return metrics

    return train_step
