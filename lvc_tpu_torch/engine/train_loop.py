"""The training step (counterpart of ``lvc_tpu/engine/train_loop.py``:
``make_train_step`` :23-121, ``make_data_parallel_train_step`` :124-150).

Each step runs the model in training mode to its loss dict, sums
``total_loss``, back-propagates, steps the optimizer and the schedule. A
non-finite ``total_loss`` raises ``FloatingPointError`` after the step, as
the JAX trainer's ``run_step`` does (``engine/defaults.py:275-278``).

The sampling comes from ``generator``: a ``torch.Generator`` (or a list of
one per image), or an int, the step's seed. From a seed the step makes one
generator per image at its global position (``sampling.per_image_generators``)
and seeds the device's default generator, which dropout draws from, from the
seed and the rank, as JAX folds the step into its key and the shard's index
into its dropout key (``train_loop.py:63-66``).

``make_data_parallel_train_step`` is the step of one rank of a
``torch.distributed`` group: the model runs under ``DistributedDataParallel``
(its gradients averaged over the ranks) inside ``sampling_axis_scope``, where
every loss normaliser is the global one and carries the gradient sum that
makes DDP's average the one-process gradient (``modeling/sampling.py``); the
metrics are averaged over the group, a no-op for the global losses. So an
n-rank step on a global batch reproduces the one-process step on it: the
same sampled slots, losses and gradients up to the order of float32 sums.

``mixed_precision`` mirrors the JAX step's AMP (``train_loop.py:75-97``):
the parameters stay float32 masters; the raw image is cast to bf16 and
normalized in bf16, and the forward runs in bf16 through the model's compute
dtype (every conv and linear casts its input and weight to it, so the
gradients come back float32); ``SyncBatchNorm`` sees its affine rounded to
bf16 (``layers.bf16_params``), as JAX's step casts every param; the losses
are float32. ``torch.autocast`` is not used: its per-op dtype lists are not
the JAX package's.

The backward and the optimizer step run in the spans ``backward`` and
``optimizer`` (``utils/tracing.py``); the model's forward adds ``backbone``,
``rpn`` and ``roi_heads``.
"""
from __future__ import annotations

from contextlib import nullcontext
from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel

from lvc_tpu_torch.modeling.layers import compute_dtype_scope
from lvc_tpu_torch.modeling.sampling import data_rank, fold_in, per_image_generators, sampling_axis_scope
from lvc_tpu_torch.utils import comm
from lvc_tpu_torch.utils.tracing import span


def make_train_step(
    model, optimizer: torch.optim.Optimizer, scheduler, mixed_precision: bool = False,
    data_parallel: Optional[DistributedDataParallel] = None,
) -> Callable[..., Dict[str, torch.Tensor]]:
    """Returns ``train_step(batch, generator=None) -> metrics``: the losses
    and ``total_loss`` (detached, on the model's device). The model must be
    in training mode. ``data_parallel``: ``model`` wrapped in DDP, whose
    forward the step runs in the sampling scope of its process group (use
    ``make_data_parallel_train_step``)."""
    forward = model if data_parallel is None else data_parallel
    device = next(model.parameters()).device

    def train_step(batch: Dict, generator=None) -> Dict[str, torch.Tensor]:
        scope = nullcontext() if data_parallel is None else sampling_axis_scope(data_parallel.process_group)
        saved = model.compute_dtype
        with scope:
            if isinstance(generator, int):
                seed = generator
                generator = per_image_generators(seed, len(batch["image"]), device)
                torch.manual_seed(fold_in(seed, 1, data_rank()))
            amp = nullcontext()
            if mixed_precision:
                model.compute_dtype = torch.bfloat16
                batch = dict(batch, image=torch.as_tensor(batch["image"]).to(torch.bfloat16))
                amp = compute_dtype_scope(torch.bfloat16, bf16_params=True)
            try:
                with amp:
                    losses = forward(batch, generator=generator)
            finally:
                model.compute_dtype = saved
        losses = {k: v.float() for k, v in losses.items()}
        total = sum(losses.values())
        with span("backward"):
            optimizer.zero_grad(set_to_none=True)
            total.backward()
        with span("optimizer"):
            optimizer.step()
            scheduler.step()
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["total_loss"] = total.detach()
        if data_parallel is not None:
            metrics = comm.reduce_dict(metrics)
        if not bool(torch.isfinite(metrics["total_loss"])):
            raise FloatingPointError(
                f"Loss became infinite or NaN: { {k: float(v) for k, v in metrics.items()} }"
            )
        return metrics

    return train_step


def make_data_parallel_train_step(
    model, optimizer: torch.optim.Optimizer, scheduler, mixed_precision: bool = False
) -> Callable[..., Dict[str, torch.Tensor]]:
    """The train step of this rank of the default process group: ``model``
    under ``DistributedDataParallel`` (rank 0's parameters broadcast to the
    others when it is wrapped), the batch this rank's share of the global
    batch. The parameters stay ``model``'s, so the checkpointer and the
    evaluation use ``model`` itself. No buffer is broadcast per step: the
    running statistics of FrozenBN and ``SyncBatchNorm`` do not move in a
    step (every detector call site normalises with them, as JAX's do), and
    a PreciseBN refresh does the same arithmetic on every rank, from the
    same statistics, so the ranks' buffers stay equal. DDP searches the
    graph for trainable parameters that get no gradient only where the
    model says it has them (``unused_parameters``: the context detector, and
    a mask or keypoint model, whose head gets none from a batch without its
    gt);
    elsewhere every trainable parameter gets one in every step (frozen ones
    have ``requires_grad`` off)."""
    if not dist.is_initialized():
        raise RuntimeError("make_data_parallel_train_step needs torch.distributed initialised (engine/launch.py)")
    ddp = DistributedDataParallel(model, broadcast_buffers=False,
                                  find_unused_parameters=getattr(model, "unused_parameters", False))
    return make_train_step(model, optimizer, scheduler, mixed_precision, data_parallel=ddp)
