"""Fixed-shape positive/negative sampling (counterpart of
``lvc_tpu/modeling/sampling.py``).

``subsample_labels`` returns a fixed ``num_samples`` slot layout: positives in
the first ``num_pos`` slots, negatives in the next ``num_neg``, and a mask of
the filled slots. The random priorities come from a ``torch.Generator`` that
the caller passes; torch's generator cannot reproduce ``jax.random``, so the
two packages agree on which indices are sampled only when the sampling is
exhaustive (every positive and negative taken).

Per-image generators keep the sampling invariant to the data-parallel
decomposition, as ``per_image_keys`` keeps JAX's (:47-52): image i of a
batch draws from a generator seeded from the step's seed and the image's
*global* position, ``rank * B_local + i``, so it samples the same slots
whichever rank holds it. The rank is that of the process group named by
``sampling_axis_scope``, which the data-parallel train step enters; outside
it the offset is 0. The modules take either such a list of generators (one
per image) or one ``torch.Generator`` that every image of the batch draws
from in turn (the one-process form that tests feed).

``global_ratio`` is every loss normaliser. Inside the scope it sums the
numerator and the denominator over the group, so each rank's loss value is
the global loss. The numerator's sum is autograd-aware (its backward sums
the cotangents again), so after DDP's mean over W ranks the gradient is
``sum_r grad num_r / den``, the one-process gradient; without that sum it
would be W times too small, with a second sum W times too large (JAX's
``check_vma`` trap, ``lvc_tpu/engine/train_loop.py:102-113``). Every rank
must call it the same number of times in the same order.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

_UNSHARDED = object()
_DATA_GROUP = _UNSHARDED  # the process group the batch is split over, in the scope

Generators = Union[None, torch.Generator, Sequence[torch.Generator]]


class sampling_axis_scope:
    """Context naming the process group the batch is split over (``None``:
    the default group)."""

    def __init__(self, group=None):
        self._group = group

    def __enter__(self):
        global _DATA_GROUP
        self._saved = _DATA_GROUP
        _DATA_GROUP = self._group
        return self

    def __exit__(self, *exc):
        global _DATA_GROUP
        _DATA_GROUP = self._saved
        return False


def data_rank() -> int:
    """This process's rank in the scope's group (0 outside the scope)."""
    return 0 if _DATA_GROUP is _UNSHARDED else dist.get_rank(_DATA_GROUP)


def fold_in(seed: int, *data: int) -> int:
    """A 63-bit seed mixed from ``seed`` and ``data`` (non-negative ints)."""
    state = np.random.SeedSequence([seed, *data]).generate_state(1, np.uint64)[0]
    return int(state) & (2 ** 63 - 1)


def per_image_generators(seed: int, batch_size: int, device) -> List[torch.Generator]:
    """One generator per image of the local batch, on ``device``, seeded
    from ``seed`` and the image's global position."""
    offset = data_rank() * batch_size
    return [
        torch.Generator(device=device).manual_seed(fold_in(seed, 0, offset + i))
        for i in range(batch_size)
    ]


def image_generator(generator: Generators, i: int) -> Optional[torch.Generator]:
    """Image ``i``'s generator: its own from a list, else the shared one."""
    if isinstance(generator, (list, tuple)):
        return generator[i]
    return generator


class _SumOverGroup(torch.autograd.Function):
    """The sum over a process group whose backward sums the cotangents over
    the group again (every rank's input feeds every rank's output)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def global_ratio(num: torch.Tensor, den, min_den: float = 1.0) -> torch.Tensor:
    """``num / max(den, min_den)``, both summed over the scope's group;
    dividing by a tensor (IEEE division on every device)."""
    den = torch.as_tensor(den, dtype=num.dtype, device=num.device)
    if _DATA_GROUP is not _UNSHARDED:
        group = dist.group.WORLD if _DATA_GROUP is None else _DATA_GROUP
        num = _SumOverGroup.apply(num, group)
        den = den.detach().clone()
        dist.all_reduce(den, group=group)
    return num / torch.clamp(den, min=min_den)


def _priorities(n: int, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """n uniform draws from ``generator`` (on its own device), on ``device``."""
    gen_device = generator.device if generator is not None else torch.device("cpu")
    return torch.rand(n, generator=generator, device=gen_device).to(device)


def subsample_labels(
    labels: torch.Tensor,
    num_samples: int,
    positive_fraction: float,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """labels: (N,) with 1 = positive, 0 = negative, -1 = ignore (padding
    rows already -1). Returns (idxs (num_samples,) int64, is_positive,
    slot_valid), both bool."""
    n = labels.shape[0]
    device = labels.device
    pos = labels == 1
    neg = labels == 0
    # a random subset by the k smallest random priorities; non-members get
    # +inf and are only ever read from unfilled slots
    k = min(num_samples, n)
    inf = torch.full((), float("inf"), device=device)
    pos_pri = torch.where(pos, _priorities(n, generator, device), inf)
    neg_pri = torch.where(neg, _priorities(n, generator, device), inf)
    pos_order = torch.topk(pos_pri, k, largest=False, sorted=True).indices
    neg_order = torch.topk(neg_pri, k, largest=False, sorted=True).indices

    max_pos = int(num_samples * positive_fraction)
    num_pos = torch.clamp(pos.sum(), max=max_pos)
    num_neg = torch.minimum(neg.sum(), num_samples - num_pos)

    slot = torch.arange(num_samples, device=device)
    is_pos_slot = slot < num_pos
    neg_slot = torch.clamp(slot - num_pos, 0, k - 1)
    idxs = torch.where(is_pos_slot, pos_order[slot.clamp(0, k - 1)], neg_order[neg_slot])
    slot_valid = slot < num_pos + num_neg
    return idxs, is_pos_slot & slot_valid, slot_valid
