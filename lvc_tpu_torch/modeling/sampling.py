"""Fixed-shape positive/negative sampling (counterpart of
``lvc_tpu/modeling/sampling.py:55-109``).

``subsample_labels`` returns a fixed ``num_samples`` slot layout: positives in
the first ``num_pos`` slots, negatives in the next ``num_neg``, and a mask of
the filled slots. The random priorities come from a ``torch.Generator`` that
the caller passes; torch's generator cannot reproduce ``jax.random``, so the
two packages agree on which indices are sampled only when the sampling is
exhaustive (every positive and negative taken).

``global_ratio`` is the one-process form of the JAX function: the data-axis
sums come with data parallelism (ROADMAP.md queue 1, item 7).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def global_ratio(num: torch.Tensor, den, min_den: float = 1.0) -> torch.Tensor:
    """``num / max(den, min_den)``, dividing by a tensor (IEEE division on
    every device)."""
    den = torch.as_tensor(den, dtype=num.dtype, device=num.device)
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
