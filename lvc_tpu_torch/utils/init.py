"""Seeded weights for a model that has no checkpoint (counterpart of the
``conv_init="damped"`` rule of ``lvc_tpu/utils/init.py:21``)."""
from __future__ import annotations

import torch
from torch import nn


@torch.no_grad()
def damped_init(model: nn.Module, seed: int = 0) -> nn.Module:
    """N(0, 0.01) for every learned weight; ones for norm weights and
    ``running_var``; zeros for biases and ``running_mean``. The draws come
    from a ``torch.Generator`` on the model's device, in ``state_dict``
    order, so a seed gives the same weights on every run on that device."""
    tensors = model.state_dict()
    device = next(iter(tensors.values())).device
    gen = torch.Generator(device=device).manual_seed(seed)
    for name, t in tensors.items():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("bias", "running_mean"):
            t.zero_()
        elif leaf == "running_var" or (leaf == "weight" and ".norm." in f".{name}"):
            t.fill_(1.0)
        else:
            t.copy_(torch.randn(t.shape, generator=gen, device=device, dtype=t.dtype) * 0.01)
    return model
