"""Out-of-memory retry helpers (counterpart of ``lvc_tpu/utils/memory.py``;
detectron2/utils/memory.py retry_if_cuda_oom).

On ``torch.cuda.OutOfMemoryError`` the wrapped function is retried once
after ``torch.cuda.empty_cache()``, then once more with its tensor
arguments on the CPU, with a warning: the JAX helper's ladder. No entry point
of the port wraps itself in it.
"""
from __future__ import annotations

import functools
import logging

import torch

logger = logging.getLogger(__name__)


def _to_cpu(x):
    if isinstance(x, torch.Tensor):
        return x.cpu()
    if isinstance(x, (list, tuple)):
        return type(x)(_to_cpu(v) for v in x)
    if isinstance(x, dict):
        return {k: _to_cpu(v) for k, v in x.items()}
    return x


def retry_if_oom(func):
    """Decorator: call ``func``; on a CUDA OOM empty the cache and retry
    once; on a second OOM run it on CPU copies of its tensor arguments."""

    @functools.wraps(func)
    def wrapped(*args, **kwargs):
        try:
            return func(*args, **kwargs)
        except torch.cuda.OutOfMemoryError:
            logger.warning("OOM in %s; emptying the CUDA cache and retrying", func.__name__)
        torch.cuda.empty_cache()
        try:
            return func(*args, **kwargs)
        except torch.cuda.OutOfMemoryError:
            logger.warning("OOM again in %s; retrying on the CPU", func.__name__)
        return func(*_to_cpu(args), **_to_cpu(kwargs))

    return wrapped
