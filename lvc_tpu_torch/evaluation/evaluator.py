"""Dataset inference loop and evaluator list (counterpart of
``lvc_tpu/evaluation/evaluator.py``: DatasetEvaluators:20,
inference_on_dataset:43; lvc/evaluation/evaluator.py
inference_on_dataset:85-161).

An eval-mode loop with warm-up and compute timing. ``infer_fn`` runs the
model on a padded batch and returns what the meta-architecture returns
(``Detections``, ``RegOnlyOutput`` or the proposal dict), which goes to the
evaluator unchanged with the batch's metas, as JAX's eval step hands it on.
Where the JAX loop waits with ``jax.block_until_ready``, this one calls
``torch.cuda.synchronize`` when the output is on the card, so the compute
time is the device's.
"""
from __future__ import annotations

import datetime
import logging
import time
from typing import Callable, List

import torch

logger = logging.getLogger(__name__)


class DatasetEvaluators:
    """Several evaluators run as one: each gets every batch, and their
    results merge into one dict (a metric key twice is an error)."""

    def __init__(self, evaluators: List):
        self._evaluators = evaluators

    def reset(self):
        for e in self._evaluators:
            e.reset()

    def process_detections(self, dets, metas):
        for e in self._evaluators:
            e.process_detections(dets, metas)

    def evaluate(self):
        results = {}
        for e in self._evaluators:
            r = e.evaluate()
            if r:
                for k, v in r.items():
                    assert k not in results, f"duplicate metric key {k}"
                    results[k] = v
        return results


def _device(out) -> torch.device:
    """The device of the first tensor in a model output."""
    values = out.values() if isinstance(out, dict) else out
    return next(v.device for v in values if isinstance(v, torch.Tensor))


def inference_on_dataset(infer_fn: Callable, data_loader, evaluator) -> dict:
    """infer_fn(batch) -> the model's padded output. Timing mirrors the
    reference: the first iterations are warm-up, compute time is measured
    apart from data time."""
    evaluator.reset()
    num_warmup = 2
    total_compute = 0.0
    start = time.perf_counter()
    n_images = 0
    for idx, (batch, metas) in enumerate(data_loader):
        t0 = time.perf_counter()
        dets = infer_fn(batch)
        device = _device(dets)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t1 = time.perf_counter()
        if idx >= num_warmup:
            total_compute += t1 - t0
        evaluator.process_detections(dets, metas)
        n_images += sum(not m.get("padding") for m in metas)
    total = time.perf_counter() - start
    if n_images:
        logger.info(
            "Inference done on %d images. compute %.4f s/img, total %s",
            n_images,
            total_compute / max(n_images, 1),
            datetime.timedelta(seconds=int(total)),
        )
    results = evaluator.evaluate()
    return results if results is not None else {}
