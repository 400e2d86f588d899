"""Dataset inference loop (counterpart of
``lvc_tpu/evaluation/evaluator.py``; lvc/evaluation/evaluator.py
inference_on_dataset:85-161).

An eval-mode loop with warm-up and compute timing. ``infer_fn`` runs the
model on a padded batch and returns its ``Detections``; the evaluators take
(Detections, metas) pairs. Where the JAX loop waits with
``jax.block_until_ready``, this one calls ``torch.cuda.synchronize`` when the
detections are on the card, so the compute time is the device's.
"""
from __future__ import annotations

import datetime
import logging
import time
from typing import Callable

import torch

logger = logging.getLogger(__name__)


def inference_on_dataset(infer_fn: Callable, data_loader, evaluator) -> dict:
    """infer_fn(batch) -> Detections (padded). Timing mirrors the
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
        if dets.boxes.is_cuda:
            torch.cuda.synchronize(dets.boxes.device)
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
