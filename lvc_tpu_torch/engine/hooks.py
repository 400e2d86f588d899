"""Trainer hooks (counterpart of ``lvc_tpu/engine/hooks.py``).

Counterpart of detectron2/engine/hooks.py (IterationTimer:75,
PeriodicWriter:146, PeriodicCheckpointer:177, LRScheduler:196, EvalHook:300,
PreciseBN:357) and lvc/engine/hooks.py (EvalHookFsdet:16 with
flattened-scalar storage and inference/res_final.json dumps).

``LRSchedulerHook`` only logs the scheduled learning rate, as the JAX hook
does: the port's train step steps its ``LambdaLR`` itself
(``engine/train_loop.py``), so a hook that stepped it too would advance the
schedule twice per iteration. ``PreciseBN`` and ``update_bn_stats`` compute
what the JAX package's do (``hooks.py:137-202``), EMA inversion and float32
rounding included.
"""
from __future__ import annotations

import json
import logging
import os
import time
from typing import Callable

import torch

from lvc_tpu_torch.evaluation.testing import flatten_results_dict
from lvc_tpu_torch.utils import comm, tracing

logger = logging.getLogger(__name__)


class HookBase:
    trainer = None  # set by the trainer

    def before_train(self):
        pass

    def after_train(self):
        pass

    def before_step(self):
        pass

    def after_step(self):
        pass


class IterationTimer(HookBase):
    """The ``time`` scalar: each step's host seconds (loader wait, the step
    and its synchronisation), after ``warmup_iter`` steps."""

    def __init__(self, warmup_iter: int = 3):
        self._warmup_iter = warmup_iter
        self._start_time = None
        self._step_start = None

    def before_train(self):
        self._start_time = time.perf_counter()

    def before_step(self):
        self._step_start = time.perf_counter()

    def after_step(self):
        dt = time.perf_counter() - self._step_start
        if self.trainer.iter - self.trainer.start_iter >= self._warmup_iter:
            self.trainer.storage.put_scalar("time", dt)

    def after_train(self):
        total = time.perf_counter() - self._start_time
        n = max(self.trainer.iter - self.trainer.start_iter, 1)
        logger.info("Total training time: %.1fs (%.4f s/it over %d iters)", total, total / n, n)


class LRSchedulerHook(HookBase):
    """Logs ``schedule(iter)``, the learning rate of the step just taken (the
    scheduler itself is stepped by the train step)."""

    def __init__(self, schedule: Callable[[int], float]):
        self._schedule = schedule

    def after_step(self):
        lr = float(self._schedule(self.trainer.iter))
        self.trainer.storage.put_scalar("lr", lr, smoothing_hint=False)


class PeriodicCheckpointerHook(HookBase):
    """Saves ``model_{iter:07d}`` every ``period`` steps and after the last
    (the main rank writes; every rank waits for it)."""

    def __init__(self, checkpointer, period: int, max_iter: int):
        self._checkpointer = checkpointer
        self._period = period
        self._max_iter = max_iter

    def after_step(self):
        it = self.trainer.iter
        if (it + 1) % self._period == 0 or (it + 1) >= self._max_iter:
            self._checkpointer.save(f"model_{it:07d}", iteration=it + 1)
            comm.synchronize()


class PeriodicWriter(HookBase):
    def __init__(self, writers, period: int = 20):
        self._writers = writers
        self._period = period

    def after_step(self):
        if (self.trainer.iter + 1) % self._period == 0 or (
            self.trainer.iter + 1
        ) >= self.trainer.max_iter:
            for w in self._writers:
                w.write(self.trainer.storage)

    def after_train(self):
        for w in self._writers:
            w.write(self.trainer.storage)
            w.close()


class ProfilerHook(HookBase):
    """A ``torch.profiler`` trace over the steps ``start_iter`` to
    ``end_iter`` (counterpart of the JAX hook's ``jax.profiler`` capture and
    the reference's AutogradProfiler, d2 hooks.py:236-297), written as a
    Chrome trace to ``<output_dir>/profiler/trace.json``, with the ranges of
    every thread. The program's spans and counters (``utils/tracing.py``),
    cleared when the trace starts, go to ``profiler/spans.json`` beside it
    and to the log, one line a span."""

    def __init__(self, start_iter: int, end_iter: int, output_dir: str):
        self._start = start_iter
        self._end = end_iter
        self._dir = os.path.join(output_dir, "profiler")
        self._prof = None

    def before_step(self):
        if self.trainer.iter == self._start:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            tracing.reset()
            # the loader's worker threads' ranges too
            every_thread = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
            self._prof = torch.profiler.profile(activities=activities, experimental_config=every_thread)
            self._prof.start()

    def _stop(self):
        self._prof.stop()
        os.makedirs(self._dir, exist_ok=True)
        path = os.path.join(self._dir, "trace.json")
        self._prof.export_chrome_trace(path)
        self._prof = None
        spans = tracing.totals()
        with open(os.path.join(self._dir, "spans.json"), "w") as f:
            json.dump(spans, f, indent=1, sort_keys=True)
        logger.info("Saved profiler trace to %s", path)
        for name, t in sorted(spans.items()):
            stream = "-" if t["stream_ms"] is None else f"{t['stream_ms']:.3f}"
            logger.info("span %s: %d calls, host %.3f ms, stream %s ms, counts %s",
                        name or "(none)", t["calls"], t["host_ms"], stream, t["counts"])

    def after_step(self):
        if self._prof is not None and self.trainer.iter >= self._end:
            self._stop()

    def after_train(self):
        if self._prof is not None:
            self._stop()


def update_bn_stats(model, batches, momentum: float = 0.9) -> int:
    """Sets the running statistics of every FrozenBN and ``SyncBatchNorm`` of
    ``model`` to the plain average of the batch moments over ``batches``, as
    the JAX package's ``update_bn_stats`` (``hooks.py:137-175``) does: each
    batch runs through the model's training forward under ``no_grad`` in its
    build dtype (no AMP), starting from the old statistics; the batch moment
    is recovered from the updated statistics by inverting the EMA in float32,
    ``(new - momentum * old) / (1 - momentum)``, summed in batch order and
    divided by the count. A detector's norms never take batch moments (every
    call site normalises with the running statistics), so a refresh leaves
    them where they were up to that arithmetic's rounding, as in JAX. The
    divisions are by 0-dim tensors on the statistics' device: CUDA computes
    a division by a Python scalar as a product with its reciprocal, which is
    not the CPU's IEEE division. Returns the number of batches (0: nothing
    changed, also when the model has no such norms)."""
    from lvc_tpu_torch.modeling.layers import FrozenBatchNorm, SyncBatchNorm

    norms = [m for m in model.modules() if isinstance(m, (FrozenBatchNorm, SyncBatchNorm))]
    if not norms:
        return 0
    device = norms[0].running_mean.device
    old = [(m.running_mean.clone(), m.running_var.clone()) for m in norms]
    m_t = torch.tensor(momentum, dtype=torch.float32, device=device)
    keep = torch.tensor(1.0 - momentum, dtype=torch.float32, device=device)
    acc, n = None, 0
    was_training = model.training
    model.train()
    generator = torch.Generator(device=device).manual_seed(0)
    try:
        with torch.no_grad():
            for batch in batches:
                batch = {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
                model(batch, generator=generator)
                raw = [((m.running_mean - m_t * om) / keep, (m.running_var - m_t * ov) / keep)
                       for m, (om, ov) in zip(norms, old)]
                acc = raw if acc is None else [(a + r, b + q) for (a, b), (r, q) in zip(acc, raw)]
                n += 1
                for m, (om, ov) in zip(norms, old):
                    m.running_mean.copy_(om)
                    m.running_var.copy_(ov)
            if n:
                count = torch.tensor(float(n), dtype=torch.float32, device=device)
                for m, (a, b) in zip(norms, acc):
                    m.running_mean.copy_(a / count)
                    m.running_var.copy_(b / count)
    finally:
        model.train(was_training)
    return n


class PreciseBN(HookBase):
    """Refreshes the BN running statistics from ``num_iter`` batches of the
    trainer's own loader (``update_bn_stats``) after every ``period``-th
    iteration and after the last, before the checkpointer and the
    evaluation run (the JAX hook, ``hooks.py:178-202``; d2 hooks.py:357).
    It draws the batches whenever the model has a FrozenBN or SyncBN norm,
    so the steps after a refresh see the loader's batches after them, as
    in JAX."""

    def __init__(self, period: int, model, data_iter, num_iter: int = 200):
        self._period = period
        self._model = model
        self._data_iter = data_iter
        self._num_iter = num_iter

    def _run(self):
        batches = (next(self._data_iter) for _ in range(self._num_iter))
        if update_bn_stats(self._model, batches):
            logger.info("PreciseBN: refreshed the BN statistics over %d batches", self._num_iter)

    def after_step(self):
        it = self.trainer.iter + 1
        if self._period > 0 and (it % self._period == 0 or it >= self.trainer.max_iter):
            self._run()


class EvalHookFsdet(HookBase):
    """Periodic eval; flattens result scalars into storage and json-dumps
    the results (lvc hooks.py:16-84): ``inference/iter_{iter:07d}.json``
    every ``eval_period`` steps, ``inference/res_final.json`` after
    training. In a data-parallel run every rank evaluates its shard and only
    the main rank gets results; the ranks wait for each other after."""

    def __init__(self, eval_period: int, eval_fn: Callable, cfg):
        self._period = eval_period
        self._fn = eval_fn
        self._cfg = cfg

    def _do_eval(self, final: bool):
        results = self._fn()
        if results:
            flat = flatten_results_dict(results)
            for k, v in flat.items():
                try:
                    self.trainer.storage.put_scalar(k, float(v), smoothing_hint=False)
                except (TypeError, ValueError):
                    pass
            out_dir = os.path.join(self._cfg.OUTPUT_DIR, "inference")
            os.makedirs(out_dir, exist_ok=True)
            name = "res_final.json" if final else f"iter_{self.trainer.iter:07d}.json"
            with open(os.path.join(out_dir, name), "w") as f:
                json.dump(results, f)
        comm.synchronize()
        return results

    def after_step(self):
        if self._period > 0 and (self.trainer.iter + 1) % self._period == 0:
            if (self.trainer.iter + 1) < self.trainer.max_iter:
                self._do_eval(final=False)

    def after_train(self):
        self.trainer.last_eval_results = self._do_eval(final=True)
