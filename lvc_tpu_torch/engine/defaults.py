"""Argument parser, process setup and the hook-driven trainer of the port.

Counterpart of ``lvc_tpu/engine/defaults.py``: ``default_argument_parser``
and ``default_setup`` (:48-88; the torch device is logged in place of the jax
devices) and ``DefaultTrainer`` (:91-321). One process drives one device,
``cfg.MODEL.DEVICE`` (``"cuda"`` unless the caller asks for ``"cpu"``; with no
GPU and no ``"cpu"`` it raises, as ``build_model`` does). A data-parallel run
is one process a rank (``--num-gpus``, ``engine/launch.py``): each rank loads
its share of every global batch (``IMS_PER_BATCH // world size``) and its
shard of every test set, the step runs under DDP
(``make_data_parallel_train_step``), and only the main rank writes the
config dump, checkpoints, ``metrics.json`` and TensorBoard events.

The trainer builds the model, fills its weights through ``_materialize``
(the ``"he"`` rule, which subclasses override), loads ``MODEL.WEIGHTS`` or
resumes on top, and runs ``make_train_step`` under the hooks: the iteration
timer, the LR logger, PreciseBN (``TEST.PRECISE_BN.ENABLED``), the
periodic checkpointer, the evaluation hook and the metric writers. Each step
takes a numpy batch from the loader (its wait is the ``data_time``
scalar), moves it to the device, and passes the step a
seed from ``SEED`` and the iteration, from which the step seeds one generator
per image at the image's global position (and dropout's from the rank): a
resumed run samples as an uninterrupted one would, and an image samples the
same slots whichever rank holds it (the JAX step folds the step and the
image's position into its keys the same way).

``DefaultPredictor`` (``lvc_tpu/engine/defaults.py:324-385``) runs one image
through the test loader's ``DatasetMapper``: resized by ``MIN_SIZE_TEST``/
``MAX_SIZE_TEST``, padded to ``pick_canvas``'s bucket, on ``cuda`` unless
the caller asks for another device.
"""
from __future__ import annotations

import argparse
import logging
import os
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from lvc_tpu_torch.checkpoint.checkpointer import DetectionCheckpointer
from lvc_tpu_torch.data.build import build_detection_test_loader, build_detection_train_loader
from lvc_tpu_torch.data.dataset_mapper import DatasetMapper
from lvc_tpu_torch.engine import hooks as hooks_mod
from lvc_tpu_torch.engine.train_loop import make_data_parallel_train_step, make_train_step
from lvc_tpu_torch.evaluation.coco_evaluation import COCOEvaluator
from lvc_tpu_torch.evaluation.evaluator import inference_on_dataset
from lvc_tpu_torch.evaluation.testing import print_csv_format, verify_results
from lvc_tpu_torch.modeling.meta_arch.build import build_model, resolve_device
from lvc_tpu_torch.solver.build import build_lr_schedule, build_optimizer, lr_schedule
from lvc_tpu_torch.utils.events import (
    CommonMetricPrinter,
    EventStorage,
    JSONWriter,
    TensorboardWriter,
)
from lvc_tpu_torch.utils import comm
from lvc_tpu_torch.utils.init import he_init

logger = logging.getLogger("lvc_tpu_torch")


def default_argument_parser():
    """Same flags as the reference (lvc/engine/defaults.py:63-145)."""
    parser = argparse.ArgumentParser(description="LVC (PyTorch/CUDA port)")
    parser.add_argument("--config-file", default="", metavar="FILE")
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--eval-only", action="store_true")
    parser.add_argument("--eval-all", action="store_true")
    parser.add_argument("--eval-during-train", action="store_true")
    parser.add_argument("--eval-iter", type=int, default=-1)
    parser.add_argument("--start-iter", type=int, default=-1)
    parser.add_argument("--end-iter", type=int, default=-1)
    parser.add_argument("--num-gpus", type=int, default=1, help="number of processes (ranks) per machine")
    parser.add_argument("--num-machines", type=int, default=1)
    parser.add_argument("--machine-rank", type=int, default=0)
    parser.add_argument("--dist-url", default="auto")
    parser.add_argument("opts", default=None, nargs=argparse.REMAINDER)
    return parser


def default_setup(cfg, args):
    """Logging (warnings only off the main rank), the config dump into
    ``OUTPUT_DIR`` (by the main rank) and the numpy seed (``SEED``, or a
    random one when negative). Returns the seed."""
    output_dir = cfg.OUTPUT_DIR
    main = comm.is_main_process()
    if output_dir and main:
        os.makedirs(output_dir, exist_ok=True)
    logging.basicConfig(
        level=logging.INFO if main else logging.WARNING,
        format="%(asctime)s %(name)s %(levelname)s: %(message)s",
        stream=sys.stdout,
        force=False,
    )
    logger.info("Rank %d of %d; command line args: %s", comm.get_rank(), comm.get_world_size(), args)
    if cfg.MODEL.DEVICE == "cuda" and torch.cuda.is_available():
        logger.info("Device: cuda (%s)", torch.cuda.get_device_name(0))
    else:
        logger.info("Device: %s", cfg.MODEL.DEVICE)
    if output_dir and main:
        path = os.path.join(output_dir, "config.yaml")
        with open(path, "w") as f:
            f.write(cfg.dump())
        logger.info("Full config saved to %s", path)
    seed = cfg.SEED if cfg.SEED >= 0 else int.from_bytes(os.urandom(4), "little")
    np.random.seed(seed)
    return seed


class DefaultTrainer:
    """Builds the model, loader, optimizer and schedule, and runs the hook
    loop (the reference DefaultTrainer surface: train/test/build_*). Every
    rank builds the same initial weights (DDP broadcasts rank 0's when it
    wraps the model) and then loads ``MODEL.WEIGHTS`` or resumes itself."""

    def __init__(self, cfg, eval_only: bool = False):
        self.cfg = cfg
        self.device = resolve_device(cfg.MODEL.DEVICE)
        self.seed = max(cfg.SEED, 0)
        self.model = self.build_model(cfg)
        self._materialize(self.model, self.seed)
        self.start_iter = 0
        self.max_iter = cfg.SOLVER.MAX_ITER
        self.iter = 0
        self.storage: Optional[EventStorage] = None
        self._hooks: List[hooks_mod.HookBase] = []
        if eval_only:
            # the reference's eval-only path builds the model only
            # (tools/train_net.py:115-123): no optimizer, loader, step or
            # hooks, so --resume restores the model's weights alone (another
            # meta-architecture's optimizer state would not fit, e.g.
            # ProposalNetwork from a detector's checkpoint)
            self.optimizer = self.scheduler = self.data_loader = None
            self.checkpointer = DetectionCheckpointer(
                self.model, cfg.OUTPUT_DIR, save_to_disk=comm.is_main_process()
            )
            return
        self.optimizer = self.build_optimizer(cfg, self.model)
        self.scheduler = build_lr_schedule(cfg, self.optimizer)
        self.checkpointer = DetectionCheckpointer(
            self.model, cfg.OUTPUT_DIR, optimizer=self.optimizer, scheduler=self.scheduler,
            save_to_disk=comm.is_main_process(),
        )
        self.data_loader = self.build_train_loader(cfg)
        self._loader_iter = iter(self.data_loader)
        self.model.train()
        make_step = make_data_parallel_train_step if comm.get_world_size() > 1 else make_train_step
        self.train_step = make_step(
            self.model, self.optimizer, self.scheduler, mixed_precision=cfg.SOLVER.AMP.ENABLED
        )
        self.register_hooks(self.build_hooks())

    def _materialize(self, model, seed: int):
        """The initial weights (``MODEL.WEIGHTS`` and resumed checkpoints load
        on top): the ``"he"`` rule, the JAX trainer's default
        (``materialize_variables(conv_init="he")``)."""
        he_init(model, torch.Generator(device=self.device).manual_seed(seed))

    # ----------------------------------------------------------- factories
    @classmethod
    def build_model(cls, cfg):
        return build_model(cfg, device=cfg.MODEL.DEVICE)

    @classmethod
    def build_optimizer(cls, cfg, model):
        return build_optimizer(cfg, model)

    @classmethod
    def build_train_loader(cls, cfg):
        # each rank loads its share of every global batch (the reference
        # strides its samplers by rank, distributed_sampler.py:12-55)
        return build_detection_train_loader(cfg, rank=comm.get_rank(), world_size=comm.get_world_size())

    @classmethod
    def build_test_loader(cls, cfg, dataset_name):
        # batch 1: the JAX trainer's batch on one device; each rank its shard
        return build_detection_test_loader(
            cfg, dataset_name, batch_size=1, rank=comm.get_rank(), world_size=comm.get_world_size()
        )

    @classmethod
    def build_evaluator(cls, cfg, dataset_name):
        return COCOEvaluator(dataset_name, cfg, output_dir=os.path.join(cfg.OUTPUT_DIR, "inference"))

    def build_hooks(self) -> List[hooks_mod.HookBase]:
        cfg = self.cfg
        ret = [
            hooks_mod.IterationTimer(),
            hooks_mod.LRSchedulerHook(lr_schedule(cfg)),
        ]
        if cfg.TEST.PRECISE_BN.ENABLED:
            ret.append(hooks_mod.PreciseBN(cfg.TEST.EVAL_PERIOD, self.model, self._loader_iter,
                                           cfg.TEST.PRECISE_BN.NUM_ITER))
        ret += [
            hooks_mod.PeriodicCheckpointerHook(
                self.checkpointer, cfg.SOLVER.CHECKPOINT_PERIOD, cfg.SOLVER.MAX_ITER
            ),
            hooks_mod.EvalHookFsdet(cfg.TEST.EVAL_PERIOD, self.test_with_self, cfg),
        ]
        if comm.is_main_process():
            # the writers come last, after the evaluation's scalars
            ret.append(hooks_mod.PeriodicWriter(self.build_writers(), period=20))
        return ret

    def build_writers(self):
        return [
            CommonMetricPrinter(self.max_iter),
            JSONWriter(os.path.join(self.cfg.OUTPUT_DIR, "metrics.json")),
            TensorboardWriter(self.cfg.OUTPUT_DIR),
        ]

    def register_hooks(self, hooks):
        for h in hooks:
            h.trainer = self
        self._hooks.extend(hooks)

    # ------------------------------------------------------------ training
    def resume_or_load(self, resume: bool = True) -> bool:
        resumed, start = self.checkpointer.resume_or_load(self.cfg.MODEL.WEIGHTS, resume)
        if resumed:
            self.start_iter = start
        return resumed

    def run_step(self):
        t0 = time.perf_counter()
        batch = next(self._loader_iter)
        data_time = time.perf_counter() - t0
        batch = {k: torch.from_numpy(v).to(self.device) for k, v in batch.items()}
        try:
            metrics = self.train_step(batch, (self.seed << 32) + self.iter)
        except FloatingPointError as e:
            raise FloatingPointError(f"at iteration={self.iter}: {e}") from e
        self.storage.put_scalars(data_time=data_time, **{k: float(v) for k, v in metrics.items()})

    def train(self):
        logger.info("Starting training from iteration %d", self.start_iter)
        with EventStorage(self.start_iter) as self.storage:
            try:
                for h in self._hooks:
                    h.before_train()
                for self.iter in range(self.start_iter, self.max_iter):
                    self.storage.iter = self.iter
                    for h in self._hooks:
                        h.before_step()
                    self.run_step()
                    for h in self._hooks:
                        h.after_step()
            finally:
                for h in self._hooks:
                    h.after_train()
        if hasattr(self, "last_eval_results") and self.cfg.TEST.EXPECTED_RESULTS and comm.is_main_process():
            verify_results(self.cfg, self.last_eval_results)
        return getattr(self, "last_eval_results", None)

    # ----------------------------------------------------------- evaluation
    def test_with_self(self):
        return type(self).test(self.cfg, self.model)

    @classmethod
    def test(cls, cfg, model):
        """Evaluate ``model`` on every ``DATASETS.TEST`` set, in eval mode
        (its mode is restored after). Each rank runs its shard; the main
        rank gets the merged results, the others empty dicts."""
        was_training = model.training
        model.eval()
        results = {}
        try:
            for dataset_name in cfg.DATASETS.TEST:
                loader = cls.build_test_loader(cfg, dataset_name)
                evaluator = cls.build_evaluator(cfg, dataset_name)
                results_i = inference_on_dataset(model, loader, evaluator)
                results[dataset_name] = results_i
                if comm.is_main_process():
                    print_csv_format(results_i)
        finally:
            model.train(was_training)
        if not comm.is_main_process():
            return {}
        if len(results) == 1:
            results = list(results.values())[0]
        return results


class DefaultPredictor:
    """Single-image inference with the cfg's test transforms (the reference
    defaults.py:206-266). ``model`` defaults to ``build_model(cfg)`` on
    ``device`` (``cfg.MODEL.DEVICE`` unless given: ``cuda``, raising without
    a GPU), whose weights are the ``"he"`` rule from seed 0, as JAX
    materializes them, with ``MODEL.WEIGHTS`` loaded on top through
    ``DetectionCheckpointer`` when set. ``INPUT.LOADER_S2D "on"`` raises, as
    in the loader. A call takes one (H, W, 3) image in ``INPUT.FORMAT``
    order and returns that image's slice of the model's output as numpy
    arrays (``Detections`` in the canvas' coordinates, or the context
    model's dict)."""

    def __init__(self, cfg, model=None, device=None):
        self.cfg = cfg.clone()
        self.mapper = DatasetMapper(cfg, is_train=False)  # the test loader's transform and refusals
        if model is None:
            device = resolve_device(device if device is not None else cfg.MODEL.DEVICE)
            model = build_model(cfg, device=device)
            he_init(model, torch.Generator(device=device).manual_seed(0))
            if cfg.MODEL.WEIGHTS:
                DetectionCheckpointer(model).load(cfg.MODEL.WEIGHTS)
        self.model = model.eval()

    def batch(self, image: np.ndarray) -> dict:
        """The one-image batch the test loader's mapper makes: the resized
        image on its zero-padded canvas bucket, and its (h, w)."""
        ex = self.mapper._map_loaded({}, image)
        return {"image": ex["image"][None], "image_size": ex["image_size"][None]}

    def __call__(self, image: np.ndarray):
        with torch.no_grad():
            return _first_image(self.model(self.batch(image)))


def _first_image(out):
    """Image 0 of a batched model output, as numpy arrays (``None`` fields
    stay ``None``)."""
    if out is None:
        return None
    if isinstance(out, torch.Tensor):
        return out[0].cpu().numpy()
    if isinstance(out, dict):
        return {k: _first_image(v) for k, v in out.items()}
    return type(out)(*[_first_image(f) for f in out])
