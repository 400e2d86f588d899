"""What the benchmark takes from the program (``lvc_tpu_torch``): the model
built from a configuration file, its training step as ``train_net`` builds
it, and observation points that do not change what runs:

- ``Capture``: forward hooks that keep, while ``active``, the RPN head's
  outputs, the proposal generator's proposals and the box predictor's
  outputs, so the comparison can follow the program's own discrete choices;
- ``KernelCalls``: in a traced run, records each call of the kernels that
  the cell's roofline readers declare, for their counts;
- ``ranges``: in a traced inference run, profiler ranges named as the
  training forward's (``backbone``, ``rpn``, ``roi_heads``) around the same
  modules, which the eval forward does not open itself.
"""
from __future__ import annotations

import contextlib
import importlib
from typing import Dict, List, Optional

import torch
from torch.profiler import record_function

RANGES_TRAIN = ("backbone", "rpn", "roi_heads", "backward", "optimizer")
RANGES_INFER = ("backbone", "rpn", "roi_heads")


def port_cfg(config: Dict, overrides: Optional[Dict] = None):
    """The program's config: its defaults with every key of the
    configuration file (and ``overrides``) set."""
    from lvc_tpu_torch.config import get_cfg

    cfg = get_cfg()
    for key, value in dict(config["cfg"], **(overrides or {})).items():
        node = cfg
        *path, leaf = key.split(".")
        for part in path:
            node = node[part]
        if leaf not in node:
            raise KeyError(f"{key} is not a key of the program's config")
        if isinstance(node[leaf], tuple) and isinstance(value, list):
            value = tuple(tuple(v) if isinstance(v, list) else v for v in value)
        node[leaf] = value
    return cfg


def build_model(cfg, weights: Dict[str, torch.Tensor], device):
    """The detector with the benchmark's weights (every tensor of its state,
    by name)."""
    from lvc_tpu_torch.modeling.meta_arch.build import build_model as port_build

    model = port_build(cfg, device=device)
    model.load_state_dict(weights, strict=True)
    return model


def build_train_step(cfg, model, data_parallel: bool = False):
    """(step, optimizer): ``make_train_step`` (or its data-parallel form) on
    SGD and the LR schedule, as ``DefaultTrainer`` builds them."""
    from lvc_tpu_torch.engine.train_loop import make_data_parallel_train_step, make_train_step
    from lvc_tpu_torch.solver.build import build_lr_schedule, build_optimizer

    model.train()
    optimizer = build_optimizer(cfg, model)
    schedule = build_lr_schedule(cfg, optimizer)
    make = make_data_parallel_train_step if data_parallel else make_train_step
    return make(model, optimizer, schedule, mixed_precision=cfg.SOLVER.AMP.ENABLED), optimizer


class Capture:
    """Keeps, for each call made while ``active``, the RPN's per-level
    objectness (B, HWA) and deltas (B, HWA, 4) as the RPN flattens them,
    its proposals and their validity, and the box predictor's (class
    logits, deltas), all detached."""

    def __init__(self, model):
        self.active = False
        self.calls: List[Dict] = []
        self._handles = [
            model.proposal_generator.rpn_head.register_forward_hook(self._rpn_head),
            model.proposal_generator.register_forward_hook(self._proposals),
            model.roi_heads.box_predictor.register_forward_hook(self._predictor),
        ]

    def begin(self):
        self.active = True
        self.calls.append({})

    def end(self):
        self.active = False

    def _rpn_head(self, module, inputs, output):
        if self.active:
            logits, deltas = output
            B = logits[0].shape[0]
            self.calls[-1]["grids"] = [tuple(lo.shape[2:4]) for lo in logits]
            self.calls[-1]["logits"] = [lo.detach().permute(0, 2, 3, 1).reshape(B, -1).float() for lo in logits]
            self.calls[-1]["deltas"] = [d.detach().permute(0, 2, 3, 1).reshape(B, -1, 4).float() for d in deltas]

    def _proposals(self, module, inputs, output):
        if self.active:
            self.calls[-1]["proposals"] = output[0].detach()
            self.calls[-1]["prop_valid"] = output[2].detach()

    def _predictor(self, module, inputs, output):
        if self.active:
            self.calls[-1]["scores"] = output[0].detach()
            self.calls[-1]["box_deltas"] = output[1].detach()

    def remove(self):
        for h in self._handles:
            h.remove()


class KernelCalls:
    """Within the block, each call of a declared kernel's launching function
    (a roofline reader's ``KERNEL``, ``benchmark.spec``) is recorded by its
    yardstick's ``record`` and then made as before; ``least_ms()``
    afterwards sums the yardstick's least ms over each function's calls."""

    def __init__(self, kernels=()):
        self.kernels = list(kernels)
        self.calls: Dict[str, List] = {k["call"]: [] for k in self.kernels}

    def __enter__(self):
        from benchmark import spec

        self._saved = []
        for k in self.kernels:
            module, attr = k["call"].split(":")
            mod = importlib.import_module(module)
            orig, record, calls = getattr(mod, attr), spec.resolve(k["counts"]).record, self.calls[k["call"]]

            def wrapped(*args, _orig=orig, _record=record, _calls=calls):
                _calls.append(_record(*args))
                return _orig(*args)

            self._saved.append((mod, attr, orig))
            setattr(mod, attr, wrapped)
        return self

    def __exit__(self, *exc):
        for mod, attr, orig in reversed(self._saved):
            setattr(mod, attr, orig)
        return False

    def least_ms(self) -> Dict[str, float]:
        from benchmark import spec

        return {k["call"]: sum(spec.resolve(k["counts"]).least_ms(r) for r in self.calls[k["call"]])
                for k in self.kernels if self.calls[k["call"]]}


@contextlib.contextmanager
def ranges(model):
    """Profiler ranges ``backbone``, ``rpn`` and ``roi_heads`` around the
    model's three stages."""
    handles, open_ = [], {}
    for name, mod in (("backbone", model.backbone), ("rpn", model.proposal_generator),
                      ("roi_heads", model.roi_heads)):
        def pre(module, args, name=name):
            open_[name] = record_function(name)
            open_[name].__enter__()

        def post(module, args, output, name=name):
            open_.pop(name).__exit__(None, None, None)

        handles += [mod.register_forward_pre_hook(pre), mod.register_forward_hook(post)]
    try:
        yield
    finally:
        for h in handles:
            h.remove()
