"""Model analysis: parameter and FLOP counting.

Counterpart of ``lvc_tpu/utils/analysis.py`` (detectron2/utils/analysis.py:
FlopCountAnalysis, parameter_count). Parameters are counted over
``named_parameters`` by top-level module, the keys of JAX's params tree, plus
the affine ``weight`` and ``bias`` of every ``FrozenBatchNorm``: frozen
parameters that the port keeps as buffers and flax keeps in ``params``, so
that the counts equal JAX's. A ``SyncBatchNorm``'s affine is a parameter in
both packages and counts as one; the running statistics of either norm are
``batch_stats`` in flax and count in neither.
FLOPs come from ``torch.utils.flop_counter.FlopCounterMode``, which counts
the matmuls and convolutions that run (a multiply-add as 2) and nothing
else; JAX reads XLA's cost analysis of the compiled program, which counts
every elementwise op, reduction and gather as well, so the two totals differ
(``tests/test_torch_analysis.py`` measures by how much).
"""
from __future__ import annotations

from collections import defaultdict
from typing import Callable, Dict

from torch import nn


def _named_parameters(model: nn.Module):
    from lvc_tpu_torch.modeling.layers import FrozenBatchNorm

    yield from model.named_parameters()
    for name, m in model.named_modules():
        if isinstance(m, FrozenBatchNorm):
            yield f"{name}.weight", m.weight
            yield f"{name}.bias", m.bias


def parameter_count(model: nn.Module) -> Dict[str, int]:
    """Parameter counts per top-level module plus ``""`` = total."""
    counts: Dict[str, int] = defaultdict(int)
    for name, p in _named_parameters(model):
        counts[""] += p.numel()
        counts[name.split(".")[0]] += p.numel()
    return dict(counts)


def parameter_count_table(model: nn.Module, max_depth: int = 3) -> str:
    counts = parameter_count(model)
    rows = [("model", counts.pop(""))]
    rows += sorted(counts.items(), key=lambda kv: -kv[1])
    width = max(len(k) for k, _ in rows) + 2
    lines = [f"{'module':<{width}} #params", "-" * (width + 10)]
    for k, v in rows:
        lines.append(f"{k:<{width}} {v / 1e6:.2f}M" if v >= 1e5 else f"{k:<{width}} {v}")
    return "\n".join(lines)


def flop_count(fn: Callable, *args, **kwargs) -> float:
    """FLOPs of one ``fn(*args, **kwargs)`` call (matmuls and convolutions,
    a multiply-add as 2), from ``FlopCounterMode``."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return float(counter.get_total_flops())


def flop_count_str(fn: Callable, *args, **kwargs) -> str:
    f = flop_count(fn, *args, **kwargs)
    return f"{f / 1e9:.2f} GFLOPs"
