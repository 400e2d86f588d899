"""The plain reference against the port at a narrow width on the CPU, in
float32 (AMP off): the whole run of a cell, its comparison included, comes
out correct, with every gap at float32 rounding."""
import pytest
import torch

from benchmark import check, spec
from benchmark.drivers import infer, train
from benchmark.tests import narrow

FP32 = dict(narrow.OVERRIDES, **{"SOLVER.AMP.ENABLED": False})


@pytest.mark.parametrize("name", ["base_train_b16", "base_train_loader_b16"])
def test_train_step_matches_the_reference(name):
    cell = narrow.cell(spec.cell(name))
    out = train.run(cell, spec.config(cell["config"]), 2 ** 32 + 3, 0.2, False, torch.device("cpu"), FP32)
    n = out["numbers"]
    assert n["proposal_mismatch"] == 0
    assert n.get("loader_mismatch", 0) == 0
    for k in ("rpn_logit_gap", "loss_gap", "grad_gap", "update_gap"):
        assert n[k] < 1e-4, (k, n[k])
    assert check.judge(n, cell["limits"])[0]


def test_inference_matches_the_reference():
    cell = narrow.cell(spec.cell("extract_infer_b8"))
    out = infer.run(cell, spec.config(cell["config"]), 2 ** 32 + 4, 0.5, False, torch.device("cpu"), narrow.OVERRIDES)
    n = out["numbers"]
    assert n["proposal_mismatch"] == 0 and n["detection_mismatch"] == 0
    for k in ("rpn_logit_peak_gap", "score_gap", "box_gap"):
        assert n[k] < 1e-4, (k, n[k])
    assert check.judge(n, cell["limits"])[0]
