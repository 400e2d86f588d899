"""A run with the timed path broken underneath comes out not correct: the
harness's drivers on the CPU (its look for a card skipped) with a step that
leaves the state unchanged, a step on half of the batch (the mean over the
rest), the data-parallel step without the exchange between ranks (two
gloo ranks), and a served detection altered where it is produced."""
import pytest
import torch

from benchmark import check, faults, spec
from benchmark.drivers import infer, train
from benchmark.tests import narrow

FP32 = dict(narrow.OVERRIDES, **{"SOLVER.AMP.ENABLED": False})


@pytest.mark.parametrize("name,fault", [("base_train_b16", faults.Unchanged()),
                                        ("base_train_b16", faults.HalfBatch()),
                                        ("base_train_dp4", faults.NoExchange())],
                         ids=["unchanged", "half_batch", "no_exchange"])
def test_training_fault_is_not_correct(name, fault):
    cell = narrow.cell(spec.cell(name))
    out = train.run(cell, spec.config(cell["config"]), 21, 0.2, False, torch.device("cpu"), FP32, faults=fault)
    assert not check.judge(out["numbers"], cell["limits"])[0], out["numbers"]


def test_altered_answer_is_not_correct():
    cell = narrow.cell(spec.cell("extract_infer_b8"))
    out = infer.run(cell, spec.config(cell["config"]), 22, 0.5, False, torch.device("cpu"), narrow.OVERRIDES,
                    faults=faults.AlteredAnswer())
    assert not check.judge(out["numbers"], cell["limits"])[0], out["numbers"]
