"""The controls come out not correct: the reference in the program's place
one precision below the configuration's (fp8 for the AMP training config,
bfloat16 for the float32 inference config), judged by the cell's limits
(on the card at the cells' sizes: ``python3 -m benchmark.readings --mode
control``)."""
import pytest
import torch

from benchmark import check, readings, spec
from benchmark.tests import narrow


@pytest.mark.parametrize("name", ["base_train_b16", "extract_infer_b8"])
def test_control_is_not_correct(name):
    cell = narrow.cell(spec.cell(name))
    play = readings.train_played if cell["driver"] == "train" else readings.infer_played
    numbers = play(cell, spec.config(cell["config"]), 5, torch.device("cpu"), "control", narrow.OVERRIDES)
    assert not check.judge(numbers, cell["limits"])[0], numbers
