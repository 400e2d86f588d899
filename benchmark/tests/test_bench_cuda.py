"""On the card: one short run of each single-card cell through the
benchmark's command, printing a result line that is correct. Run on the card:
``python -m pytest --noconftest -p no:cacheprovider benchmark/tests/test_bench_cuda.py``."""
import json
import subprocess
import sys

import pytest

from benchmark import spec


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU form")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["base_train_b16", "extract_infer_b8"])
def test_a_short_run_is_correct(card, name):
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", name, "--seed", str(2 ** 31 + 77),
                          "--seconds", "3", "--trace", "0"], cwd=spec.ROOT, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
