"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the port; names are compared by their whole
top-level part (``lvc_tpu_torch`` is not ``lvc_tpu``)."""
import ast
import os
import subprocess
import sys

from benchmark import spec

BANNED = {"jax", "jaxlib", "flax", "lvc_tpu"}


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


def _files(sub=""):
    for root, _, files in os.walk(os.path.join(spec.HERE, sub)):
        yield from (os.path.join(root, f) for f in files if f.endswith(".py"))


def test_no_source_of_the_benchmark_imports_jax():
    for path in _files():
        if os.sep + "tests" + os.sep in path:
            continue
        assert not set(_imports(path)) & BANNED, path


def test_the_reference_imports_nothing_of_the_port():
    for path in _files("reference"):
        assert "lvc_tpu_torch" not in set(_imports(path)), path


def test_modules_loaded_by_the_harness_and_the_reference():
    code = ("import sys, benchmark.run, benchmark.drivers.train, benchmark.drivers.infer, benchmark.readings; "
            "import benchmark.program as p; import torch; from benchmark import spec; "
            "cfg = p.port_cfg(spec.config('lvc_r50_fpn_base')); "
            "import lvc_tpu_torch.modeling.meta_arch.build, lvc_tpu_torch.engine.train_loop, lvc_tpu_torch.data.build; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, capture_output=True, text=True, check=True)
    assert not set(eval(out.stdout)) & BANNED
    ref = subprocess.run([sys.executable, "-c", "import sys, benchmark.reference.train, benchmark.reference.weights; "
                          "print(sorted({m.split('.')[0] for m in sys.modules}))"],
                         cwd=spec.ROOT, capture_output=True, text=True, check=True)
    loaded = set(eval(ref.stdout))
    assert not loaded & BANNED and "lvc_tpu_torch" not in loaded


def test_a_rank_that_loads_jax_fails_the_run(monkeypatch, capsys):
    """The data-parallel cell's ranks report what they loaded: one rank that
    loads ``jax`` makes the run exit 3 with no result (two gloo ranks, the
    harness's look for a card skipped)."""
    import functools

    import torch

    from benchmark import faults, run
    from benchmark.drivers import train
    from benchmark.tests import narrow

    cell = narrow.cell(spec.cell("base_train_dp4"))
    monkeypatch.setattr(spec, "cell", lambda name: cell)
    monkeypatch.setattr(run, "card", lambda chips: torch.device("cpu"))
    overrides = dict(narrow.OVERRIDES, **{"SOLVER.AMP.ENABLED": False})
    monkeypatch.setattr(train, "run", functools.partial(train.run, overrides=overrides, faults=faults.LoadsJax(1)))
    assert run.main(["--workload", "base_train_dp4", "--seed", "31", "--seconds", "0.2", "--trace", "0"]) == 3
    out = capsys.readouterr()
    assert "['jax']" in out.err and not out.out.strip()
