"""The port's ``utils`` (analysis, env, file_io, logger, memory, registry,
serialize) and ``model_zoo`` against the JAX package's on the CPU.

``parameter_count`` of the narrow detector equals JAX's over its params tree
(the FrozenBN affine counted in both, its statistics in neither). FLOPs: the port counts matmuls and convolutions with
``FlopCounterMode``, JAX reads XLA's cost analysis of the whole compiled
program; the test records their ratio on the narrow detector's eval forward
and holds it in (0.9, 1.1). ``JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_utils.py`` prints the
same ratio for the full-width R-50-FPN at one canvas. The model zoo's table
and lookups equal JAX's, and ``get`` builds the ``DefaultPredictor``'s model.
"""
import functools
import logging
import os
import pickle
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lvc_tpu.config import get_cfg as jax_get_cfg
from lvc_tpu.model_zoo import model_zoo as jzoo
from lvc_tpu.modeling.meta_arch.build import build_model as jax_build_model
from lvc_tpu.utils import analysis as janalysis
from lvc_tpu.utils import registry as jregistry
from lvc_tpu_torch.config import get_cfg
from lvc_tpu_torch.engine.defaults import DefaultPredictor
from lvc_tpu_torch.model_zoo import model_zoo as pzoo
from lvc_tpu_torch.modeling.meta_arch.build import build_model
from lvc_tpu_torch.utils import analysis, env, file_io, logger, memory, registry, serialize
from torch_narrow_detector import narrow_cfg, narrow_variables


def _batch(h=128, w=192):
    rng = np.random.RandomState(0)
    return {"image": (rng.rand(1, h, w, 3) * 255).astype(np.float32), "image_size": np.array([[h, w]], np.int32)}


def flop_ratio(jax_cfg, port_cfg, variables, batch):
    """(port FLOPs, XLA FLOPs) of the eval forward on ``batch``."""
    jmodel = jax_build_model(jax_cfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    xla = janalysis.flop_count(lambda v, b: jmodel.apply(v, b, train=False), variables, jbatch)
    model = build_model(port_cfg, device="cpu")
    with torch.no_grad():
        port = analysis.flop_count(model, batch)
    return port, xla


def test_parameter_count_and_flops_against_jax():
    variables = narrow_variables()
    model = build_model(narrow_cfg(get_cfg()), device="cpu")
    assert analysis.parameter_count(model) == janalysis.parameter_count(variables["params"])
    assert "backbone" in analysis.parameter_count_table(model)
    port, xla = flop_ratio(narrow_cfg(jax_get_cfg()), narrow_cfg(get_cfg()), variables, _batch())
    print(f"narrow R-50-FPN eval forward, 1 x 128x192: port {port:.4e} FLOPs, XLA {xla:.4e}, ratio {port / xla:.4f}")
    assert 0.9 < port / xla < 1.1
    assert analysis.flop_count(torch.matmul, torch.ones(8, 16), torch.ones(16, 32)) == 2 * 8 * 16 * 32


def test_model_zoo_as_jax(tmp_path):
    assert pzoo.CONFIG_PATH_TO_URL_SUFFIX == jzoo.CONFIG_PATH_TO_URL_SUFFIX
    for path in sorted(pzoo.CONFIG_PATH_TO_URL_SUFFIX):
        assert pzoo.get_checkpoint_url(path) == jzoo.get_checkpoint_url(path)
        for zoo in (pzoo, jzoo):  # none of the table's configs is in configs/
            with pytest.raises(RuntimeError, match="not available"):
                zoo.get_config_file(path)
    for zoo in (pzoo, jzoo):
        with pytest.raises(RuntimeError, match="not available"):
            zoo.get_checkpoint_url("nope.yaml")
    name = "COCO-detection/faster_rcnn_R_50_FPN_base.yaml"
    assert pzoo.get_config_file(name) == os.path.realpath(jzoo.get_config_file(name))
    model = pzoo.get(name, device="cpu")
    cfg = get_cfg()
    cfg.merge_from_file(pzoo.get_config_file(name))
    cfg.MODEL.WEIGHTS = ""  # a detectron2:// name, no file: get skips it
    want = DefaultPredictor(cfg, device="cpu").model.state_dict()
    got = model.state_dict()
    assert got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in want)
    with pytest.raises(RuntimeError, match="not available"):
        pzoo.get(name, trained=True, device="cpu")  # no URL for a config outside the table


def test_seed_all_rng_and_collect_env():
    a = env.seed_all_rng(123), np.random.rand(), torch.rand(1)
    b = env.seed_all_rng(123), np.random.rand(), torch.rand(1)
    assert a[0] == b[0] == 123 and a[1] == b[1] and torch.equal(a[2], b[2])
    info = env.collect_env_info()
    assert f"torch: {torch.__version__}" in info and "nvcc:" in info and "jax" not in info


def test_path_manager_local_and_dispatch(tmp_path):
    p = os.path.join(tmp_path, "x.txt")
    with open(p, "w") as f:
        f.write("hi")
    pm = file_io.PathManager
    assert pm.get_local_path(p) == p and pm.isfile(p) and pm.exists(p)
    with pm.open(p) as f:
        assert f.read() == "hi"

    class FakeScheme(file_io.PathHandler):
        def get_local_path(self, path):
            return p

    pm.register_handler(FakeScheme(), "fake://")
    assert pm.get_local_path("fake://whatever") == p
    assert isinstance(pm._get_handler("https://example.invalid/x.pth"), file_io.HTTPURLHandler)


def test_logger_helpers(capsys):
    logger.setup_logger(name="lvc_tpu_torch_test")
    for _ in range(5):
        logger.log_first_n(logging.INFO, "hello-first", n=2, name="lvc_tpu_torch_test")
    for _ in range(4):
        logger.log_every_n(logging.INFO, "hello-every", n=2, name="lvc_tpu_torch_test")
    for _ in range(3):
        logger.log_every_n_seconds(logging.INFO, "hello-seconds", n=60, name="lvc_tpu_torch_test")
    out = capsys.readouterr().out
    assert out.count("hello-first") == 2 and out.count("hello-every") == 2 and out.count("hello-seconds") == 1


def test_retry_if_oom_ladder(caplog):
    calls = []

    @memory.retry_if_oom
    def f(x, scale=1):
        calls.append(x.device.type)
        if len(calls) < 3:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")
        return x * scale

    assert torch.equal(f(torch.ones(2), scale=torch.tensor(3.0)), torch.full((2,), 3.0))
    assert len(calls) == 3 and "retrying on the CPU" in caplog.text

    @memory.retry_if_oom
    def bad():
        raise ValueError("not oom")

    with pytest.raises(ValueError):
        bad()
    assert memory.retry_if_oom(lambda x: x + 1)(1) == 2


def test_registry_as_jax():
    for mod in (registry, jregistry):
        r = mod.Registry("THING")

        @r.register()
        def a():
            return 1

        r.register(len, name="b")
        assert r.get("a") is a and r.get("b") is len and "a" in r and sorted(r.keys()) == ["a", "b"]
        with pytest.raises(KeyError, match="already registered"):
            r.register(a)
        with pytest.raises(KeyError, match="not found"):
            r.get("c")


def test_picklable_wrapper_lambda():
    f = serialize.PicklableWrapper(lambda x: x + 1)
    g = pickle.loads(pickle.dumps(f))
    assert g(1) == 2
    assert serialize.PicklableWrapper(f)._obj is f._obj


if __name__ == "__main__":
    # the full-width R-50-FPN (configs/Base-RCNN-FPN.yaml, 80 classes) on one
    # 1 x 256x384 canvas: port FLOPs against XLA's
    def cfg(c):
        c.merge_from_file("configs/Base-RCNN-FPN.yaml")
        c.MODEL.RESNETS.DEPTH = 50
        return c

    jmodel = jax_build_model(cfg(jax_get_cfg()))
    batch = _batch(256, 384)
    shapes = jax.eval_shape(functools.partial(jmodel.init, train=False), {"params": jax.random.PRNGKey(0)},
                            {k: jnp.asarray(v) for k, v in batch.items()})
    variables = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    port, xla = flop_ratio(cfg(jax_get_cfg()), cfg(get_cfg()), variables, batch)
    print(f"R-50-FPN eval forward, 1 x 256x384: port {port:.6e} FLOPs, XLA {xla:.6e}, ratio {port / xla:.4f}")
    sys.exit(0)
