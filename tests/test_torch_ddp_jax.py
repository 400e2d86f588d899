"""The port's data-parallel step held to JAX's ``make_data_parallel_train_step``
on the CPU.

tests/test_torch_train.py's narrow R-50-FPN (float32, POOLER_IMPL exact,
exhaustive sampling, so torch's and JAX's generators pick the same sets) on
its B=2 batch, from the same weights (``from_flax``): JAX's step under
``shard_map`` over a mesh of 2 of the 8 virtual CPU devices, one image each,
against the port's step in 2 gloo ranks (``launch(..., devices=["cpu",
"cpu"])``), one image each. Every loss and ``total_loss`` within rel 2e-4
on both ranks (JAX's own data-parallel test, ``tests/test_multihost.py``),
and the port's gradients and updated parameters equal to its one-process
step's (``chip_smoke.dp_compare``), so the ported step stands where JAX's
does.
"""
import numpy as np
import pytest
import torch

import chip_smoke
from lvc_tpu_torch.checkpoint.convert import from_flax
from lvc_tpu_torch.config import get_cfg
from lvc_tpu_torch.engine.launch import launch
from test_torch_train import _batch, _narrow, _variables

SEED = 7


def _jax_dp_losses(variables):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from lvc_tpu.config import get_cfg as jax_get_cfg
    from lvc_tpu.engine.train_loop import TrainState, make_data_parallel_train_step, shard_batch
    from lvc_tpu.modeling.meta_arch.build import build_model as jax_build_model
    from lvc_tpu.solver.build import build_optimizer as jax_build_optimizer

    cfg = _narrow(jax_get_cfg())
    model = jax_build_model(cfg)
    tx = jax_build_optimizer(cfg, variables["params"])
    state = TrainState.create(jax.tree_util.tree_map(jnp.asarray, variables), tx)
    mesh = Mesh(np.array(jax.devices()[:2]), axis_names=("data",))
    step = make_data_parallel_train_step(model, tx, mesh)
    with mesh:
        _, metrics = step(state, shard_batch({k: jnp.asarray(v) for k, v in _batch().items()}, mesh),
                          jax.random.PRNGKey(SEED))
    return {k: float(v) for k, v in metrics.items()}


def test_two_rank_step_matches_jax_data_parallel_step(tmp_path):
    import jax
    from lvc_tpu.config import get_cfg as jax_get_cfg
    from lvc_tpu.modeling.meta_arch.build import build_model as jax_build_model

    variables = jax.tree_util.tree_map(np.asarray, _variables(jax_build_model(_narrow(jax_get_cfg()))))
    want = _jax_dp_losses(variables)
    cfg = _narrow(get_cfg())
    cfg.MODEL.DEVICE = "cpu"
    weights = from_flax(variables)
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    launch(chip_smoke.dp_rank_main, 2, args=(str(tmp_path), [("jax", cfg, weights, batch, SEED)]),
           devices=["cpu", "cpu"])
    ranks = chip_smoke.dp_load(str(tmp_path), "jax", 2)
    assert want["loss_box_reg"] > 0 and want["loss_rpn_loc"] > 0
    for r in ranks:
        assert set(r["metrics"]) == set(want)
        for k, v in want.items():
            assert r["metrics"][k] == pytest.approx(v, rel=2e-4), (k, r["metrics"][k], v)
    one = chip_smoke.dp_step(cfg, weights, batch, SEED, data_parallel=False)
    chip_smoke.dp_compare(one, ranks, weights)
