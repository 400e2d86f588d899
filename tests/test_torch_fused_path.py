"""The fused residual path (``LVC_TPU_FUSED_RESIDUAL=1``) of the port against
the JAX package's fused path, on the CPU, in bf16.

JAX's fused branch runs with its TPU gate spoofed and the Pallas kernel in
interpret mode (``jax_fused`` of tests/test_torch_fused_matmul.py), jitted;
the port's on CPU tensors takes the kernel's plain version.

- The narrow R-50-FPN of tests/test_torch_backbone.py at bf16: p2-p6 within
  2e-2 of each level's max |p| (the two frameworks' bf16 convolutions round
  differently, and the differences grow through 16 blocks: measured 5.5e-3
  to 1.25e-2), with 19 fused calls in each package (16 ``conv3`` and 3 FPN
  laterals).
- ``lvc_tpu_torch.tools.check_fused_serving`` on the CPU at a tiny canvas:
  36 fused calls per R-101 forward, equal valid counts.
- One AMP train step of tests/test_torch_train.py's narrow model: losses rel
  5e-2 / abs 5e-3 and update cosine > 0.98, the tolerances of
  ``test_amp_step_matches_jax_amp``. The port routes 32 calls per step: the
  19 of the forward and, under ``REMAT``, the ``conv3`` of each of the 13
  blocks of res3-res5 again when the backward recomputes it (res2 is frozen
  at ``FREEZE_AT`` 2 and takes no gradient, so it is not recomputed).
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lvc_tpu.config import get_cfg as jax_get_cfg
from lvc_tpu.modeling.layers import compute_dtype_scope
from lvc_tpu.modeling.meta_arch.build import build_model as jax_build_model
from lvc_tpu.utils.init import materialize_variables

from lvc_tpu_torch.checkpoint.convert import from_flax, to_flax
from lvc_tpu_torch.config import get_cfg
from lvc_tpu_torch.engine.train_loop import make_train_step
from lvc_tpu_torch.modeling.meta_arch.build import build_model
from lvc_tpu_torch.tools import check_fused_serving

from test_torch_fused_matmul import jax_fused, spy_fused
from test_torch_train import _batch, _jax_steps, _leaves, _narrow, _port, _variables


def _backbone_cfg(cfg):
    cfg.merge_from_file("configs/Base-RCNN-FPN.yaml")
    cfg.MODEL.RESNETS.RES2_OUT_CHANNELS = 64
    cfg.MODEL.RESNETS.WIDTH_PER_GROUP = 16
    cfg.MODEL.FPN.OUT_CHANNELS = 64
    cfg.MODEL.ROI_BOX_HEAD.FC_DIM = 64
    cfg.MODEL.ROI_HEADS.POOLER_IMPL = "exact"
    return cfg


def test_fused_backbone_matches_jax_fused(monkeypatch):
    rng = np.random.RandomState(0)
    batch = {
        "image": (rng.rand(2, 96, 128, 3) * 255).astype(np.float32),
        "image_size": np.array([[96, 128], [80, 100]], np.int32),
    }
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jmodel = jax_build_model(_backbone_cfg(jax_get_cfg()))
    shapes = jax.eval_shape(
        functools.partial(jmodel.init, train=False), {"params": jax.random.PRNGKey(0)}, jbatch
    )
    variables = materialize_variables(shapes, seed=1, conv_init="he")
    variables = jax.tree_util.tree_map(lambda v: v * 0.6 if v.ndim == 4 else v, variables)
    jcalls = []
    with jax_fused(monkeypatch, jcalls), compute_dtype_scope(jnp.bfloat16):
        want = jax.jit(lambda v, b: jmodel.apply(v, b, method=lambda m, x: m.backbone_features(x)))(
            variables, jbatch
        )
    cfg = _backbone_cfg(get_cfg())
    cfg.MODEL.DTYPE = "bfloat16"
    tmodel = build_model(cfg, device="cpu")
    tmodel.load_state_dict(from_flax(variables))
    calls = spy_fused(monkeypatch)
    monkeypatch.setenv("LVC_TPU_FUSED_RESIDUAL", "1")
    with torch.no_grad():
        got = tmodel.backbone_features(batch)
    assert len(jcalls) == len(calls) == 19
    assert sorted(got) == sorted(want) == ["p2", "p3", "p4", "p5", "p6"]
    for k, w in want.items():
        w = np.asarray(w.astype(jnp.float32))
        g = got[k].permute(0, 2, 3, 1).float().numpy()
        assert got[k].dtype == torch.bfloat16
        rel = np.abs(g - w).max() / np.abs(w).max()
        assert rel <= 2e-2, (k, rel)


def test_check_fused_serving_runs_on_cpu(monkeypatch, capsys):
    monkeypatch.delenv("LVC_TPU_FUSED_RESIDUAL", raising=False)
    calls = spy_fused(monkeypatch)
    check_fused_serving.main(["--batch", "1", "--height", "64", "--width", "96", "--iters", "1", "--device", "cpu"])
    assert len(calls) == 2 * 36  # warm-up and one timed forward, fused
    assert "LVC_TPU_FUSED_RESIDUAL" not in os.environ
    out = capsys.readouterr().out
    assert "valid count fused/unfused: 100 100" in out and "speedup:" in out


@pytest.fixture(scope="module")
def jax_fused_amp():
    cfg = _narrow(jax_get_cfg())
    variables = jax.tree_util.tree_map(np.asarray, _variables(jax_build_model(cfg)))
    calls = []
    with pytest.MonkeyPatch.context() as mp, jax_fused(mp, calls):
        metrics, _, params = _jax_steps(cfg, variables, True, 1)
    return variables, metrics[0], params, len(calls)


def test_fused_amp_step_matches_jax_fused_amp(monkeypatch, jax_fused_amp):
    variables, j_metrics, j_params, j_calls = jax_fused_amp
    assert j_calls == 19  # JAX traces the forward once; its remat recomputes from the trace
    model, opt, sched = _port(variables)
    calls = spy_fused(monkeypatch)
    monkeypatch.setenv("LVC_TPU_FUSED_RESIDUAL", "1")
    m = make_train_step(model, opt, sched, mixed_precision=True)(_batch(), torch.Generator().manual_seed(0))
    assert len(calls) == 19 + 13
    metrics = {k: float(v) for k, v in m.items()}
    for k, ref in j_metrics.items():
        assert metrics[k] == pytest.approx(ref, rel=5e-2, abs=5e-3), (k, metrics[k], ref)
    got = dict(_leaves(to_flax(model.state_dict())["params"]))
    start = dict(_leaves(variables["params"]))
    upd_t, upd_j = [], []
    for path, want in _leaves(j_params):
        upd_j.append((np.asarray(want, np.float64) - start[path]).ravel())
        upd_t.append((np.asarray(got[path], np.float64) - start[path]).ravel())
    a, b = np.concatenate(upd_t), np.concatenate(upd_j)
    cos = float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))
    assert cos > 0.98, cos
