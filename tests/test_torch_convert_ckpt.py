"""The JAX-checkpoint converter (``lvc_tpu_torch/tools/convert_reference_ckpt.py``)
and the checkpointer's ``.ckpt`` reader, against files the JAX package writes.

The narrow detector's flax variables (``torch_narrow_detector.py``) are saved
by JAX's ``DetectionCheckpointer`` as a whole ``TrainState`` and by JAX's
converter as a variables-only file. The port reads both with ``msgpack`` and
numpy alone; the tensors equal ``from_flax`` of the variables bit for bit,
the converted ``.pth`` loads strictly into ``build_model(cfg)``, and its
forward equals the ``from_flax`` model's bit for bit. A missing key fails the
check (unless ``--allow-partial``), a misshaped one always. bf16 arrays and
flax's chunked arrays decode exactly.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

import tools.convert_reference_ckpt as jax_converter
from lvc_tpu.checkpoint.checkpointer import DetectionCheckpointer as JaxCheckpointer
from lvc_tpu.config import get_cfg as jax_get_cfg
from lvc_tpu.engine.train_loop import TrainState
from lvc_tpu.solver.build import build_optimizer as jax_build_optimizer
from lvc_tpu_torch.checkpoint.checkpointer import DetectionCheckpointer, load_state_dict_file
from lvc_tpu_torch.checkpoint.convert import from_flax, load_flax_checkpoint
from lvc_tpu_torch.config import get_cfg
from lvc_tpu_torch.modeling.meta_arch.build import build_model
from lvc_tpu_torch.tools import convert_reference_ckpt as converter
from torch_narrow_detector import narrow_cfg, narrow_variables

NARROW_OPTS = [
    "MODEL.RESNETS.DEPTH", "50", "MODEL.RESNETS.RES2_OUT_CHANNELS", "64",
    "MODEL.RESNETS.WIDTH_PER_GROUP", "16", "MODEL.FPN.OUT_CHANNELS", "64",
    "MODEL.ROI_HEADS.NUM_CLASSES", "5", "MODEL.ROI_BOX_HEAD.FC_DIM", "128",
]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """(variables, the JAX trainer's TrainState .ckpt, JAX's converter's
    variables-only .ckpt)."""
    out = tmp_path_factory.mktemp("ckpt")
    variables = narrow_variables()
    jvars = jax.tree_util.tree_map(jnp.asarray, variables)
    state = TrainState.create(jvars, jax_build_optimizer(narrow_cfg(jax_get_cfg()), jvars["params"]))
    trained = JaxCheckpointer(state, str(out)).save("model_final", state)
    pth = str(out / "port.pth")
    torch.save({"model": from_flax(variables)}, pth)
    variables_only = str(out / "variables.ckpt")
    assert jax_converter.main(["--src", pth, "--dst", variables_only]) == 0
    return variables, trained, variables_only


def test_reader_equals_from_flax(files):
    variables, trained, variables_only = files
    want = from_flax(variables)
    for path in (trained, variables_only):
        got = load_state_dict_file(path)
        assert got.keys() == want.keys()
        for k, v in want.items():
            assert torch.equal(got[k], v), (path, k)


def _forward(model):
    rng = np.random.RandomState(7)
    batch = {"image": (rng.rand(1, 128, 192, 3) * 255).astype(np.float32), "image_size": np.array([[128, 192]], np.int32)}
    return model(batch)


def test_cli_writes_a_pth_with_the_from_flax_forward(files, tmp_path, capsys):
    variables, trained, _ = files
    dst = str(tmp_path / "model_final.pth")
    assert converter.main(["--src", trained, "--dst", dst, "--config-file", "configs/Base-RCNN-FPN.yaml", *NARROW_OPTS]) == 0
    assert "validation OK" in capsys.readouterr().out
    cfg = narrow_cfg(get_cfg())
    converted = build_model(cfg, device="cpu")
    converted.load_state_dict(torch.load(dst, weights_only=False)["model"])  # strict
    reference = build_model(cfg, device="cpu")
    reference.load_state_dict(from_flax(variables))
    got, want = _forward(converted), _forward(reference)
    for name, g, w in zip(got._fields, got, want):
        if w is not None:
            assert torch.equal(g, w), name
    # MODEL.WEIGHTS may name the .ckpt itself
    direct = build_model(cfg, device="cpu")
    DetectionCheckpointer(direct).load(trained)
    for k, v in reference.state_dict().items():
        assert torch.equal(direct.state_dict()[k], v), k


def test_cli_refuses_missing_and_misshaped_keys(files, tmp_path, capsys):
    variables, _, _ = files
    sd = from_flax(variables)
    sd.pop("roi_heads.box_predictor.bbox_pred.bias")
    src = str(tmp_path / "partial.pth")
    torch.save(sd, src)
    args = ["--src", src, "--dst", str(tmp_path / "out.pth"), "--config-file", "configs/Base-RCNN-FPN.yaml"]
    assert converter.main(args + NARROW_OPTS) == 1
    assert "missing in checkpoint: roi_heads.box_predictor.bbox_pred.bias" in capsys.readouterr().out
    assert converter.main(args + ["--allow-partial"] + NARROW_OPTS) == 0
    sd["roi_heads.box_predictor.bbox_pred.bias"] = torch.zeros(3)
    torch.save(sd, src)
    assert converter.main(args + ["--allow-partial"] + NARROW_OPTS) == 1
    assert "SHAPE MISMATCH roi_heads.box_predictor.bbox_pred.bias" in capsys.readouterr().out


def test_bf16_and_chunked_arrays_decode(tmp_path, monkeypatch):
    rng = np.random.RandomState(0)
    big = rng.randn(64, 33).astype(np.float32)
    bf16 = jnp.asarray(rng.randn(5, 7), jnp.bfloat16)
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 1000)  # chunk ``big``
    tree = {"params": {"a": {"kernel": big}, "b": {"bias": np.asarray(bf16)}}, "step": np.int32(3)}
    path = tmp_path / "t.ckpt"
    path.write_bytes(serialization.msgpack_serialize(tree))
    got = load_flax_checkpoint(str(path))
    assert np.array_equal(got["params"]["a"]["kernel"], big)
    assert got["params"]["b"]["bias"].dtype == np.float32
    assert np.array_equal(got["params"]["b"]["bias"], np.asarray(bf16.astype(jnp.float32)))
    assert got["batch_stats"] == {}
