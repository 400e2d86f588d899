"""The port's checkpoint-surgery tool against ``tools/ckpt_surgery.py`` on the
CPU.

Seeded detectron2-named state dicts (a few backbone tensors and the box
predictor, the rows of a 60-class COCO base detector, a 20-class novel one,
VOC's 15 + 5 and LVIS's 1230 classes, cascade stages, a cosine head without
a classifier bias), saved as the port's checkpointer saves them (``.pth``,
``{"model": ..., "iteration", "optimizer"}``) or as a detectron2 ``.pkl``, go
through both tools with the same flags. The written files must hold the same
names and bit-equal arrays (``randinit`` draws from ``RandomState(0)`` in
JAX's order). A JAX ``.ckpt`` raises in the port.

Tolerance: none; every array is compared for equality.
"""
import os
import pickle
import sys

import numpy as np
import pytest
import torch

from lvc_tpu_torch.tools import ckpt_surgery

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D = 12
PRED = "roi_heads.box_predictor"


def _detector(n_classes, seed, bias=True, stages=None):
    rng = np.random.RandomState(seed)
    sd = {
        "backbone.bottom_up.stem.conv1.weight": rng.normal(0, 1, (8, 3, 7, 7)),
        "backbone.bottom_up.stem.conv1.norm.running_var": rng.uniform(0.5, 2, (8,)),
        "roi_heads.box_head.fc1.weight": rng.normal(0, 1, (D, 20)),
        "roi_heads.box_head.fc1.bias": rng.normal(0, 1, (D,)),
    }
    for pred in [f"{PRED}.{k}" for k in stages] if stages else [PRED]:
        sd[f"{pred}.cls_score.weight"] = rng.normal(0, 1, (n_classes + 1, D))
        if bias:
            sd[f"{pred}.cls_score.bias"] = rng.normal(0, 1, (n_classes + 1,))
        sd[f"{pred}.bbox_pred.weight"] = rng.normal(0, 1, (4 * n_classes, D))
        sd[f"{pred}.bbox_pred.bias"] = rng.normal(0, 1, (4 * n_classes,))
    return {k: v.astype(np.float32) for k, v in sd.items()}


def _save(sd, path):
    if path.endswith(".pkl"):
        with open(path, "wb") as f:
            pickle.dump({"model": sd, "__author__": "seeded"}, f)
    else:
        torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}, "iteration": 7,
                    "optimizer": {"state": {}, "param_groups": []}}, path)
    return path


# name: (flags, src1 (classes, seed, kwargs), src2 or None, file suffix of src1)
CASES = {
    "remove_coco": (["--method", "remove", "--coco"], (60, 0, {}), None, ".pth"),
    "randinit_coco": (["--method", "randinit", "--coco"], (60, 0, {}), None, ".pth"),
    "combine_coco": (["--method", "combine", "--coco"], (60, 0, {}), (20, 1, {}), ".pth"),
    "combine_coco_cosine": (["--method", "combine", "--coco"], (60, 0, {"bias": False}), (20, 1, {"bias": False}),
                            ".pth"),
    "randinit_voc": (["--method", "randinit"], (15, 2, {}), None, ".pkl"),
    "combine_voc": (["--method", "combine", "--tar-name", "voc"], (15, 2, {}), (5, 3, {}), ".pth"),
    "combine_parallel": (["--method", "combine_parallel"], (60, 0, {}), (20, 1, {}), ".pth"),
    "randinit_coco_cascade": (["--method", "randinit", "--coco", "--cascade", "--param-name",
                               f"{PRED}.0.cls_score", f"{PRED}.1.cls_score"], (60, 4, {"stages": (0, 1)}), None,
                              ".pth"),
    "randinit_lvis": (["--method", "randinit", "--lvis"], (1230, 5, {}), None, ".pkl"),
}


@pytest.fixture(scope="module")
def jax_tool():
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import ckpt_surgery as tool
    finally:
        sys.path.pop(0)
    return tool


@pytest.mark.parametrize("case", list(CASES))
def test_surgery_matches_jax_tool(case, jax_tool, tmp_path, monkeypatch):
    flags, (n1, s1, kw1), src2, suffix = CASES[case]
    argv = flags + ["--src1", _save(_detector(n1, s1, **kw1), str(tmp_path / f"src1{suffix}"))]
    if src2 is not None:
        n2, s2, kw2 = src2
        argv += ["--src2", _save(_detector(n2, s2, **kw2), str(tmp_path / "src2.pth"))]
    outs = {}
    for side in ("jax", "port"):
        argv_side = argv + ["--save-dir", str(tmp_path / side)]
        if side == "jax":
            monkeypatch.setattr(sys, "argv", ["ckpt_surgery.py"] + argv_side)
            jax_tool.main()
        else:
            ckpt_surgery.main(ckpt_surgery.parser.parse_args(argv_side))
        (name,) = os.listdir(tmp_path / side)
        outs[side] = name, torch.load(tmp_path / side / name, map_location="cpu", weights_only=False)
    (want_name, want), (got_name, got) = outs["jax"], outs["port"]
    assert got_name == want_name and got_name.endswith(".pth")
    assert set(got) == set(want) == {"model", "iteration"} and got["iteration"] == want["iteration"] == 0
    assert set(got["model"]) == set(want["model"])
    for k, w in want["model"].items():
        assert got["model"][k].dtype == w.dtype, k
        np.testing.assert_array_equal(got["model"][k].numpy(), w.numpy(), err_msg=k)
    if "randinit" in case or "combine" in case and "parallel" not in case:
        key = f"{PRED}.0.cls_score.weight" if "cascade" in case else f"{PRED}.cls_score.weight"
        assert got["model"][key].shape[0] == {"coco": 81, "voc": 21, "lvis": 1231}[
            next(t for t in ("coco", "lvis", "voc") if t in case)]


def test_surgery_refuses_a_jax_checkpoint(tmp_path):
    src = tmp_path / "model_final.ckpt"
    src.write_bytes(b"\x80")
    with pytest.raises(ValueError, match="flax"):
        ckpt_surgery.main(ckpt_surgery.parser.parse_args(["--method", "remove", "--coco", "--src1", str(src)]))
