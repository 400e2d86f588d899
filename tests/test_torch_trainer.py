"""The port's hook-driven ``DefaultTrainer`` against the JAX package's on the CPU.

A narrow R-50-FPN (the ``_narrow`` config of tests/test_torch_train.py:
RES2_OUT_CHANNELS 64, WIDTH_PER_GROUP 16, FPN 64 wide, float32,
POOLER_IMPL exact, exhaustive sampling), 60 base classes and 8 gt slots,
trains on a seeded COCO tree (``chip_smoke.write_coco_tree``: 96x128 JPEGs,
1-5 boxes each) through both trainers from the same weights (he-init,
scaled as in tests/test_torch_train.py, carried by ``from_flax``): the same
loader batches (tests/test_torch_data.py holds them equal), one loader
worker.

- 3 iterations: each iteration's losses (the storages' histories) within
  rel 1e-4 of JAX's, the tolerance of tests/test_torch_train.py, and the
  ``metrics.json`` rows too; the ``lr`` logged each iteration within rel
  1e-6 or 4 float32 ulps of BASE_LR (JAX evaluates its schedule in float32,
  tests/test_torch_solver.py); the schedule stepped once per iteration.
- Save, then resume: a run cut after 2 iterations and resumed from its
  checkpoint gives the third iteration's losses and learning rate of an
  uninterrupted run, and the same weights after it (which the restored
  momentum shapes), bit for bit: one fixed batch, so the loader's restart
  does not enter, and one CPU thread, since with several the backward sums
  some float32 terms in no fixed order (two runs then differ by about
  1e-7, enough to flip a near-tie among the proposals now and then).
- A port ``.pth`` loads into JAX's ``DetectionCheckpointer``, and the
  checkpointer's partial load, shape check and refusals.
- The periodic evaluation hook writes ``inference/iter_*.json`` and
  ``res_final.json`` and puts the flattened results into the storage; the
  profiler hook writes its trace.
"""
import functools
import itertools
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization as flax_serialization

import chip_smoke
from lvc_tpu.checkpoint.checkpointer import DetectionCheckpointer as JaxCheckpointer
from lvc_tpu.config import get_cfg as jax_get_cfg
from lvc_tpu.data import catalog as jax_catalog
from lvc_tpu.data.builtin_meta import _get_builtin_metadata as jax_meta
from lvc_tpu.data.meta_coco import register_meta_coco as jax_register
from lvc_tpu.engine.defaults import DefaultTrainer as JaxTrainer
from lvc_tpu.engine.train_loop import TrainState
from lvc_tpu.modeling.meta_arch.build import build_model as jax_build_model
from lvc_tpu.solver.build import build_optimizer as jax_build_optimizer
from lvc_tpu.utils.init import materialize_variables
from lvc_tpu_torch.checkpoint.checkpointer import DetectionCheckpointer, load_state_dict_file
from lvc_tpu_torch.checkpoint.convert import from_flax, to_flax
from lvc_tpu_torch.config import get_cfg
from lvc_tpu_torch.data import catalog as port_catalog
from lvc_tpu_torch.data.builtin_meta import _get_builtin_metadata as port_meta
from lvc_tpu_torch.data.meta_coco import register_meta_coco as port_register
from lvc_tpu_torch.engine import hooks
from lvc_tpu_torch.engine.defaults import DefaultTrainer

ITERS = 3


def _narrow(cfg, out_dir):
    cfg.merge_from_file("configs/Base-RCNN-FPN.yaml")
    cfg.MODEL.RESNETS.DEPTH = 50
    cfg.MODEL.RESNETS.RES2_OUT_CHANNELS = 64
    cfg.MODEL.RESNETS.WIDTH_PER_GROUP = 16
    cfg.MODEL.FPN.OUT_CHANNELS = 64
    cfg.MODEL.ROI_HEADS.NUM_CLASSES = 60
    cfg.MODEL.ROI_BOX_HEAD.FC_DIM = 128
    cfg.MODEL.ROI_HEADS.POOLER_IMPL = "exact"
    cfg.MODEL.RPN.PRE_NMS_TOPK_TRAIN = 200
    cfg.MODEL.RPN.POST_NMS_TOPK_TRAIN = 100
    cfg.MODEL.RPN.BATCH_SIZE_PER_IMAGE = 8192
    cfg.MODEL.RPN.POSITIVE_FRACTION = 0.999
    cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE = 128
    cfg.MODEL.ROI_HEADS.POSITIVE_FRACTION = 0.999
    cfg.PAD.MAX_GT_PER_IMAGE = 8
    cfg.PAD.CANVAS_BUCKETS = [[128, 192]]
    cfg.INPUT.LOADER_S2D = "off"
    cfg.INPUT.MIN_SIZE_TRAIN = (96,)
    cfg.INPUT.MAX_SIZE_TRAIN = 192
    cfg.INPUT.MIN_SIZE_TEST = 96
    cfg.INPUT.MAX_SIZE_TEST = 192
    cfg.DATASETS.TRAIN = ("coco_trainval_base",)
    cfg.DATASETS.TEST = ()
    cfg.DATALOADER.NUM_WORKERS = 1
    cfg.SOLVER.IMS_PER_BATCH = 2
    cfg.SOLVER.BASE_LR = 0.01
    cfg.SOLVER.WARMUP_ITERS = 2
    cfg.SOLVER.MAX_ITER = ITERS
    cfg.SOLVER.CHECKPOINT_PERIOD = 2
    cfg.SEED = 3
    cfg.OUTPUT_DIR = out_dir
    return cfg


def _port_cfg(out_dir, **over):
    cfg = _narrow(get_cfg(), out_dir)
    cfg.MODEL.DEVICE = "cpu"
    for k, v in over.items():
        node = cfg
        *path, leaf = k.split(".")
        for p in path:
            node = getattr(node, p)
        setattr(node, leaf, v)
    return cfg


def _variables():
    """he-init JAX weights scaled as tests/test_torch_train.py scales them
    (well-spread RPN logits and deltas: no near-ties in NMS)."""
    model = jax_build_model(_narrow(jax_get_cfg(), ""))
    batch = {"image": jnp.zeros((1, 128, 192, 3)), "image_size": jnp.asarray([[96, 128]], np.int32)}
    shapes = jax.eval_shape(functools.partial(model.init, train=False), {"params": jax.random.PRNGKey(0)}, batch)
    var = jax.tree_util.tree_map(np.asarray, materialize_variables(shapes, seed=0, conv_init="he"))
    for name, block in var["params"]["backbone"]["bottom_up"].items():
        for leaf in jax.tree_util.tree_leaves(block):
            if leaf.ndim == 4:
                leaf *= 0.7
    rpn = var["params"]["proposal_generator"]["rpn_head"]
    rpn["conv"]["conv"]["kernel"] *= 0.1
    rpn["objectness_logits"]["conv"]["kernel"] *= 0.1
    rpn["anchor_deltas"]["conv"]["kernel"] *= 0.01
    head = var["params"]["roi_heads"]["box_predictor"]
    head["cls_score"]["kernel"] *= 0.03
    head["bbox_pred"]["kernel"] *= 0.3
    return var


def _port_trainer(variables, **statics):
    class T(DefaultTrainer):
        def _materialize(self, model, seed):
            model.load_state_dict(from_flax(variables))

    for k, v in statics.items():
        setattr(T, k, v)
    return T


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("datasets"))
    chip_smoke.write_coco_tree(root, 6, 2, sizes=((96, 128),), seed=1, max_boxes=5)
    chip_smoke.register_coco_tree(root, jax_catalog.DatasetCatalog, jax_register, jax_meta("coco_fewshot"))
    chip_smoke.register_coco_tree(root, port_catalog.DatasetCatalog, port_register, port_meta("coco_fewshot"))
    yield root
    original = os.environ.get("DETECTRON2_DATASETS", "datasets")
    chip_smoke.register_coco_tree(original, jax_catalog.DatasetCatalog, jax_register, jax_meta("coco_fewshot"))
    chip_smoke.register_coco_tree(original, port_catalog.DatasetCatalog, port_register, port_meta("coco_fewshot"))


@pytest.fixture(scope="module")
def runs(tree, tmp_path_factory):
    variables = _variables()
    out = tmp_path_factory.mktemp("runs")

    class JT(JaxTrainer):
        def _materialize(self, shapes, seed):
            return jax.tree_util.tree_map(lambda v: np.array(v), variables)

    jt = JT(_narrow(jax_get_cfg(), str(out / "jax")))
    jt.train()
    pt = _port_trainer(variables)(_port_cfg(str(out / "port")))
    pt.train()
    return variables, jt, pt, out


def _history(storage, key):
    h = storage.histories()[key]
    return list(h._deque)


def _json_rows(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_iterations_match_jax(runs):
    _, jt, pt, out = runs
    keys = ("loss_rpn_cls", "loss_rpn_loc", "loss_cls", "loss_box_reg", "total_loss")
    for k in keys:
        got, want = _history(pt.storage, k), _history(jt.storage, k)
        assert len(got) == len(want) == ITERS, k
        for g, w in zip(got, want):
            assert g == pytest.approx(w, rel=1e-4), (k, got, want)
    assert min(_history(jt.storage, "loss_box_reg")) > 0
    assert len(_history(pt.storage, "data_time")) == ITERS
    got_rows = _json_rows(out / "port" / "metrics.json")
    want_rows = _json_rows(out / "jax" / "metrics.json")
    assert [r["iteration"] for r in got_rows] == [r["iteration"] for r in want_rows] == [ITERS - 1] * 2
    for g, w in zip(got_rows, want_rows):
        for k in keys:
            assert g[k] == pytest.approx(w[k], rel=1e-4), k


def test_logged_lr_matches_jax(runs):
    _, jt, pt, _ = runs
    f32_abs = 4 * np.spacing(np.float32(pt.cfg.SOLVER.BASE_LR))
    got, want = _history(pt.storage, "lr"), _history(jt.storage, "lr")
    assert len(got) == len(want) == ITERS and got[0] < got[-1]
    for g, w in zip(got, want):
        assert g == pytest.approx(w, rel=1e-6, abs=f32_abs)
    # the hook logs; only the train step steps the schedule
    assert pt.scheduler.last_epoch == ITERS


def test_checkpoints_and_files(runs):
    _, _, pt, out = runs
    port = out / "port"
    assert (port / "last_checkpoint").read_text() == "model_0000002.pth"
    first = torch.load(port / "model_0000001.pth", map_location="cpu", weights_only=False)
    assert first["iteration"] == 2 and first["scheduler"]["last_epoch"] == 2
    assert set(first) == {"model", "norms", "optimizer", "scheduler", "iteration"}
    assert first["model"].keys() == pt.model.state_dict().keys()
    # the flax norm of each norm entry: all FrozenBN in this model
    assert first["norms"] == {k: "FrozenBatchNorm_0" for k in first["model"] if ".norm." in k}


def test_resume_reproduces_the_uninterrupted_step(tree, tmp_path):
    variables = _variables()
    batch = next(iter(DefaultTrainer.build_train_loader(_port_cfg(str(tmp_path / "x")))))

    def fixed(cls, cfg):
        return itertools.repeat(batch)

    T = _port_trainer(variables, build_train_loader=classmethod(fixed))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        full = T(_port_cfg(str(tmp_path / "full")))
        full.train()
        cut = T(_port_cfg(str(tmp_path / "cut"), **{"SOLVER.MAX_ITER": 2}))
        cut.train()
        resumed = T(_port_cfg(str(tmp_path / "cut")))
        assert resumed.resume_or_load(resume=True) and resumed.start_iter == 2
        resumed.train()
    finally:
        torch.set_num_threads(threads)
    for k in ("loss_cls", "loss_box_reg", "loss_rpn_cls", "loss_rpn_loc", "total_loss", "lr"):
        assert _history(resumed.storage, k) == _history(full.storage, k)[2:], k
    for name, p in full.model.state_dict().items():
        assert torch.equal(p, resumed.model.state_dict()[name]), name
    assert not all(torch.equal(p, cut.model.state_dict()[n]) for n, p in full.model.state_dict().items())
    # MODEL.WEIGHTS loads the model only, and the run starts at 0
    fresh = T(_port_cfg(str(tmp_path / "fresh"), **{"MODEL.WEIGHTS": str(tmp_path / "cut" / "model_0000001.pth")}))
    assert not fresh.resume_or_load(resume=True) and fresh.start_iter == 0
    for name, p in cut.model.state_dict().items():
        assert torch.equal(p, fresh.model.state_dict()[name]), name


def test_periodic_eval_and_profiler_hooks(tree, tmp_path):
    variables = _variables()
    batch = next(iter(DefaultTrainer.build_train_loader(_port_cfg(str(tmp_path / "x")))))
    T = _port_trainer(variables, build_train_loader=classmethod(lambda cls, cfg: itertools.repeat(batch)))
    out = tmp_path / "out"
    trainer = T(_port_cfg(str(out), **{"TEST.EVAL_PERIOD": 2, "DATASETS.TEST": ("coco_test_base",)}))
    trainer.register_hooks([hooks.ProfilerHook(1, 1, str(out))])
    trainer.train()
    for name in ("iter_0000001.json", "res_final.json"):
        with open(out / "inference" / name) as f:
            assert set(json.load(f)["bbox"]) >= {"bAP", "bAP50", "AP"}, name
    assert len(_history(trainer.storage, "bbox/bAP")) == 2
    assert os.path.getsize(out / "profiler" / "trace.json") > 0
    assert trainer.model.training  # the evaluation restores the training mode


def test_port_checkpoint_loads_into_jax(runs):
    variables, jt, pt, out = runs
    jax_cfg = _narrow(jax_get_cfg(), "")
    tx = jax_build_optimizer(jax_cfg, variables["params"])
    state = TrainState.create(jax.tree_util.tree_map(jnp.asarray, variables), tx)
    loaded = JaxCheckpointer(state).load(str(out / "port" / "model_0000002.pth"), state)
    want = to_flax(pt.model.state_dict())
    for tree_name in ("params", "batch_stats"):
        got_leaves = dict(jax.tree_util.tree_leaves_with_path(getattr(loaded, tree_name)))
        want_leaves = dict(jax.tree_util.tree_leaves_with_path(want[tree_name]))
        assert got_leaves.keys() == want_leaves.keys()
        for k, v in want_leaves.items():
            np.testing.assert_array_equal(np.asarray(got_leaves[k]), v)


def test_checkpointer_partial_load_and_refusals(runs, tmp_path, capsys):
    _, _, pt, out = runs
    sd = load_state_dict_file(str(out / "port" / "model_0000002.pth"))
    sd.pop("roi_heads.box_predictor.bbox_pred.bias")
    sd["extra.weight"] = torch.zeros(3)
    path = str(tmp_path / "partial.pth")
    torch.save({"model": {"model." + k: v for k, v in sd.items()}}, path)
    model = pt.model
    before = model.roi_heads.box_predictor.bbox_pred.bias.detach().clone()
    DetectionCheckpointer(model).load(path)
    printed = capsys.readouterr().out
    assert "[checkpoint] unexpected key in model: extra.weight" in printed
    assert "[checkpoint] missing key in model (kept init): roi_heads.box_predictor.bbox_pred.bias" in printed
    assert torch.equal(model.roi_heads.box_predictor.bbox_pred.bias, before)
    sd["roi_heads.box_predictor.cls_score.weight"] = torch.zeros(2, 2)
    torch.save(sd, path)
    with pytest.raises(ValueError, match="shape mismatch for roi_heads.box_predictor.cls_score.weight"):
        DetectionCheckpointer(model).load(path)
    # a JAX checkpoint (a whole TrainState in flax msgpack) loads its
    # variables through from_flax, with no flax in the port
    jax_ckpt = out / "jax" / "model_0000002.ckpt"
    DetectionCheckpointer(model).load(str(jax_ckpt))
    restored = flax_serialization.msgpack_restore(jax_ckpt.read_bytes())
    want = from_flax({"params": restored["params"], "batch_stats": restored["batch_stats"]})
    got = model.state_dict()
    assert want.keys() == got.keys()
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_trainer_refusals(tree, tmp_path):
    variables = _variables()
    T = _port_trainer(variables)
    # TEST.PRECISE_BN builds the hook where JAX's trainer puts it (tests/test_torch_batchnorm.py runs it)
    precise = T(_port_cfg(str(tmp_path), **{"TEST.PRECISE_BN.ENABLED": True}))
    assert [type(h).__name__ for h in precise._hooks][1:4] == ["LRSchedulerHook", "PreciseBN", "PeriodicCheckpointerHook"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no GPU"):
            T(_port_cfg(str(tmp_path), **{"MODEL.DEVICE": "cuda"}))
    eval_only = T(_port_cfg(str(tmp_path)), eval_only=True)
    assert eval_only.data_loader is None and not eval_only.model.training
