"""Data parallelism of the fine-tune configurations on the CPU: 2 gloo ranks
(``engine/launch.py``, ``devices=["cpu", "cpu"]``), through ``chip_smoke``'s
phase-23 helpers with the CPU's plain pool (POOLER_IMPL exact).

- ``ft_novel``: phase 23's narrow detector (sampling not exhaustive) with
  ``faster_rcnn_R_50_FPN_ft_novel_30shot.yaml``'s frozen backbone and RPN,
  20 classes, and the cosine head with the learnable scale;
  ``parallel``: the same detector with ``ParallelStandardROIHeads`` (80
  classes; two sampling calls an image, base then novel). One step of 2
  ranks on a global batch of 4 equals the one-process step at
  tests/test_torch_ddp.py's tolerances (losses rel 2e-4 / abs 1e-5, every
  trainable gradient rel L2 1e-5, the parameters after the step within 1e-5
  of the update, each image's slots equal: ``chip_smoke.dp_compare``).
- ``ft_all``'s ``ROI_BOX_HEAD.DROPOUT`` 0.5 on tests/test_torch_train.py's
  narrow model (exhaustive sampling): the dropout masks fold in the rank in
  both packages (``lvc_tpu/engine/train_loop.py:63-66``), so a 2-rank step
  differs from one process and is held to JAX's 2-device
  ``make_data_parallel_train_step`` instead. Torch cannot draw JAX's
  masks, so the test records JAX's own: each device's sampled boxes and
  its two dropout outputs, taken inside the shard_map step by
  ``jax.debug.callback``. Each rank applies its device's masks, matched to
  its own sampled rows by box (the two samplers order the same set
  differently). Every loss then agrees with JAX's within rel 2e-4 on both
  ranks (tests/test_torch_ddp_jax.py), and the masks differ between the
  ranks.
"""
import os

import numpy as np
import pytest
import torch

import chip_smoke
from lvc_tpu_torch.checkpoint.convert import from_flax
from lvc_tpu_torch.config import get_cfg
from lvc_tpu_torch.engine.launch import launch
from test_torch_train import _batch, _narrow, _variables

FT_NOVEL_YAML = "configs/COCO-detection/faster_rcnn_R_50_FPN_ft_novel_30shot.yaml"
SEED = 7


def _cfg(kind):
    cfg = chip_smoke.dp_cfg("detector", "cpu", impl="exact")
    if kind == "ft_novel":
        ft = get_cfg()
        ft.merge_from_file(FT_NOVEL_YAML)
        cfg.MODEL.BACKBONE.FREEZE = ft.MODEL.BACKBONE.FREEZE
        cfg.MODEL.PROPOSAL_GENERATOR.FREEZE = ft.MODEL.PROPOSAL_GENERATOR.FREEZE
        cfg.MODEL.ROI_HEADS.NUM_CLASSES = ft.MODEL.ROI_HEADS.NUM_CLASSES
        cfg.MODEL.ROI_HEADS.OUTPUT_LAYER = "CosineSimOutputLayers"
        cfg.MODEL.ROI_HEADS.COSINE_SCALE = -1.0
    else:
        cfg.MODEL.ROI_HEADS.NAME = "ParallelStandardROIHeads"
        cfg.MODEL.ROI_HEADS.NUM_CLASSES = 80
    return cfg


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("ranks"))
    jobs, refs = [], {}
    for kind in ("ft_novel", "parallel"):
        cfg = _cfg(kind)
        weights, batch = chip_smoke.dp_inputs("detector", cfg)
        jobs.append((kind, cfg, weights, batch, chip_smoke.DP_SEED))
        refs[kind] = (chip_smoke.dp_step(cfg, weights, batch, chip_smoke.DP_SEED, data_parallel=False), weights)
    launch(chip_smoke.dp_rank_main, 2, args=(out, jobs), devices=["cpu", "cpu"])
    return out, refs


@pytest.mark.parametrize("kind", ["ft_novel", "parallel"])
def test_two_ranks_equal_one_process(runs, kind):
    out, refs = runs
    ref, weights = refs[kind]
    ranks = chip_smoke.dp_load(out, kind, 2)
    err = chip_smoke.dp_compare(ref, ranks, weights)
    trainable = set(ref["grads"])
    if kind == "ft_novel":
        assert "roi_heads.box_predictor.scale" in trainable
        assert not any(n.startswith(("backbone.", "proposal_generator.")) for n in trainable)
        assert err["slots"] == 8  # 4 images: the frozen RPN still samples, and the ROI heads
    else:
        assert {k.split("_loss")[0] for k in ref["metrics"] if "_loss_" in k} == {"base", "novel"}
        assert err["slots"] == 12  # 4 images: one RPN and two ROI-head calls each


# ---------------------------------------------------------------- dropout


def _jax_dp_step_with_masks(variables, cfg):
    """JAX's 2-device step: its metrics and, per device, the sampled boxes
    and validity of its image and its two dropout outputs."""
    import flax.linen as nn
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from lvc_tpu.engine.train_loop import TrainState, make_data_parallel_train_step, shard_batch
    from lvc_tpu.modeling.meta_arch.build import build_model as jax_build_model
    from lvc_tpu.modeling.roi_heads.roi_heads import StandardROIHeads
    from lvc_tpu.solver.build import build_optimizer as jax_build_optimizer

    model = jax_build_model(cfg)
    records = {}

    def record(device, boxes, valid, drop1, drop2):
        records[int(device)] = [np.asarray(a) for a in (boxes, valid, drop1, drop2)]

    class Recording:
        """The model for ``make_train_step``: its ``apply`` also sends the
        ROI heads' sampled slots and the dropout outputs to the host."""

        def apply(self, variables, batch, **kwargs):
            losses, state = model.apply(
                variables, batch, **kwargs, mutable=["intermediates"],
                capture_intermediates=lambda mdl, name: name == "__call__" and isinstance(
                    mdl, (nn.Dropout, StandardROIHeads)))
            heads = state["intermediates"]["roi_heads"]
            sampled = heads["__call__"][0][1]
            drops = [heads["box_head"][f"Dropout_{k}"]["__call__"][0] for k in range(2)]
            jax.debug.callback(record, jax.lax.axis_index("data"), sampled.boxes, sampled.valid, *drops)
            return losses

    tx = jax_build_optimizer(cfg, variables["params"])
    state = TrainState.create(jax.tree_util.tree_map(jnp.asarray, variables), tx)
    mesh = Mesh(np.array(jax.devices()[:2]), axis_names=("data",))
    step = make_data_parallel_train_step(Recording(), tx, mesh)
    with mesh:
        _, metrics = step(state, shard_batch({k: jnp.asarray(v) for k, v in _batch().items()}, mesh),
                          jax.random.PRNGKey(SEED))
        jax.effects_barrier()
    return {k: float(v) for k, v in metrics.items()}, records


def _rows_of(port_boxes, port_valid, jax_boxes, jax_valid):
    """For each of the port's sampled rows, the JAX row that holds the same
    box (the nearest, within 1e-3 px; one to one). Rows of empty slots take
    an empty JAX row."""
    idx = torch.zeros(len(port_boxes), dtype=torch.long)
    free = list(np.flatnonzero(~jax_valid))
    jb = torch.from_numpy(jax_boxes)
    for i in range(len(port_boxes)):
        if not port_valid[i]:
            idx[i] = int(free.pop())
            continue
        d = (jb - port_boxes[i]).abs().amax(-1).masked_fill(torch.from_numpy(~jax_valid), float("inf"))
        j = int(d.argmin())
        if float(d[j]) > 1e-3:
            raise AssertionError(f"sampled box {port_boxes[i].tolist()} has no JAX counterpart ({float(d[j])})")
        idx[i] = j
    if len(set(idx[port_valid].tolist())) != int(port_valid.sum()):
        raise AssertionError("two sampled rows matched one JAX row")
    return idx


def dropout_rank_main(out_dir, cfg, weights, batch, records):
    """One rank of the dropout check: ``chip_smoke.dp_step`` on its share,
    with the ROI heads' dropout taking JAX's masks of the device that holds
    the same image."""
    import torch.nn.functional as F

    from lvc_tpu_torch.modeling.roi_heads import roi_heads as rh
    from lvc_tpu_torch.utils import comm

    rank, world = comm.get_rank(), comm.get_world_size()
    n = len(batch["image"]) // world
    share = {k: v[rank * n:(rank + 1) * n] for k, v in batch.items()}
    jax_boxes, jax_valid, *drops = records[rank]
    sampled, masks = [], [d != 0 for d in drops]
    sample, dropout = rh.StandardROIHeads.label_and_sample_proposals, F.dropout

    def recording_sample(self, *args, **kwargs):
        sampled.append(sample(self, *args, **kwargs))
        return sampled[-1]

    def jax_dropout(x, p=0.5, training=True, inplace=False):
        s = sampled[-1]
        rows = _rows_of(s.boxes.reshape(-1, 4), s.valid.reshape(-1), jax_boxes.reshape(-1, 4), jax_valid.reshape(-1))
        keep = torch.from_numpy(masks.pop(0).reshape(-1, x.shape[-1]))[rows]
        return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype))

    rh.StandardROIHeads.label_and_sample_proposals, F.dropout = recording_sample, jax_dropout
    try:
        result = chip_smoke.dp_step(cfg, weights, share, SEED, data_parallel=True)
    finally:
        rh.StandardROIHeads.label_and_sample_proposals, F.dropout = sample, dropout
    assert not masks, "the head did not take both masks"
    torch.save(result, os.path.join(out_dir, f"dropout_rank{rank}.pt"))


def test_dropout_step_matches_jax_data_parallel_step(tmp_path):
    import jax

    from lvc_tpu.config import get_cfg as jax_get_cfg
    from lvc_tpu.modeling.meta_arch.build import build_model as jax_build_model

    def ft_all_dropout(cfg):
        cfg = _narrow(cfg)
        cfg.MODEL.ROI_BOX_HEAD.DROPOUT = 0.5
        return cfg

    jcfg = ft_all_dropout(jax_get_cfg())
    variables = jax.tree_util.tree_map(np.asarray, _variables(jax_build_model(jcfg)))
    want, records = _jax_dp_step_with_masks(variables, jcfg)
    assert sorted(records) == [0, 1]
    for boxes, valid, d1, d2 in records.values():
        for d in (d1, d2):
            assert 0.15 < float((d != 0).mean()) < 0.4  # about half of the ReLU's nonzero half kept
    assert not np.array_equal(records[0][2] != 0, records[1][2] != 0)  # the rank is folded in

    cfg = ft_all_dropout(get_cfg())
    cfg.MODEL.DEVICE = "cpu"
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    launch(dropout_rank_main, 2, args=(str(tmp_path), cfg, from_flax(variables), batch, records),
           devices=["cpu", "cpu"])
    ranks = chip_smoke.dp_load(str(tmp_path), "dropout", 2)
    assert want["loss_box_reg"] > 0
    for r in ranks:
        assert set(r["metrics"]) == set(want)
        for k, v in want.items():
            assert r["metrics"][k] == pytest.approx(v, rel=2e-4), (k, r["metrics"][k], v)
