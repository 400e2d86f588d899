"""The fine-tune path of ``tools/train_net.py`` in the port against JAX's CLI on
the CPU, and the box head's dropout.

Both CLIs train ``faster_rcnn_R_50_FPN_ft_novel_30shot.yaml`` (20 novel
classes; backbone, RPN and box head frozen) and
``faster_rcnn_R_50_FPN_ft_all_30shot_aug_ftmore_dropout.yaml`` (80 classes,
``CosineSimOutputLayers``, backbone frozen, mosaic 0.5 of 9 tiles, crop 0.7,
colour jitter) as they stand, narrowed (64-wide res2 and FPN, FC 64,
exhaustive sampling, one loader worker, 96-pixel images) and with
``ROI_BOX_HEAD.DROPOUT`` 0 (dropout masks cannot match across frameworks;
its behaviour is tested below), for 3 iterations on ``chip_smoke.write_chain_tree``'s tree.
Their ``MODEL.WEIGHTS`` are the port's surgery outputs, as coco_full_run
steps 2 and 4 make them: ``remove`` of a seeded 60-class base detector, and
``combine`` of it with a seeded 20-class novel one (its classifier bias is
reported as unexpected by the cosine head, not refused). Both trainers start
from the same initial weights (JAX's he-init carried by ``from_flax``;
the checkpoint loads on top). JAX's partial load drops the combined
classifier of a cosine head (a classifier with a bias maps to
``cls_score/kernel``, which the cosine head has not); the port loads it, as
detectron2 does, so the test gives JAX's initial cosine weight the combined
one.

Tolerances: each iteration's losses within rel 1e-5; after the last
iteration every trainable tensor within rel L2 1e-5 of JAX's and within
1e-3 of its own update's norm, every frozen tensor equal to its start bit
for bit (the port skips the frozen backward that JAX computes and masks).

Also: with the backbone frozen the training pool's backward (K3 on the
card) never runs, and it runs once a step when the backbone trains
(``POOLER_IMPL pallas_train``, counted on the CPU at its plain version); and
``ROI_BOX_HEAD.DROPOUT`` drops only in training, at the rate given, scaling
what it keeps by 1 / (1 - p) as flax does.
"""
import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from lvc_tpu.config import get_cfg as jax_get_cfg
from lvc_tpu.data import builtin as jax_builtin
from lvc_tpu.data import catalog as jax_catalog
from lvc_tpu.engine.defaults import default_argument_parser as jax_parser
from lvc_tpu.modeling.meta_arch.build import build_model as jax_build_model
from lvc_tpu.modeling.roi_heads.box_head import FastRCNNConvFCHead as JaxHead
from lvc_tpu.utils.init import materialize_variables
from lvc_tpu_torch.checkpoint.convert import from_flax, to_flax
from lvc_tpu_torch.config import get_cfg
from lvc_tpu_torch.engine.defaults import default_argument_parser
from lvc_tpu_torch.engine.train_loop import make_train_step
from lvc_tpu_torch.modeling.meta_arch.build import build_model
from lvc_tpu_torch.modeling.roi_heads.box_head import FastRCNNConvFCHead
from lvc_tpu_torch.ops import roi_align
from lvc_tpu_torch.solver.build import build_lr_schedule, build_optimizer
from lvc_tpu_torch.tools import ckpt_surgery, coco_full_run, train_net

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAML = {n: os.path.join(REPO, "configs", "COCO-detection", f"faster_rcnn_R_50_FPN_{n}.yaml")
        for n in ("base", "ft_novel_30shot", "ft_all_30shot_aug_ftmore_dropout")}
ITERS = 3
NARROW = [
    "MODEL.RESNETS.RES2_OUT_CHANNELS", "64", "MODEL.RESNETS.WIDTH_PER_GROUP", "16",
    "MODEL.FPN.OUT_CHANNELS", "64", "MODEL.ROI_BOX_HEAD.FC_DIM", "64", "MODEL.ROI_BOX_HEAD.DROPOUT", "0.0",
    "MODEL.ROI_HEADS.POOLER_IMPL", "exact",
    "MODEL.RPN.PRE_NMS_TOPK_TRAIN", "200", "MODEL.RPN.POST_NMS_TOPK_TRAIN", "100",
    "MODEL.RPN.BATCH_SIZE_PER_IMAGE", "8192", "MODEL.RPN.POSITIVE_FRACTION", "0.999",
    "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", "128", "MODEL.ROI_HEADS.POSITIVE_FRACTION", "0.999",
    "INPUT.LOADER_S2D", "'off'", "INPUT.MIN_SIZE_TRAIN", "(96,)", "INPUT.MAX_SIZE_TRAIN", "128",
    "PAD.CANVAS_BUCKETS", "[[128, 128]]", "PAD.MAX_GT_PER_IMAGE", "12",
    "DATALOADER.NUM_WORKERS", "1", "SOLVER.IMS_PER_BATCH", "2", "SOLVER.MAX_ITER", str(ITERS),
    "SOLVER.CHECKPOINT_PERIOD", "100", "DATASETS.TEST", "()", "SEED", "3",
]


def _use_jax(root):
    for name in jax_catalog.DatasetCatalog.list():
        if name.startswith("coco_"):
            jax_catalog.DatasetCatalog.remove(name)
    jax_builtin.register_all_coco(root)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("datasets"))
    chip_smoke.write_chain_tree(root, 8, 2, 1, sizes=((96, 128), (128, 96)), seed=6, max_boxes=6)
    saved = os.environ.get("DETECTRON2_DATASETS")
    coco_full_run.use_datasets(root)
    _use_jax(root)
    yield root
    original = saved or "datasets"
    coco_full_run.use_datasets(original)
    _use_jax(original)
    if saved is None:
        os.environ.pop("DETECTRON2_DATASETS")


def _variables(name, seed):
    """JAX's he-init variables of the narrowed config, scaled as in
    tests/test_torch_trainer.py (no near-ties in the RPN's NMS)."""
    cfg = jax_get_cfg()
    cfg.merge_from_file(YAML[name])
    cfg.merge_from_list(NARROW)
    model = jax_build_model(cfg)
    batch = {"image": jnp.zeros((1, 128, 128, 3)), "image_size": jnp.asarray([[96, 128]], np.int32)}
    shapes = jax.eval_shape(functools.partial(model.init, train=False), {"params": jax.random.PRNGKey(0)}, batch)
    var = jax.tree_util.tree_map(np.array, materialize_variables(shapes, seed=seed, conv_init="he"))
    for block in var["params"]["backbone"]["bottom_up"].values():
        for leaf in jax.tree_util.tree_leaves(block):
            if leaf.ndim == 4:
                leaf *= 0.7
    rpn = var["params"]["proposal_generator"]["rpn_head"]
    rpn["conv"]["conv"]["kernel"] *= 0.1
    rpn["objectness_logits"]["conv"]["kernel"] *= 0.1
    rpn["anchor_deltas"]["conv"]["kernel"] *= 0.01
    pred = var["params"]["roi_heads"]["box_predictor"]
    if "cls_score" in pred:
        pred["cls_score"]["kernel"] *= 0.03
    pred["bbox_pred"]["kernel"] *= 0.3
    return var


def _save(var, path):
    torch.save({"model": from_flax(var), "iteration": 0}, path)
    return path


@pytest.fixture(scope="module")
def weights(tree, tmp_path_factory):
    d = tmp_path_factory.mktemp("weights")
    base = _save(_variables("base", 1), str(d / "base.pth"))
    novel = _save(_variables("ft_novel_30shot", 2), str(d / "novel.pth"))
    remove = ckpt_surgery.main(ckpt_surgery.parser.parse_args(
        ["--method", "remove", "--coco", "--src1", base, "--save-dir", str(d)]))
    combine = ckpt_surgery.main(ckpt_surgery.parser.parse_args(
        ["--method", "combine", "--coco", "--src1", base, "--src2", novel, "--save-dir", str(d)]))
    return {"ft_novel_30shot": remove, "ft_all_30shot_aug_ftmore_dropout": combine}


def _flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("name", ["ft_novel_30shot", "ft_all_30shot_aug_ftmore_dropout"])
def test_finetune_cli_matches_jax_cli(tree, weights, tmp_path, monkeypatch, capsys, name):
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import train_net as jax_cli
    finally:
        sys.path.pop(0)
    init = _variables(name, 3)
    cosine = "ft_all" in name
    if cosine:
        # JAX's partial load maps a classifier with a bias to cls_score/kernel, so its cosine head drops the
        # combined classifier (cls_score_weight keeps its init); the port loads it as detectron2 does. Both
        # start from it here.
        ckpt = torch.load(weights[name], weights_only=False)["model"]
        init["params"]["roi_heads"]["box_predictor"]["cls_score_weight"] = \
            ckpt["roi_heads.box_predictor.cls_score.weight"].numpy().T.copy()
    monkeypatch.setattr(jax_cli.Trainer, "_materialize",
                        lambda self, shapes, seed: jax.tree_util.tree_map(np.array, init))
    monkeypatch.setattr(train_net.Trainer, "_materialize",
                        lambda self, model, seed: model.load_state_dict(from_flax(init)))
    trainers = {}
    for side, cli, parser in (("jax", jax_cli, jax_parser), ("port", train_net, default_argument_parser)):
        cls = cli.Trainer
        monkeypatch.setattr(cls, "train", lambda self, cls=cls, side=side: (
            trainers.__setitem__(side, self), super(cls, self).train())[1])
        extra = ["MODEL.DEVICE", "cpu"] if side == "port" else []
        cli.main(parser().parse_args(["--config-file", YAML[name], *NARROW, *extra, "OUTPUT_DIR",
                                      str(tmp_path / side), "MODEL.WEIGHTS", weights[name]]))
    log = capsys.readouterr().out
    assert ("unexpected key in model: roi_heads.box_predictor.cls_score.bias" in log) == cosine
    assert ("missing key in params (kept init): roi_heads/box_predictor/cls_score_weight" in log) == cosine
    # the port loads the combined classifier into the cosine head; the remove checkpoint has none
    assert ("missing key in model (kept init): roi_heads.box_predictor.cls_score.weight" in log) != cosine
    jt, pt = trainers["jax"], trainers["port"]
    assert pt.cfg.INPUT.MOSAIC == (0.5 if cosine else 0.0)
    for k in ("loss_rpn_cls", "loss_rpn_loc", "loss_cls", "loss_box_reg", "total_loss"):
        got, want = list(pt.storage.histories()[k]._deque), list(jt.storage.histories()[k]._deque)
        assert len(got) == len(want) == ITERS, k
        for g, w in zip(got, want):
            assert g == pytest.approx(w, rel=1e-5), (k, got, want)

    start = _flat(to_flax(from_flax(init))["params"])
    start.update(_flat(to_flax(torch.load(weights[name], weights_only=False)["model"])["params"]))
    got = _flat(to_flax(pt.model.state_dict())["params"])
    want = _flat(jax.tree_util.tree_map(np.asarray, jt.state.params))
    assert set(got) == set(want)
    trainable = {n for n, p in pt.model.named_parameters() if p.requires_grad}
    assert trainable and not any(n.startswith("backbone.") for n in trainable)
    n_trained = 0
    for path, w in want.items():
        if np.array_equal(w, start[path]):
            np.testing.assert_array_equal(got[path], w, err_msg=path)  # frozen, or never reached
            continue
        n_trained += 1
        g = got[path].astype(np.float64)
        assert np.linalg.norm(g - w) <= 1e-5 * np.linalg.norm(w), path
        assert np.linalg.norm(g - w) <= 1e-3 * np.linalg.norm(w - start[path]), path
    assert n_trained == len([n for n in trainable if "norm" not in n])


@pytest.mark.parametrize("freeze", [True, False])
def test_frozen_backbone_skips_the_pool_backward(freeze, monkeypatch):
    cfg = get_cfg()
    cfg.merge_from_file(YAML["ft_all_30shot_aug_ftmore_dropout"])
    cfg.merge_from_list(NARROW)
    cfg.MODEL.ROI_HEADS.POOLER_IMPL = "pallas_train"
    cfg.MODEL.BACKBONE.FREEZE = freeze
    model = build_model(cfg, device="cpu")
    model.load_state_dict(from_flax(_variables("ft_all_30shot_aug_ftmore_dropout", 4)))
    model.train()
    opt = build_optimizer(cfg, model)
    calls = []
    real = roi_align.roi_align_paired_bwd
    monkeypatch.setattr(roi_align, "roi_align_paired_bwd", lambda *a: calls.append(1) or real(*a))
    step = make_train_step(model, opt, build_lr_schedule(cfg, opt))
    rng = np.random.RandomState(0)
    batch = {"image": torch.from_numpy((rng.rand(2, 128, 128, 3) * 255).astype(np.float32)),
             "image_size": torch.tensor([[96, 128], [128, 96]], dtype=torch.int32),
             "gt_boxes": torch.tensor([[[10.0, 12, 60, 70], [40, 30, 90, 80]]] * 2),
             "gt_classes": torch.tensor([[3, 41], [0, 77]], dtype=torch.int32),
             "gt_valid": torch.ones(2, 2, dtype=torch.bool)}
    for _ in range(2):
        step(batch, torch.Generator().manual_seed(0))
    assert len(calls) == (0 if freeze else 2)


def test_box_head_dropout():
    """Inverted dropout after each fc's ReLU: the identity in eval mode and
    at rate 0; in training it zeroes about p of the activations and scales
    the rest by exactly 1 / (1 - p), so the mean is kept. JAX's head (flax
    ``nn.Dropout``) does the same (its masks are its own)."""
    x = torch.from_numpy(np.random.RandomState(0).normal(0, 1, (64, 7, 7, 8)).astype(np.float32))
    head = FastRCNNConvFCHead(8, 7, num_fc=1, fc_dim=256, dropout=0.5)
    plain = FastRCNNConvFCHead(8, 7, num_fc=1, fc_dim=256, dropout=0.0)
    plain.load_state_dict(head.state_dict())
    want = plain.eval()(x)
    torch.testing.assert_close(head.eval()(x), want, rtol=0, atol=0)
    torch.testing.assert_close(plain.train()(x), want, rtol=0, atol=0)
    head.train()
    torch.manual_seed(0)
    outs = torch.stack([head(x) for _ in range(200)])
    on = want > 0
    kept = outs != 0
    assert not kept[:, ~on].any()
    torch.testing.assert_close(outs[kept], (2 * want).expand_as(outs)[kept], rtol=0, atol=0)
    rate = 1 - kept[:, on].float().mean().item()
    assert abs(rate - 0.5) < 0.01
    assert (outs.mean(0)[on] / want[on]).mean().item() == pytest.approx(1.0, abs=0.02)

    jhead = JaxHead(num_conv=0, num_fc=1, fc_dim=256, dropout=0.5)
    jx = jnp.asarray(x.numpy())
    variables = jhead.init(jax.random.PRNGKey(0), jx, train=False)
    j_eval = np.asarray(jhead.apply(variables, jx, train=False))
    j_train = np.asarray(jhead.apply(variables, jx, train=True, rngs={"dropout": jax.random.PRNGKey(1)}))
    j_kept = j_train != 0
    np.testing.assert_array_equal(j_train[j_kept], 2 * j_eval[j_kept])
    assert abs(1 - j_kept[j_eval > 0].mean() - 0.5) < 0.02
