"""``ImageList`` and ``DefaultPredictor`` against the JAX package on the CPU.

- ``ImageList.from_tensors`` on seeded numpy images (and the port's on torch
  tensors) with and without divisibility and a static canvas: equal to
  JAX's padding.
- ``DefaultPredictor`` on a narrow R-50-FPN (tests/test_torch_rcnn.py's
  widths and weight scaling, POOLER_IMPL exact) from JAX's seeded weights
  through ``from_flax``, on a seeded 75x100 BGR image resized to the 96
  short side and padded to the 128x192 bucket: detections equal in
  validity and class, boxes to 1e-3 px and scores to 1e-4. JAX's predictor
  runs with ``INPUT.LOADER_S2D "off"`` (its s2d canvas pads with normalized
  zero pixels; the port has only the plain canvas). The predictor's batch,
  which the test loader's mapper makes, equals JAX's predictor's.
"""
import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from lvc_tpu.config import get_cfg as jax_get_cfg
from lvc_tpu.engine.defaults import DefaultPredictor as JaxDefaultPredictor
from lvc_tpu.engine.train_loop import TrainState
from lvc_tpu.modeling.meta_arch.build import build_model as jax_build_model
from lvc_tpu.solver.build import build_optimizer as jax_build_optimizer
from lvc_tpu.structures.image_list import ImageList as JaxImageList

from lvc_tpu_torch.checkpoint.convert import from_flax
from lvc_tpu_torch.config import get_cfg
from lvc_tpu_torch.data.dataset_mapper import read_image
from lvc_tpu_torch.engine.defaults import DefaultPredictor
from lvc_tpu_torch.modeling.meta_arch.build import build_model
from lvc_tpu_torch.structures import ImageList
from test_torch_context import _check_detections, _scale, _variables


@pytest.mark.parametrize("div,canvas", [(0, None), (32, None), (0, (64, 96)), (16, (50, 70))])
def test_image_list_matches_jax(div, canvas):
    rng = np.random.RandomState(1)
    images = [rng.rand(*hw, 3).astype(np.float32) for hw in ((30, 41), (47, 22), (33, 60))]
    want = JaxImageList.from_tensors(images, div, pad_value=-1.0, canvas=canvas)
    got = ImageList.from_tensors(images, div, pad_value=-1.0, canvas=canvas)
    assert isinstance(got.tensor, np.ndarray) and got.tensor.dtype == np.float32
    np.testing.assert_array_equal(got.tensor, np.asarray(want.tensor))
    np.testing.assert_array_equal(got.image_sizes, want.image_sizes)
    on_torch = ImageList.from_tensors([torch.from_numpy(x) for x in images], div, pad_value=-1.0, canvas=canvas)
    assert isinstance(on_torch.tensor, torch.Tensor) and len(on_torch) == 3
    np.testing.assert_array_equal(on_torch.tensor.numpy(), got.tensor)
    np.testing.assert_array_equal(on_torch.image_sizes, got.image_sizes)


def _narrow(cfg):
    cfg.merge_from_file("configs/Base-RCNN-FPN.yaml")
    cfg.merge_from_list([
        "MODEL.RESNETS.DEPTH", 50, "MODEL.RESNETS.RES2_OUT_CHANNELS", 64, "MODEL.RESNETS.WIDTH_PER_GROUP", 16,
        "MODEL.FPN.OUT_CHANNELS", 64, "MODEL.ROI_HEADS.NUM_CLASSES", 5, "MODEL.ROI_BOX_HEAD.FC_DIM", 128,
        "MODEL.ROI_HEADS.POOLER_IMPL", "exact", "MODEL.RPN.PRE_NMS_TOPK_TEST", 200,
        "MODEL.RPN.POST_NMS_TOPK_TEST", 100, "TEST.DETECTIONS_PER_IMAGE", 30, "INPUT.MIN_SIZE_TEST", 96,
        "INPUT.MAX_SIZE_TEST", 192, "PAD.CANVAS_BUCKETS", [[128, 192]], "INPUT.LOADER_S2D", "'off'",
    ])
    return cfg


def test_default_predictor_matches_jax(tmp_path):
    rng = np.random.RandomState(6)
    low = rng.randint(0, 256, (10, 13, 3)).astype(np.uint8)
    image = np.kron(low, np.ones((8, 8, 1), np.uint8))[:75, :100].copy()
    path = str(tmp_path / "img.jpg")
    Image.fromarray(image).save(path, quality=95)
    bgr = read_image(path, "BGR")

    jcfg = _narrow(jax_get_cfg())
    jmodel = jax_build_model(jcfg)
    var = _scale(_variables(jmodel, {"image": np.zeros((1, 128, 192, 3), np.float32),
                                     "image_size": np.array([[128, 192]], np.int32)}))
    state = TrainState.create(jax.tree_util.tree_map(jnp.asarray, var), jax_build_optimizer(jcfg, var["params"]))
    jpredictor = JaxDefaultPredictor(jcfg, state)
    want = jpredictor(bgr)

    cfg = _narrow(get_cfg())
    model = build_model(cfg, device="cpu")
    model.load_state_dict(from_flax(var))
    predictor = DefaultPredictor(cfg, model)
    got = predictor(bgr)
    assert got.masks is None and got.keypoints is None  # a box-only model
    _check_detections(type(got)(*[None if f is None else torch.from_numpy(f) for f in got]), want)

    # the predictor's batch (the test loader's mapper) is JAX's predictor's
    ex = jpredictor._map_array(bgr)
    batch = predictor.batch(bgr)
    np.testing.assert_array_equal(batch["image"][0], ex["image"])
    np.testing.assert_array_equal(batch["image_size"][0], ex["image_size"])
    assert tuple(batch["image_size"][0]) == (96, 128) and batch["image"].shape == (1, 128, 192, 3)


def test_default_predictor_builds_on_the_device_and_refuses_s2d():
    cfg = _narrow(get_cfg())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no GPU"):
            DefaultPredictor(cfg)
    seeded = DefaultPredictor(cfg, device="cpu")
    again = DefaultPredictor(cfg, device="cpu")
    for (name, a), b in zip(seeded.model.state_dict().items(), again.model.state_dict().values()):
        assert torch.equal(a, b), name
    assert seeded.model.backbone.bottom_up.res3[0].conv1.weight.std() > 0
    cfg.INPUT.LOADER_S2D = "on"
    with pytest.raises(NotImplementedError, match="space-to-depth"):
        DefaultPredictor(cfg, device="cpu")
