"""The port's label-verification path against the JAX package's: the crop
helper, image decoding, descriptor extraction, the kNN keep mask, and the CLI
(``lvc_tpu_torch/tools/run_nearest_neighbours.py`` against
``tools/run_nearest_neighbours.py``) on the same seeded mini COCO tree with
the same synthetic DINO checkpoint (``$DINO_WEIGHTS``).

The CLIs run DINO ViT-S/16 at full width in float32 (the JAX CLI never sets
a compute dtype), on the CPU, and every image's crops pad to a batch of 64,
so the tree holds six images.
"""
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from lvc_tpu.data import builtin as jax_builtin  # noqa: F401
from lvc_tpu.data import catalog as jax_catalog
from lvc_tpu.data.builtin_meta import _get_builtin_metadata as jax_meta
from lvc_tpu.data.dataset_mapper import read_image as jax_read_image
from lvc_tpu.data.meta_coco import register_meta_coco as jax_register
from lvc_tpu.data.utils import get_crops_qe as jax_get_crops_qe
from lvc_tpu.modeling.backbone import vit as jvit
from lvc_tpu.pipeline import verification as jver
from lvc_tpu_torch.checkpoint.convert import vit_from_flax
from lvc_tpu_torch.data import builtin  # noqa: F401
from lvc_tpu_torch.data import catalog as port_catalog
from lvc_tpu_torch.data.builtin_meta import _get_builtin_metadata as port_meta
from lvc_tpu_torch.data.dataset_mapper import read_image
from lvc_tpu_torch.data.meta_coco import register_meta_coco as port_register
from lvc_tpu_torch.data.utils import get_crops_qe
from lvc_tpu_torch.engine.defaults import default_argument_parser
from lvc_tpu_torch.modeling.backbone.vit import VisionTransformer, dino_vits16, random_init
from lvc_tpu_torch.pipeline.verification import DescriptorExtractor, build_dino, verify_candidates

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_get_crops_qe_bit_equal_to_jax():
    img = (np.random.RandomState(0).rand(100, 120, 3) * 255).astype(np.uint8)
    boxes = np.array(
        [[10, 10, 50, 30], [0, 0, 120, 100], [80, 60, 118, 98], [-20, 90, 30, 140], [55.4, 20.6, 57.1, 21.9]],
        np.float32,
    )
    for size, pk in ((224, 0.2), (64, 0.0)):
        want = jax_get_crops_qe(img, boxes, crop_size=size, pk=pk)
        got = get_crops_qe(img, boxes, crop_size=size, pk=pk)
        assert got.dtype == np.uint8 and got.shape == (5, size, size, 3)
        np.testing.assert_array_equal(got, want)
    assert get_crops_qe(img, np.zeros((0, 4), np.float32)).shape == (0, 224, 224, 3)


def test_read_image_equals_jax(tmp_path):
    from PIL import Image

    arr = (np.random.RandomState(1).rand(33, 47, 3) * 255).astype(np.uint8)
    path = str(tmp_path / "x.png")
    Image.fromarray(arr).save(path)
    for fmt in ("RGB", "BGR"):
        np.testing.assert_array_equal(read_image(path, fmt), jax_read_image(path, fmt))


# what the port registers on import, taken at collection: tests that run a
# tool in-process before this one (in the same worker) register its results
# file under its path
PORT_SPLITS_ON_IMPORT = frozenset(port_catalog.DatasetCatalog.list())
JAX_SPLITS_ON_IMPORT = frozenset(jax_catalog.DatasetCatalog.list())


def test_registration_matches_jax():
    """The port registers the JAX package's COCO and PASCAL VOC splits (6,149
    names) under the same names and metadata."""
    port = set(PORT_SPLITS_ON_IMPORT)
    assert len(port) == 6149 and port == JAX_SPLITS_ON_IMPORT
    for name in ("coco_test_novel", "coco_trainval_base", "coco_trainval_all_30shot_seed3", "voc_2007_test_all1",
                 "voc_2012_trainval_novel2_5shot_seed7", "voc_2007_trainval_base3", "voc_2012_trainval_all3_10shot"):
        want = jax_catalog.MetadataCatalog.get(name).as_dict()
        assert port_catalog.MetadataCatalog.get(name).as_dict() == want
    voc = port_catalog.MetadataCatalog.get("voc_2012_trainval_novel2_5shot_seed7")
    assert voc.evaluator_type == "pascal_voc" and voc.year == 2012 and len(voc.thing_classes) == 5


def test_descriptors_and_keep_mask_match_jax():
    """A narrow ViT (patch 16, dim 128, 2 heads, depth 2) through both
    extractors, padded batch 4 for 6 crops, then both keep masks."""
    jmodel = jvit.VisionTransformer(patch_size=16, embed_dim=128, depth=2, num_heads=2, attn_impl="einsum")
    variables = jax.tree_util.tree_map(
        np.asarray, jmodel.init({"params": jax.random.PRNGKey(1)}, jnp.zeros((1, 224, 224, 3)))
    )
    model = VisionTransformer(16, 128, 2, 2)
    model.load_state_dict(vit_from_flax(variables))
    mean, std = [103.53, 116.28, 123.675], [57.375, 57.12, 58.395]
    crops = (np.random.RandomState(2).rand(6, 224, 224, 3) * 255).astype(np.uint8)
    want = jver.DescriptorExtractor(jmodel, variables, mean, std, batch=4).embed_crops(crops)
    got = DescriptorExtractor(model, mean, std, batch=4).embed_crops(crops)
    assert got.shape == (6, 128) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)

    rng = np.random.RandomState(3)
    centers = rng.randn(4, 128) * 3
    s_cls, q_cls = rng.randint(0, 4, 40), rng.randint(0, 4, 30)
    shots = {"descriptors": (centers[s_cls] + rng.randn(40, 128)).astype(np.float32), "classes": s_cls}
    queries = {"descriptors": (centers[q_cls] + rng.randn(30, 128) * 2).astype(np.float32),
               "classes": rng.randint(0, 4, 30)}
    keep = verify_candidates(shots, queries, k=5, device="cpu")
    np.testing.assert_array_equal(keep, jver.verify_candidates(shots, queries, k=5))
    assert 0 < keep.sum() < len(keep)


def test_build_dino_loads_weights_and_targets_cuda(tmp_path, monkeypatch):
    sd = random_init(dino_vits16(), seed=5).state_dict()
    path = str(tmp_path / "w.pth")
    torch.save({"state_dict": dict(sd, **{"head.weight": torch.ones(4, 384)})}, path)
    model = build_dino("dino_vits16", weights_path=path, device="cpu")
    assert not model.training
    for k, v in model.state_dict().items():
        assert torch.equal(v, sd[k]), k
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no GPU"):
        build_dino("dino_vits16", weights_path=path)


@pytest.fixture
def mini_coco(tmp_path, monkeypatch):
    """The mini tree, registered in both packages' catalogs under the names
    the CLIs read (restored afterwards), with ``$DETECTRON2_DATASETS`` and
    ``$DINO_WEIGHTS`` pointing at it and at a synthetic DINO ViT-S/16."""
    root = str(tmp_path / "datasets")
    candidates = chip_smoke.write_mini_coco(root, seed=0)
    weights = str(tmp_path / "dino_vits16.pth")
    sd = random_init(dino_vits16(), seed=7).state_dict()
    torch.save(dict(sd, **{"head.weight": torch.ones(8, 384)}), weights)
    monkeypatch.setenv("DETECTRON2_DATASETS", root)
    monkeypatch.setenv("DINO_WEIGHTS", weights)
    saved = []
    for cat in (jax_catalog, port_catalog):
        for name, _ in chip_smoke.MINI_SPLITS:
            saved.append((cat, name, cat.DatasetCatalog._registry.get(name), cat.MetadataCatalog._registry.pop(name, None)))
    chip_smoke.register_mini_coco(root, jax_catalog.DatasetCatalog, jax_register, jax_meta("coco_fewshot"))
    chip_smoke.register_mini_coco(root, port_catalog.DatasetCatalog, port_register, port_meta("coco_fewshot"))
    yield root, candidates
    for cat, name, fn, meta in saved:
        cat.DatasetCatalog._registry.pop(name, None)
        cat.MetadataCatalog._registry.pop(name, None)
        if fn is not None:
            cat.DatasetCatalog._registry[name] = fn
        if meta is not None:
            cat.MetadataCatalog._registry[name] = meta


def _run_cli(main, args, candidates):
    main(args)
    result = candidates.replace(".json", "_dino_vits16_03_cosine.json")
    with open(result) as f:
        data = json.load(f)
    os.remove(result)  # both CLIs write the same file name
    return data


def test_cli_matches_jax_cli(mini_coco):
    root, candidates = mini_coco
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import run_nearest_neighbours as jax_cli
    finally:
        sys.path.pop(0)
    from lvc_tpu.engine.defaults import default_argument_parser as jax_parser
    from lvc_tpu_torch.tools import run_nearest_neighbours as port_cli

    jax_args = jax_parser().parse_args(chip_smoke.cli_args(root, candidates, os.path.join(root, "jax")))
    want = _run_cli(jax_cli.main, jax_args, candidates)
    port_args = default_argument_parser().parse_args(
        chip_smoke.cli_args(root, candidates, os.path.join(root, "port")) + ["MODEL.DEVICE", "cpu"]
    )
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    try:
        got = _run_cli(port_cli.main, port_args, candidates)
        # the CLI's float32 verifier: no TF32 on the card for its convolution or matmuls
        assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == (False, False)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    kept =sorted(a["id"] for a in got["annotations"])
    assert kept == sorted(a["id"] for a in want["annotations"])
    assert sorted(im["id"] for im in got["images"]) == sorted(im["id"] for im in want["images"])
    n_cands = len(json.load(open(candidates))["annotations"])
    assert 0 < len(kept) < n_cands
