"""The four names that ported files lacked, against the JAX package on the CPU:
``generate_rotated_cell_anchors`` and ``RotatedAnchorGenerator``
(``modeling/anchors.py``) abs 1e-5 of the largest value; ``ASPP``
(``modeling/layers.py``, flax's weights by ``from_flax``, on
``tests/test_d2_surface.py::test_aspp_shapes``' shapes and with GroupNorm)
abs 1e-5 of the largest output; ``DatasetEvaluators`` merges equal results
and refuses a key twice, as JAX's; ``get_event_storage`` returns the innermost
open storage, as JAX's."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lvc_tpu.evaluation.evaluator import DatasetEvaluators as JaxEvaluators
from lvc_tpu.modeling import anchors as janchors
from lvc_tpu.modeling.layers import ASPP as JaxASPP
from lvc_tpu.utils import events as jevents
from lvc_tpu_torch.checkpoint.convert import from_flax
from lvc_tpu_torch.evaluation.evaluator import DatasetEvaluators
from lvc_tpu_torch.modeling import anchors as panchors
from lvc_tpu_torch.modeling.layers import ASPP
from lvc_tpu_torch.utils import events as pevents


def _close(got, want, rel=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=rel * np.abs(want).max())


@pytest.mark.parametrize("angles", [(-90, -60, -30, 0, 30, 60, 90), (-45, 0, 45)])
def test_rotated_anchors_match_jax(angles):
    _close(panchors.generate_rotated_cell_anchors((16, 40), (0.5, 1.0, 2.0), angles),
           janchors.generate_rotated_cell_anchors((16, 40), (0.5, 1.0, 2.0), angles))
    args = ([[32], [64], [128]], [[0.5, 1.0, 2.0]], [4, 8, 16])
    grids = [(6, 9), (3, 5), (2, 3)]
    got = panchors.RotatedAnchorGenerator(*args, angles=[angles], offset=0.5)
    want = janchors.RotatedAnchorGenerator(*args, angles=[angles], offset=0.5)
    assert got.num_anchors == want.num_anchors == [3 * len(angles)] * 3
    for g, w in zip(got.grid_anchors(grids, "cpu"), want.grid_anchors(grids)):
        assert g.shape == w.shape and g.shape[1] == 5
        _close(g.numpy(), w)


@pytest.mark.parametrize("norm, channels", [("", 4), ("GN", 32)])
def test_aspp_matches_jax(norm, channels):
    jm = JaxASPP(features=channels, dilations=(2, 4, 6), norm=norm)
    x = np.random.RandomState(0).randn(2, 16, 16, channels).astype(np.float32)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    want = jax.jit(jm.apply)(variables, jnp.asarray(x))
    m = ASPP(channels, channels, dilations=(2, 4, 6), norm=norm).eval()
    m.load_state_dict(from_flax(variables))
    got = m(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert tuple(got.shape) == (2, 16, 16, channels)
    _close(got.detach().numpy(), want)


class _Fixed:
    def __init__(self, result):
        self.result, self.seen = result, []

    def reset(self):
        self.seen = []

    def process_detections(self, dets, metas):
        self.seen.append((dets, metas))

    def evaluate(self):
        return self.result


def test_dataset_evaluators_merge_as_jax():
    results = [{"bbox": {"AP": 1.0}}, {}, {"segm": {"AP": 2.0}}]
    got = DatasetEvaluators([_Fixed(r) for r in results])
    want = JaxEvaluators([_Fixed(r) for r in results])
    for e in (got, want):
        e.reset()
        e.process_detections("dets", ["meta"])
    assert all(e.seen == [("dets", ["meta"])] for e in got._evaluators)
    assert got.evaluate() == want.evaluate() == {"bbox": {"AP": 1.0}, "segm": {"AP": 2.0}}
    for cls in (DatasetEvaluators, JaxEvaluators):
        with pytest.raises(AssertionError, match="duplicate metric key"):
            cls([_Fixed({"bbox": 1}), _Fixed({"bbox": 2})]).evaluate()


def test_get_event_storage_as_jax():
    for mod in (pevents, jevents):
        with pytest.raises(AssertionError):
            mod.get_event_storage()
        with mod.EventStorage(3) as outer:
            assert mod.get_event_storage() is outer
            with mod.EventStorage(7) as inner:
                assert mod.get_event_storage() is inner and inner.iter == 7
            assert mod.get_event_storage() is outer
        with pytest.raises(AssertionError):
            mod.get_event_storage()
