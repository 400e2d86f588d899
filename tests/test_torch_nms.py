"""The port's NMS and masked top-k against the JAX package, on seeded random
box sets with exact score ties (as bf16 serving logits produce) and padding.
The keep masks and orders must be equal: both sides compute the same IoUs in
float32 and break ties toward the lower index."""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from lvc_tpu.ops import nms as jnms
from lvc_tpu_torch.ops import nms as tnms


def _boxes(rng, n, clustered):
    if clustered:  # heavy overlap: long suppression chains
        c = rng.uniform(40, 60, (n, 2))
        wh = rng.uniform(20, 30, (n, 2))
    else:
        c = rng.uniform(0, 200, (n, 2))
        wh = rng.uniform(2, 60, (n, 2))
    return np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)


def _scores(rng, n, ties):
    s = rng.randn(n).astype(np.float32)
    if ties:  # few distinct values, as bf16-rounded logits
        s = np.round(s * 4) / 4
    return s


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("clustered", [False, True])
@pytest.mark.parametrize("ties", [False, True])
def test_nms_mask_matches_jax(seed, clustered, ties):
    rng = np.random.RandomState(seed)
    n = 300
    boxes = _boxes(rng, n, clustered)
    scores = _scores(rng, n, ties)
    valid = rng.rand(n) > 0.1
    for thr in (0.5, 0.7):
        want = np.asarray(jnms.nms_mask(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid), thr))
        got = tnms.nms_mask(torch.from_numpy(boxes), torch.from_numpy(scores), torch.from_numpy(valid), thr)
        np.testing.assert_array_equal(got.numpy(), want)


def test_nms_mask_batched_leading_dims():
    """One call over (B, L) sets equals the per-set JAX calls."""
    rng = np.random.RandomState(5)
    boxes = np.stack([_boxes(rng, 128, c) for c in (True, False, True, False)]).reshape(2, 2, 128, 4)
    scores = _scores(rng, 512, True).reshape(2, 2, 128)
    valid = (rng.rand(2, 2, 128) > 0.2)
    got = tnms.nms_mask(torch.from_numpy(boxes), torch.from_numpy(scores), torch.from_numpy(valid), 0.6)
    for i in range(2):
        for j in range(2):
            want = jnms.nms_mask(jnp.asarray(boxes[i, j]), jnp.asarray(scores[i, j]), jnp.asarray(valid[i, j]), 0.6)
            np.testing.assert_array_equal(got[i, j].numpy(), np.asarray(want))


@pytest.mark.parametrize("ties", [False, True])
def test_batched_nms_mask_matches_jax(ties):
    rng = np.random.RandomState(2)
    n = 256
    boxes = _boxes(rng, n, True)
    scores = _scores(rng, n, ties)
    idxs = rng.randint(0, 4, n).astype(np.int32)
    valid = rng.rand(n) > 0.1
    want = jnms.batched_nms_mask(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(idxs), jnp.asarray(valid), 0.5)
    got = tnms.batched_nms_mask(
        torch.from_numpy(boxes), torch.from_numpy(scores), torch.from_numpy(idxs), torch.from_numpy(valid), 0.5
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("k", [10, 100, 300, 500])
def test_masked_topk_matches_jax(k):
    """Ties break toward the lower index: ``jnp.argsort(-neg, stable=True)[:k]``,
    the order ``lvc_tpu.ops.nms.masked_topk`` documents. ``jax.lax.top_k`` on
    XLA:CPU keeps that order only for the first 128 slots (ROADMAP.md, "Faults
    found"), so beyond k=128 the JAX reference is the stable argsort."""
    rng = np.random.RandomState(3)
    scores = _scores(rng, 400, True)
    valid = rng.rand(400) > 0.3
    t_order, t_valid = tnms.masked_topk(torch.from_numpy(scores), torch.from_numpy(valid), k)
    if k <= 128:
        j_order, j_valid = jnms.masked_topk(jnp.asarray(scores), jnp.asarray(valid), k)
    else:
        neg = jnp.where(jnp.asarray(valid), jnp.asarray(scores), jnms.NEG_INF)
        j_order = jnp.argsort(-neg, stable=True)[: min(k, 400)]
        j_valid = jnp.asarray(valid)[j_order]
    np.testing.assert_array_equal(t_order.numpy(), np.asarray(j_order))
    np.testing.assert_array_equal(t_valid.numpy(), np.asarray(j_valid))
