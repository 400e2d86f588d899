"""The port's matcher and sampler against the JAX package on the CPU.

``Matcher`` must equal JAX's exactly (indices and labels), with padded gt,
low-quality ties and no valid gt. ``subsample_labels`` draws its priorities
from a torch generator, which cannot reproduce ``jax.random``: its counts and
slot layout (positives, then negatives, then unfilled) are checked directly,
and its set of indices equals JAX's when the sampling is exhaustive.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from lvc_tpu.modeling.matcher import Matcher as JaxMatcher
from lvc_tpu.modeling.sampling import subsample_labels as jax_subsample_labels

from lvc_tpu_torch.modeling.matcher import Matcher
from lvc_tpu_torch.modeling.sampling import global_ratio, subsample_labels


def _quality(seed, M=6, N=300):
    rng = np.random.RandomState(seed)
    q = rng.uniform(0, 1, (M, N)).astype(np.float32)
    q[q < 0.4] = 0.0
    # ties: gt 0's best quality is shared by three predictions, gt 1's by two
    q[0, [3, 50, 200]] = 0.95
    q[1, [7, 8]] = q[1].max() + 0.01
    q[2, :] = 0.0  # a gt that overlaps nothing recruits nothing
    return q


@pytest.mark.parametrize("low_quality", [True, False])
@pytest.mark.parametrize(
    "valid",
    [[1, 1, 1, 1, 0, 0], [0, 0, 0, 0, 0, 0], [1, 0, 1, 0, 1, 1]],
    ids=["padded", "no_valid_gt", "holes"],
)
def test_matcher_matches_jax(low_quality, valid):
    q = _quality(0)
    v = np.array(valid, bool)
    args = ([0.3, 0.7], [0, -1, 1], low_quality)
    jm, jl = JaxMatcher(*args)(jnp.asarray(q), jnp.asarray(v))
    tm, tl = Matcher(*args)(torch.from_numpy(q), torch.from_numpy(v))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    if not v.any():
        assert (tl.numpy() == 0).all()  # every prediction gets labels[0]


def test_matcher_batched_equals_per_image():
    q = np.stack([_quality(1), _quality(2)])
    v = np.array([[1, 1, 1, 0, 0, 0], [1, 1, 1, 1, 1, 1]], bool)
    m = Matcher([0.5], [0, 1], allow_low_quality_matches=True)
    bm, bl = m(torch.from_numpy(q), torch.from_numpy(v))
    for b in range(2):
        im, il = m(torch.from_numpy(q[b]), torch.from_numpy(v[b]))
        assert torch.equal(bm[b], im) and torch.equal(bl[b], il)


def _labels(seed, n, p_pos, p_neg):
    rng = np.random.RandomState(seed)
    u = rng.uniform(0, 1, n)
    return np.where(u < p_pos, 1, np.where(u < p_pos + p_neg, 0, -1)).astype(np.int8)


@pytest.mark.parametrize(
    "n,num_samples,fraction,p_pos,p_neg",
    [(1000, 256, 0.5, 0.05, 0.6), (1000, 64, 0.25, 0.3, 0.6), (50, 128, 0.5, 0.2, 0.3)],
)
def test_subsample_counts_and_layout(n, num_samples, fraction, p_pos, p_neg):
    labels = _labels(0, n, p_pos, p_neg)
    idxs, is_pos, valid = subsample_labels(
        torch.from_numpy(labels), num_samples, fraction, torch.Generator().manual_seed(0)
    )
    n_pos = min(int((labels == 1).sum()), int(num_samples * fraction))
    n_neg = min(int((labels == 0).sum()), num_samples - n_pos)
    assert idxs.shape == is_pos.shape == valid.shape == (num_samples,)
    assert is_pos.numpy()[:n_pos].all() and not is_pos.numpy()[n_pos:].any()
    assert valid.numpy()[: n_pos + n_neg].all() and not valid.numpy()[n_pos + n_neg :].any()
    picked = idxs.numpy()
    assert (labels[picked[:n_pos]] == 1).all()
    assert (labels[picked[n_pos : n_pos + n_neg]] == 0).all()
    assert len(set(picked[: n_pos + n_neg])) == n_pos + n_neg  # no repeats
    # JAX's counts and layout are the same
    j_idxs, j_pos, j_valid = jax_subsample_labels(jax.random.PRNGKey(0), jnp.asarray(labels), num_samples, fraction)
    np.testing.assert_array_equal(np.asarray(j_pos), is_pos.numpy())
    np.testing.assert_array_equal(np.asarray(j_valid), valid.numpy())


def test_subsample_exhaustive_set_equals_jax():
    labels = _labels(1, 2000, 0.1, 0.5)
    num_samples = 4096  # >= n: every positive and negative is taken
    idxs, is_pos, valid = subsample_labels(
        torch.from_numpy(labels), num_samples, 0.999, torch.Generator().manual_seed(3)
    )
    j_idxs, j_pos, j_valid = jax_subsample_labels(jax.random.PRNGKey(3), jnp.asarray(labels), num_samples, 0.999)
    j_idxs, j_pos, j_valid = (np.asarray(x) for x in (j_idxs, j_pos, j_valid))
    np.testing.assert_array_equal(valid.numpy(), j_valid)
    np.testing.assert_array_equal(is_pos.numpy(), j_pos)
    v = valid.numpy()
    assert set(idxs.numpy()[is_pos.numpy()]) == set(j_idxs[j_pos]) == set(np.nonzero(labels == 1)[0])
    assert set(idxs.numpy()[v & ~is_pos.numpy()]) == set(j_idxs[j_valid & ~j_pos])
    assert set(idxs.numpy()[v]) == set(np.nonzero(labels >= 0)[0])


def test_subsample_generator_decides_and_repeats():
    labels = torch.from_numpy(_labels(2, 1000, 0.1, 0.6))
    a = subsample_labels(labels, 128, 0.25, torch.Generator().manual_seed(1))[0]
    b = subsample_labels(labels, 128, 0.25, torch.Generator().manual_seed(1))[0]
    c = subsample_labels(labels, 128, 0.25, torch.Generator().manual_seed(2))[0]
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_global_ratio_floors_the_denominator():
    num = torch.tensor(6.0)
    assert float(global_ratio(num, 4)) == 1.5
    assert float(global_ratio(num, torch.tensor(0))) == 6.0
