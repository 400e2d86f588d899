"""The port's ``knn_vote`` (``lvc_tpu_torch/ops/knn.py``) against the JAX
package's (``lvc_tpu/ops/knn.py``): top-k shot labels and modes equal on
every case, similarities within 1e-5 of a float64 reference. The clustered
cases keep the k-th and (k+1)-th similarities apart, so no vote sits on a
near-tie; the tie cases hold the tie rules (lowest shot index first in the
top-k, smallest class id for the mode)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lvc_tpu.ops.knn import knn_vote as jax_knn_vote
from lvc_tpu_torch.ops.knn import knn_vote, similarity


def _clustered(seed, n_shot, n_query, classes, dim=32, spread=0.3):
    rng = np.random.RandomState(seed)
    centers = rng.randn(classes, dim)
    s_lab = rng.randint(0, classes, n_shot)
    q_lab = rng.randint(0, classes, n_query)
    shots = (centers[s_lab] + rng.randn(n_shot, dim) * spread).astype(np.float32)
    queries = (centers[q_lab] + rng.randn(n_query, dim) * spread).astype(np.float32)
    return shots, s_lab.astype(np.int32), queries


def _ties():
    # 2 votes each for classes 1 and 3 -> the mode is 1; duplicated shots tie
    shots = np.array([[1.0, 0.0], [0.99, 0.01], [0.0, 1.0], [0.01, 0.99], [1.0, 0.0]], np.float32)
    labels = np.array([3, 1, 1, 3, 2], np.int32)
    queries = np.array([[0.7, 0.7], [1.0, 0.0], [0.0, 1.0]], np.float32)
    return shots, labels, queries


CASES = {
    # name: (data, k, cosine, num_classes)
    "cosine": (lambda: _clustered(0, 60, 40, 6), 10, True, 6),
    "euclid": (lambda: _clustered(1, 50, 30, 5), 5, False, 5),
    "ties_euclid": (_ties, 4, False, 5),
    "ties_cosine": (_ties, 2, True, 5),
    "k_over_gallery": (lambda: _clustered(2, 7, 20, 4), 10, True, 4),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_knn_vote_matches_jax(case):
    make, k, cosine, num_classes = CASES[case]
    shots, labels, queries = make()
    want_topk, want_mode = jax_knn_vote(
        jnp.asarray(shots), jnp.asarray(labels), jnp.asarray(queries),
        k=k, cosine=cosine, num_classes=num_classes,
    )
    topk, mode = knn_vote(
        torch.from_numpy(shots), torch.from_numpy(labels), torch.from_numpy(queries),
        k=k, cosine=cosine, num_classes=num_classes,
    )
    assert topk.shape == (len(queries), min(k, len(shots)))
    np.testing.assert_array_equal(topk.numpy(), np.asarray(want_topk))
    np.testing.assert_array_equal(mode.numpy(), np.asarray(want_mode))


def test_mode_ties_to_smallest_class():
    shots, labels, queries = _ties()
    _, mode = knn_vote(torch.from_numpy(shots), torch.from_numpy(labels), torch.from_numpy(queries[:1]),
                       k=4, cosine=False, num_classes=5)
    assert int(mode[0]) == 1


@pytest.mark.parametrize("cosine", [True, False])
def test_similarity_matches_float64(cosine):
    shots, _, queries = _clustered(3, 40, 25, 5)
    s, q = shots.astype(np.float64), queries.astype(np.float64)
    if cosine:
        c = s.mean(0, keepdims=True)
        s, q = s - c, q - c
        s /= np.linalg.norm(s, axis=-1, keepdims=True) + 1e-8
        q /= np.linalg.norm(q, axis=-1, keepdims=True) + 1e-8
        want = q @ s.T
    else:
        want = -((q ** 2).sum(-1)[:, None] - 2 * q @ s.T + (s ** 2).sum(-1)[None])
    got = similarity(torch.from_numpy(shots), torch.from_numpy(queries), cosine).double().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
