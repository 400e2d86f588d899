"""Feature clustering, PCA whitening + L2 + k-means: the port of
``lvc_tpu/data/cluster/clustering.py`` (``preprocess_features``:18,
``run_kmeans``:72, ``Kmeans``:88; lvc/data/cluster/clustering.py:1-96, the
reference's only faiss dependency).

Torch tensors on an explicit device: the PCA through ``torch.linalg.eigh``
of the float32 covariance (eigenvalues descending, each component scaled by
``rsqrt(eigenvalue + eps)``), then L2 rows; k-means as Lloyd's iterations
whose assignment step is one (N, D) x (D, K) product (JAX computes it in
XLA, not in Pallas, so ``torch.matmul`` is the counterpart) and whose update
sums each cluster's rows. The initial centroids are distinct rows drawn by
``torch.randperm`` from an explicit ``torch.Generator``; ``eigh`` fixes no
sign, so a component may come out negated against JAX's.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def _tensor(x, device) -> torch.Tensor:
    x = torch.as_tensor(x)
    return x.to(device=device if device is not None else x.device, dtype=torch.float32)


def preprocess_features(x, pca_dim: int = 256, eps: float = 1e-5, device=None):
    """PCA-reduce with whitening, then L2-normalize the rows of ``x`` (N, D).
    Returns (features (N, pca_dim), (mean, components)) on ``device`` (the
    input's device when None)."""
    x = _tensor(x, device)
    mean = x.mean(dim=0)
    xc = x - mean
    cov = (xc.T @ xc) / x.shape[0]
    eigvals, eigvecs = torch.linalg.eigh(cov)  # ascending
    order = torch.argsort(-eigvals)[:pca_dim]
    components = eigvecs[:, order] * torch.rsqrt(eigvals[order] + eps)[None, :]
    out = xc @ components
    out = out / (torch.linalg.norm(out, dim=1, keepdim=True) + 1e-10)
    return out, (mean, components)


def kmeans_step(data: torch.Tensor, centroids: torch.Tensor):
    """One Lloyd iteration: (new centroids, assignment, inertia). The
    assignment takes the squared-distance expansion without the
    assignment-invariant ``||x||^2``; an empty cluster keeps its centroid."""
    d2 = (centroids ** 2).sum(dim=1)[None, :] - 2.0 * (data @ centroids.T)  # (N, K)
    best, assign = d2.min(dim=1)
    k = centroids.shape[0]
    counts = torch.zeros(k, device=data.device, dtype=data.dtype).index_add_(0, assign, torch.ones_like(best))
    sums = torch.zeros_like(centroids).index_add_(0, assign, data)
    new = torch.where(counts[:, None] > 0, sums / counts.clamp(min=1.0)[:, None], centroids)
    inertia = (best + (data ** 2).sum(dim=1)).sum()
    return new, assign, inertia


def kmeans_run(data: torch.Tensor, init_centroids: torch.Tensor, n_iter: int = 20):
    """``n_iter`` Lloyd iterations from ``init_centroids``: (centroids, the
    last iteration's assignment and inertia), as JAX's ``_kmeans_run``."""
    centroids = init_centroids
    assign = torch.zeros(data.shape[0], dtype=torch.int64, device=data.device)
    inertia = torch.zeros((), device=data.device)
    for _ in range(n_iter):
        centroids, assign, inertia = kmeans_step(data, centroids)
    return centroids, assign, inertia


def init_indices(n: int, k: int, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """``min(k, n)`` distinct row indices drawn from ``generator`` (on the CPU
    when None)."""
    gen_device = generator.device if generator is not None else torch.device("cpu")
    return torch.randperm(n, generator=generator, device=gen_device)[:min(k, n)]


def run_kmeans(x, nmb_clusters: int, n_iter: int = 20, generator: Optional[torch.Generator] = None,
               device=None) -> Tuple[torch.Tensor, float]:
    """k-means labels for each row of ``x`` and the final inertia (the
    reference's ``run_kmeans`` surface)."""
    data = _tensor(x, device)
    idx = init_indices(data.shape[0], nmb_clusters, generator).to(data.device)
    init = data[idx]
    if init.shape[0] < nmb_clusters:  # fewer rows than clusters
        init = torch.cat([init, init[:1].expand(nmb_clusters - init.shape[0], -1)])
    _, assign, inertia = kmeans_run(data, init, n_iter)
    return assign, float(inertia)


class Kmeans:
    """The reference's ``Kmeans``: ``cluster(data)`` fills ``images_lists``,
    the row indices of each cluster, and returns the loss. Runs on ``device``
    (``cuda`` unless the caller asks for another), the initial centroids from
    a generator seeded with ``seed``."""

    def __init__(self, k: int, pca_dim: int = 256, n_iter: int = 20, seed: int = 0, device=None):
        self.k = k
        self.pca_dim = pca_dim
        self.n_iter = n_iter
        self.seed = seed
        self.device = torch.device("cuda" if device is None else device)
        self.images_lists = None

    def cluster(self, data, verbose: bool = False) -> float:
        xb, _ = preprocess_features(data, min(self.pca_dim, data.shape[1]), device=self.device)
        generator = torch.Generator(device=self.device).manual_seed(self.seed)
        labels, loss = run_kmeans(xb, self.k, self.n_iter, generator)
        labels = labels.cpu().numpy()
        self.images_lists = [np.flatnonzero(labels == c).tolist() for c in range(self.k)]
        if verbose:
            print(f"k-means loss: {loss:.4f}")
        return loss
