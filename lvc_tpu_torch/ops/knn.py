"""kNN label verification: similarity matmul, top-k, majority vote.

Counterpart of ``lvc_tpu/ops/knn.py::knn_vote`` (:46-78): mean-centred
cosine similarity (or negative euclidean distance) between candidate and
shot descriptors, the labels of the k most similar shots, and their mode.
The similarity is one ``torch.matmul``, as the JAX package left it to XLA.
``sharded_knn_vote`` (``knn.py:81``) splits the queries over the ranks of a
process group, the shots replicated, as JAX shards them over a mesh.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

__all__ = ["knn_vote", "sharded_knn_vote", "similarity", "topk_indices"]


def similarity(shots: torch.Tensor, queries: torch.Tensor, cosine: bool = True) -> torch.Tensor:
    """(S, D), (Q, D) -> (Q, S) float32 similarities."""
    shots, queries = shots.float(), queries.float()
    if cosine:
        center = shots.mean(dim=0, keepdim=True)
        s = shots - center
        q = queries - center
        # divisions by tensors: IEEE on every device
        s = s / (torch.linalg.vector_norm(s, dim=-1, keepdim=True) + 1e-8)
        q = q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + 1e-8)
        return q @ s.T
    q2 = (queries ** 2).sum(dim=-1, keepdim=True)
    s2 = (shots ** 2).sum(dim=-1)
    return -(q2 - 2 * (queries @ shots.T) + s2[None, :])


def topk_indices(sim: torch.Tensor, k: int) -> torch.Tensor:
    """(Q, S) -> (Q, k) indices of the k largest in descending order, ties to
    the lowest index (``_small_topk_indices``, ``knn.py:24-43``): k argmax
    passes, each masking its pick to -inf. ``torch.topk`` leaves the order
    of ties undefined. Overwrites ``sim``."""
    idxs = [torch.zeros((sim.shape[0], 0), dtype=torch.long, device=sim.device)]
    for _ in range(k):
        best = sim.argmax(dim=-1)  # first maximum: the lowest index
        idxs.append(best[:, None])
        sim.scatter_(-1, best[:, None], float("-inf"))
    return torch.cat(idxs, dim=-1)


def knn_vote(
    shot_descriptors: torch.Tensor,  # (S, D)
    shot_classes: torch.Tensor,  # (S,)
    query_descriptors: torch.Tensor,  # (Q, D)
    k: int = 10,
    cosine: bool = True,
    num_classes: int = 80,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (topk_labels (Q, k), mode_label (Q,) int64).

    Mode ties resolve to the smallest class id. ``k`` is clamped to the
    gallery size (fewer shots than k votes over all of them)."""
    k = min(k, shot_descriptors.shape[0])
    sim = similarity(shot_descriptors, query_descriptors, cosine)
    idx = topk_indices(sim, k)
    topk_labels = shot_classes.long()[idx]  # (Q, k)
    votes = torch.zeros(idx.shape[0], num_classes, dtype=torch.int32, device=idx.device)
    votes.scatter_add_(1, topk_labels, torch.ones_like(topk_labels, dtype=torch.int32))
    return topk_labels, votes.argmax(dim=-1)


def _all_gather_blocks(block: torch.Tensor, group) -> torch.Tensor:
    """Every rank's equal-shaped ``block``, concatenated in rank order (on
    the CPU under gloo, on the card under NCCL)."""
    on = block if dist.get_backend(group) == "nccl" else block.cpu()
    blocks = [torch.empty_like(on) for _ in range(dist.get_world_size(group))]
    dist.all_gather(blocks, on.contiguous(), group=group)
    return torch.cat(blocks).to(block.device)


def sharded_knn_vote(
    shot_descriptors: torch.Tensor,  # (S, D), the same on every rank
    shot_classes: torch.Tensor,  # (S,)
    query_descriptors: torch.Tensor,  # (Q, D), the same on every rank
    k: int = 10,
    cosine: bool = True,
    num_classes: int = 80,
    group=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``knn_vote`` with the queries split over the ranks of ``group`` (the
    default group when None): Q is padded to a multiple of the world size W,
    each rank votes its contiguous block of the padded queries, the blocks
    are all-gathered and the padding stripped. Every rank gets the whole
    (topk_labels (Q, k), mode (Q,)). Without ``torch.distributed`` it is
    ``knn_vote``."""
    if not (dist.is_available() and dist.is_initialized()):
        return knn_vote(shot_descriptors, shot_classes, query_descriptors, k, cosine, num_classes)
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    Q = query_descriptors.shape[0]
    padded = F.pad(query_descriptors, (0, 0, 0, (-Q) % world))
    n = padded.shape[0] // world
    topk, mode = knn_vote(
        shot_descriptors, shot_classes, padded[rank * n:(rank + 1) * n], k, cosine, num_classes
    )
    return _all_gather_blocks(topk, group)[:Q], _all_gather_blocks(mode, group)[:Q]
