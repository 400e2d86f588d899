"""Fixed-shape non-maximum suppression in torch ops.

Counterpart of ``lvc_tpu/ops/nms.py`` (nms_mask:138, nms_rotated_mask:167,
batched_nms_rotated_mask:187, batched_nms_mask:210, masked_topk:231). The
result is a keep mask over a padded box set, and the selection of kept boxes
is a separate masked top-k, as in the JAX package.

Greedy NMS is computed as the global fixpoint that ``_nms_mask_fixpoint``
(``nms.py:99``) uses as its cross-check: with ``sup[i, j]`` = "higher-ranked
box i overlaps j by IoU > thr", iterate
``x[j] = valid[j] & not any_i(sup[i, j] & x[i])`` from ``x = valid``. After
round k the first k ranks agree with greedy, so the fixpoint is exactly
greedy NMS. Every function takes leading batch dimensions, so one call covers
all images (and, in the RPN, all levels).

Host syncs: each convergence test reads one bool back, so a call costs
(rounds + 1) syncs for the WHOLE batch, where rounds is the longest
suppression chain in any of its sets. Per image that is (rounds + 1) / B for
the RPN call and again for the detection call. Making this sync-free (a
fixed round budget checked once, or a kernel) is later work.

The rotated variants run the same core over XYWHA boxes with the
polygon-clip IoU (``structures/rotated_boxes.py``), computed for a block of
rows at a time so that the 24 candidate vertices of every pair need not be
held at once.

Ties: every ordering here is a stable descending sort, so equal scores keep
the lower index first, as ``jax.lax.top_k`` and ``argsort(stable=True)`` do.
Serving in bf16 produces many exact logit ties, and this is what keeps the
port's proposals equal to the JAX package's.
"""
from __future__ import annotations

import torch

from lvc_tpu_torch.structures import boxes as box_ops
from lvc_tpu_torch.structures import rotated_boxes as rbox_ops
from lvc_tpu_torch.utils.tracing import count

NEG_INF = -1e10


def _stable_desc(scores: torch.Tensor) -> torch.Tensor:
    return torch.sort(scores, dim=-1, descending=True, stable=True).indices


def _nms_core(boxes, scores, valid, iou_threshold: float, iou_fn, rows: int = 0) -> torch.Tensor:
    """The greedy fixpoint over (..., N, D) boxes with ``iou_fn``; ``rows``
    > 0 computes the IoU matrix that many rows at a time."""
    n, d = boxes.shape[-2:]
    sort_scores = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    order = _stable_desc(sort_scores)
    b = torch.gather(boxes, -2, order[..., None].expand(order.shape + (d,)))
    v = torch.gather(valid, -1, order)
    if rows and rows < n:
        iou = torch.cat([iou_fn(b[..., i:i + rows, :], b) for i in range(0, n, rows)], dim=-2)
    else:
        iou = iou_fn(b, b)
    upper = torch.ones((n, n), dtype=torch.bool, device=boxes.device).triu(1)
    sup = (iou > iou_threshold) & upper  # sup[..., i, j]: rank i suppresses rank j > i

    return torch.zeros_like(valid).scatter(-1, order, nms_fixpoint(sup, v))


@torch.library.custom_op("lvc_tpu_torch::nms_fixpoint", mutates_args=())
def nms_fixpoint(sup: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Iterate ``x[j] = valid[j] & not any_i(sup[i, j] & x[i])`` from
    ``x = valid`` to its fixpoint: (..., N, N) and (..., N) bool in rank
    order. A custom op, so that ``torch.export`` records the loop, which
    reads one bool back a round, as one node. Each round adds one to the
    counter ``nms.rounds`` of the innermost open span."""
    cur = valid.clone()
    while True:
        nxt = valid & ~(sup & cur[..., :, None]).any(dim=-2)
        count("nms.rounds")
        if torch.equal(nxt, cur):  # one host sync per round
            return cur
        cur = nxt


@nms_fixpoint.register_fake
def _(sup, valid):
    return torch.empty_like(valid)


def nms_mask(
    boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor, iou_threshold: float
) -> torch.Tensor:
    """Greedy NMS over padded box sets.

    Args:
        boxes: (..., N, 4) XYXY.
        scores: (..., N).
        valid: (..., N) bool; padding rows must be False.
        iou_threshold: suppress boxes whose IoU with a surviving higher-scored
            box is strictly greater than this.
    Returns:
        (..., N) bool keep mask in the input order.
    """
    return _nms_core(boxes, scores, valid, iou_threshold, box_ops.pairwise_iou)


ROTATED_ROWS = 64  # rows of the rotated IoU matrix computed at a time


def nms_rotated_mask(
    boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor, iou_threshold: float
) -> torch.Tensor:
    """``nms_mask`` over (..., N, 5) XYWHA boxes with the rotated IoU."""
    return _nms_core(boxes, scores, valid, iou_threshold, rbox_ops.pairwise_iou_rotated, ROTATED_ROWS)


def batched_nms_rotated_mask(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    idxs: torch.Tensor,
    valid: torch.Tensor,
    iou_threshold: float,
) -> torch.Tensor:
    """Class-aware rotated NMS: each box's centre moves by its class times
    (the largest ``max(cx, cy) + hypot(w, h) / 2`` over the set's valid
    boxes, + 1); w, h and the angle stay. Leading dims are independent sets."""
    half_diag = torch.hypot(boxes[..., 2], boxes[..., 3]) / 2.0
    reach = torch.where(valid, torch.maximum(boxes[..., 0], boxes[..., 1]) + half_diag, torch.zeros_like(half_diag))
    max_coord = reach.amax(dim=-1) + 1.0
    offsets = idxs.to(boxes.dtype) * max_coord[..., None]
    shifted = torch.cat([boxes[..., :2] + offsets[..., None], boxes[..., 2:]], dim=-1)
    return nms_rotated_mask(shifted, scores, valid, iou_threshold)


def batched_nms_mask(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    idxs: torch.Tensor,
    valid: torch.Tensor,
    iou_threshold: float,
) -> torch.Tensor:
    """Class-aware NMS by the coordinate-offset trick: boxes of different
    ``idxs`` never suppress each other. Leading dims are independent sets,
    each with its own offset (the max coordinate over its valid boxes + 1)."""
    masked = torch.where(valid[..., None], boxes, torch.zeros_like(boxes))
    max_coord = masked.flatten(-2).amax(dim=-1) + 1.0
    offsets = idxs.to(boxes.dtype) * max_coord[..., None]
    return nms_mask(boxes + offsets[..., None], scores, valid, iou_threshold)


def masked_topk(scores: torch.Tensor, valid: torch.Tensor, k: int):
    """Indices of the top-k valid entries along the last dim (ties toward the
    lower index) and a bool mask of which of the k slots are real."""
    neg = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    k = min(k, scores.shape[-1])
    order = _stable_desc(neg)[..., :k]
    return order, torch.gather(valid, -1, order)
