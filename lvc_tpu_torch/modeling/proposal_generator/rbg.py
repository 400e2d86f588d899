"""Random Box Generator, the UBBR trainer's proposal source (counterpart of
``lvc_tpu/modeling/proposal_generator/rbg.py``).

In fixed shapes, as JAX has it: ``M = 2 * int(BATCH_SIZE_PER_IMAGE *
POSITIVE_FRACTION)`` slots per image, assigned round-robin over the valid
gts in valid-first stable order. Each slot jitters its gt box by tx, ty
uniform in [-alpha, alpha] and tw, th uniform in [log(1 - beta),
log(1 + beta)], is clipped to the image and kept where its IoU with some
valid gt is > t (an image with no gt keeps nothing). Precomputed proposals,
when given, come first and are kept by the same IoU rule.

The draws come from the caller's generators, one (4, M) draw an image;
``jitter_boxes`` and ``rbg_proposals`` are plain functions of the draws, so
that tests can feed them JAX's.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from lvc_tpu_torch.modeling.sampling import Generators, image_generator
from lvc_tpu_torch.structures import boxes as box_ops


def jitter_boxes(src, tx, ty, tw, th, image_size) -> torch.Tensor:
    """(..., M, 4) boxes moved by (..., M) draws and clipped to
    ``image_size`` (..., 2) = (h, w)."""
    x, y = src[..., 0], src[..., 1]
    w, h = src[..., 2] - src[..., 0], src[..., 3] - src[..., 1]
    new_x = x + w * tx
    new_y = y + h * ty
    new_w = w * torch.exp(tw)
    new_h = h * torch.exp(th)
    gen = torch.stack([new_x, new_y, new_x + new_w, new_y + new_h], dim=-1)
    size = image_size.to(gen.dtype)
    return box_ops.clip(gen, size[..., 0, None], size[..., 1, None])


def _keep(gt_boxes, gt_valid, boxes, t: float) -> torch.Tensor:
    """Boxes whose IoU with some valid gt is > t."""
    iou = box_ops.pairwise_iou(gt_boxes, boxes)
    iou = torch.where(gt_valid[..., None], iou, torch.zeros((), dtype=iou.dtype, device=iou.device))
    return iou.amax(dim=-2) > t


def rbg_proposals(
    gt_boxes: torch.Tensor,  # (B, G, 4)
    gt_valid: torch.Tensor,  # (B, G)
    image_sizes: torch.Tensor,  # (B, 2)
    tx, ty, tw, th,  # (B, M) draws on their final ranges
    t: float,
    proposal_boxes: Optional[torch.Tensor] = None,  # (B, P, 4)
    proposal_valid: Optional[torch.Tensor] = None,  # (B, P)
):
    """(boxes (B, P + M, 4), logits (B, P + M), valid (B, P + M)): the
    precomputed proposals (logit 0) then the jittered gts (logit 1)."""
    B, M = tx.shape
    device = gt_boxes.device
    n_gt = gt_valid.sum(dim=-1).clamp(min=1)
    slot_gt = torch.arange(M, device=device)[None, :] % n_gt[:, None]
    # valid first, stably; an int cast, as torch sorts no bool on every device
    gt_order = torch.argsort((~gt_valid).to(torch.int32), dim=-1, stable=True)
    src_idx = torch.gather(gt_order, 1, slot_gt)
    src = torch.gather(gt_boxes, 1, src_idx[..., None].expand(-1, -1, 4))
    gen = jitter_boxes(src, tx, ty, tw, th, image_sizes)
    keep_gen = _keep(gt_boxes, gt_valid, gen, t) & gt_valid.any(dim=-1, keepdim=True)
    if proposal_boxes is None:
        proposal_boxes = gt_boxes.new_zeros((B, 0, 4))
        proposal_valid = torch.zeros((B, 0), dtype=torch.bool, device=device)
    keep_real = _keep(gt_boxes, gt_valid, proposal_boxes, t) & proposal_valid
    P = proposal_boxes.shape[1]
    logits = torch.cat([torch.zeros((B, P), device=device), torch.ones((B, M), device=device)], dim=1)
    return (
        torch.cat([proposal_boxes.to(gen.dtype), gen], dim=1),
        logits,
        torch.cat([keep_real, keep_gen], dim=1),
    )


class RBG(nn.Module):
    """Jittered-gt proposals in training; in eval mode the precomputed
    proposals pass through. No parameters."""

    def __init__(
        self,
        alpha: float = 0.35,
        beta: float = 0.5,
        t: float = 0.3,
        batch_size_per_image: int = 64,
        positive_fraction: float = 1.0,
    ):
        super().__init__()
        self.alpha = alpha
        self.beta = beta
        self.t = t
        self.num_slots = 2 * int(batch_size_per_image * positive_fraction)

    def draws(self, B: int, generator: Generators, device):
        """(tx, ty, tw, th), each (B, M): image b's (4, M) draw from its
        generator (on the generator's own device), moved to ``device``. Per
        image, so that an image's boxes do not depend on where it sits in a
        split batch (JAX splits its key by the local B, ROADMAP.md queue 3)."""
        u = []
        for b in range(B):
            g = image_generator(generator, b)
            gen_device = g.device if g is not None else torch.device("cpu")
            u.append(torch.rand((4, self.num_slots), generator=g, device=gen_device).to(device))
        u = torch.stack(u, dim=1)
        lo, hi = math.log(1 - self.beta), math.log(1 + self.beta)
        shift = u[:2] * (2 * self.alpha) - self.alpha
        scale = u[2:] * (hi - lo) + lo
        return shift[0], shift[1], scale[0], scale[1]

    def forward(
        self,
        features,  # unused: the proposal generators' interface
        image_sizes: torch.Tensor,
        gt_boxes: Optional[torch.Tensor] = None,
        gt_valid: Optional[torch.Tensor] = None,
        generator: Generators = None,
        proposal_boxes: Optional[torch.Tensor] = None,
        proposal_logits: Optional[torch.Tensor] = None,
        proposal_valid: Optional[torch.Tensor] = None,
    ):
        """(boxes, logits, valid, {}) as the RPN returns them, no losses."""
        if not self.training:
            return proposal_boxes, proposal_logits, proposal_valid, {}
        draws = self.draws(gt_boxes.shape[0], generator, gt_boxes.device)
        boxes, logits, valid = rbg_proposals(
            gt_boxes, gt_valid, image_sizes, *draws, self.t, proposal_boxes, proposal_valid
        )
        return boxes, logits, valid, {}
