"""Proposal/anchor-to-gt matcher on padded gt (counterpart of
``lvc_tpu/modeling/matcher.py:15-77``).

Ground-truth rows carry a validity mask instead of a variable length. Labels
{-1, 0, 1} = {ignore, negative, positive} per threshold band; with no valid
gt every prediction gets ``labels[0]``; the low-quality rule recruits every
prediction that ties for a valid gt's best (positive) quality.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch


class Matcher:
    def __init__(
        self,
        thresholds: Sequence[float],
        labels: Sequence[int],
        allow_low_quality_matches: bool = False,
    ):
        thresholds = list(thresholds)
        if thresholds[0] <= 0:
            raise ValueError("the first threshold must be positive")
        if any(lo > hi for lo, hi in zip(thresholds[:-1], thresholds[1:])):
            raise ValueError("thresholds must be non-decreasing")
        if any(l not in (-1, 0, 1) for l in labels) or len(labels) != len(thresholds) + 1:
            raise ValueError("one label in {-1, 0, 1} per threshold band")
        self.thresholds = [-float("inf")] + thresholds + [float("inf")]
        self.labels = list(labels)
        self.allow_low_quality_matches = allow_low_quality_matches

    def __call__(
        self, match_quality_matrix: torch.Tensor, gt_valid: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(..., M, N) qualities (rows = padded gt) and (..., M) validity ->
        (..., N) int64 index of the best gt and (..., N) int8 labels."""
        neg = torch.full((), -1.0, dtype=match_quality_matrix.dtype, device=match_quality_matrix.device)
        quality = torch.where(gt_valid[..., None], match_quality_matrix, neg)
        # argmax takes the first of tied maxima, as jnp.argmax does
        matches = quality.argmax(dim=-2)
        matched_vals = quality.max(dim=-2).values.clamp(min=0.0)
        any_valid = gt_valid.any(dim=-1, keepdim=True)
        matched_vals = torch.where(any_valid, matched_vals, torch.zeros_like(matched_vals))

        match_labels = torch.ones(matches.shape, dtype=torch.int8, device=matches.device)
        for label, low, high in zip(self.labels, self.thresholds[:-1], self.thresholds[1:]):
            in_band = (matched_vals >= low) & (matched_vals < high)
            match_labels = torch.where(in_band, torch.tensor(label, dtype=torch.int8, device=matches.device), match_labels)

        if self.allow_low_quality_matches:
            highest_per_gt = quality.max(dim=-1, keepdim=True).values
            is_best = (quality == highest_per_gt) & (highest_per_gt > 0) & gt_valid[..., None]
            recruited = is_best.any(dim=-2)
            match_labels = torch.where(recruited, torch.ones_like(match_labels), match_labels)
        return matches, match_labels
