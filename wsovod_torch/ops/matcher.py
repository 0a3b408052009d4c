"""Proposal-to-ground-truth matcher, d2 ``Matcher`` semantics, mask-aware
and batched over leading dims (counterpart of ``wsovod_tpu/ops/matcher.py``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch


class Matcher:
    """Assigns each prediction its best ground truth and a label in {-1, 0,
    1} from threshold bands; ``allow_low_quality_matches`` labels 1 every
    prediction that ties a ground truth's best quality."""

    def __init__(self, thresholds: Sequence[float], labels: Sequence[int],
                 allow_low_quality_matches: bool = False):
        thresholds = list(thresholds)
        if thresholds != sorted(thresholds):
            raise ValueError(f"thresholds must be sorted, got {thresholds}")
        if len(labels) != len(thresholds) + 1 or not all(l in (-1, 0, 1) for l in labels):
            raise ValueError(f"need {len(thresholds) + 1} labels in {{-1, 0, 1}}, got {labels}")
        self.thresholds = [-float("inf")] + thresholds + [float("inf")]
        self.labels = list(labels)
        self.allow_low_quality_matches = allow_low_quality_matches

    def __call__(self, match_quality: torch.Tensor,
                 gt_valid: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """``match_quality [..., M, N]`` (ground truths x predictions),
        ``gt_valid [..., M]`` -> ``(matches [..., N] int64, labels [..., N]
        int8)``. Invalid ground truths never win and never define a band;
        ties go to the lower ground-truth index, as ``jnp.argmax``."""
        if gt_valid is not None:
            neg = torch.full((), -1.0, dtype=match_quality.dtype, device=match_quality.device)
            match_quality = torch.where(gt_valid[..., :, None], match_quality, neg)
        matched_vals, matches = match_quality.max(dim=-2)
        labels = torch.ones(matched_vals.shape, dtype=torch.int8, device=matched_vals.device)
        for lo, hi, label in zip(self.thresholds[:-1], self.thresholds[1:], self.labels):
            band = (matched_vals >= lo) & (matched_vals < hi)
            labels = torch.where(band, torch.tensor(label, dtype=torch.int8, device=labels.device),
                                 labels)
        if self.allow_low_quality_matches:
            highest = match_quality.max(dim=-1, keepdim=True).values  # [..., M, 1]
            is_best = (match_quality == highest) & (highest > 0)
            if gt_valid is not None:
                is_best = is_best & gt_valid[..., :, None]
            labels = torch.where(is_best.any(dim=-2),
                                 torch.tensor(1, dtype=torch.int8, device=labels.device), labels)
        return matches, labels
