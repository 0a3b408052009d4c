"""Balanced positive/negative subsampling with static shapes, batched over
leading dims (counterpart of ``wsovod_tpu/ops/sampling.py``): a fixed-shape
boolean mask of the sampled rows instead of d2's index lists.

The random order comes from uniform draws on ``[0, 1)``: from a
``torch.Generator``, or handed in by the caller. JAX's PRNG draws cannot be
replayed in torch, so the parity tests hand in the JAX package's draws.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch

# ``uniforms(shape, device)`` -> float32 draws on [0, 1) of that shape
Uniforms = Callable[[Sequence[int], torch.device], torch.Tensor]


def generator_uniforms(generator: Optional[torch.Generator]) -> Uniforms:
    """Draws from ``generator`` (``None``: torch's default generator of the
    device)."""
    def draw(shape, device):
        return torch.rand(tuple(shape), generator=generator, device=device)
    return draw


def random_rank_within(mask: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Rank (0-based) of each element among the members of ``mask`` along
    the last dim, in the random order of the draws ``u`` (same shape);
    non-members rank after every member."""
    key = torch.where(mask, u, u + 2.0)
    order = torch.argsort(key, dim=-1, stable=True)
    ranks = torch.empty_like(order)
    ar = torch.arange(order.shape[-1], device=order.device).expand_as(order)
    return ranks.scatter_(-1, order, ar)


def subsample_labels(labels: torch.Tensor, num_samples: int, positive_fraction: float,
                     u_pos: torch.Tensor, u_neg: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pick per row (last dim) up to ``num_samples`` entries with at most
    ``int(num_samples * positive_fraction)`` positives, the rest negatives,
    each group in the random order of its draws ``u_pos`` / ``u_neg`` (same
    shape as ``labels``). ``labels``: 1 positive, 0 negative, -1 ignore.
    Returns the two sampled masks."""
    pos_mask = labels == 1
    neg_mask = labels == 0
    num_pos = pos_mask.sum(-1, keepdim=True).clamp(max=int(num_samples * positive_fraction))
    num_neg = torch.minimum(num_samples - num_pos, neg_mask.sum(-1, keepdim=True))
    pos = pos_mask & (random_rank_within(pos_mask, u_pos) < num_pos)
    neg = neg_mask & (random_rank_within(neg_mask, u_neg) < num_neg)
    return pos, neg
