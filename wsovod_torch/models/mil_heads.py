"""Instance-refinement output layers at inference (counterpart of
``wsovod_tpu/models/mil_heads.py:106-154,230-245``). The object miner and
the losses belong to the training slice."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..structures.boxes import apply_deltas
from .class_heads import OpenVocabularyClassifier


class InstanceRefinementOutputLayers(nn.Module):
    """Refinement head k: OV class scores ``[B, P, C(+1)]`` and, with
    ``refine_reg``, class-agnostic box deltas ``[B, P, 4]`` (float32, the
    reference's dtype promotion of its default-dtype ``Dense``)."""

    def __init__(self, in_features: int, refine_reg: bool = False, weight_dim: int = 512,
                 norm_weight: bool = True, norm_temperature: float = 50.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cls = OpenVocabularyClassifier(in_features, weight_dim, norm_weight,
                                            norm_temperature, dtype)
        self.bbox_pred = nn.Linear(in_features, 4) if refine_reg else None

    def forward(self, x: torch.Tensor, classifier: Optional[torch.Tensor] = None,
                append_background: bool = True,
                embeddings: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        scores = self.cls(x, classifier=classifier, append_background=append_background,
                          embeddings=embeddings)
        if self.bbox_pred is not None:
            deltas = self.bbox_pred(x.float())
        else:
            deltas = torch.zeros(x.shape[:-1] + (4,), dtype=scores.dtype, device=x.device)
        return scores, deltas


def predict_probs_K(scores_list: Sequence[torch.Tensor]) -> torch.Tensor:
    """Mean softmax over the K refinement heads, ``[B, P, C+1]``."""
    probs = None
    for s in scores_list:
        p = F.softmax(s.float(), dim=-1)
        probs = p if probs is None else probs + p
    return probs / len(scores_list)


def predict_boxes_K(deltas_list, proposal_boxes, bbox_reg_weights) -> torch.Tensor:
    """Mean deltas over the K heads applied to the proposals, ``[B, P, 4]``."""
    d = None
    for dk in deltas_list:
        d = dk.float() if d is None else d + dk.float()
    return apply_deltas(d / len(deltas_list), proposal_boxes, weights=bbox_reg_weights)
