"""Class heads: ``OpenVocabularyClassifier`` and ``DataAwareFeaturesHead``
(counterpart of ``wsovod_tpu/models/class_heads.py``; reference
``open_vocabulary_classifier.py`` and ``data_aware_features_head.py``)."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Linear


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """``x / max(||x||, eps)``, as torch ``F.normalize`` and the reference."""
    n = torch.sqrt(torch.sum(torch.square(x), dim=dim, keepdim=True))
    return x / torch.clamp(n, min=eps)


class OpenVocabularyClassifier(nn.Module):
    """Cosine-similarity region classifier against class text embeddings:
    project (in -> 1024 -> ReLU -> D -> ReLU) in the compute dtype, then
    normalise and take the logits in float32 against the normalised ``[D,
    C]`` embedding matrix, with an optional zero background column."""

    def __init__(self, in_features: int, weight_dim: int = 512, norm_weight: bool = True,
                 norm_temperature: float = 50.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm_weight = norm_weight
        self.norm_temperature = norm_temperature
        self.dtype = dtype
        self.projection = nn.Sequential(
            Linear(in_features, 1024), nn.ReLU(), Linear(1024, weight_dim), nn.ReLU()
        )

    def forward(self, x: torch.Tensor, classifier: Optional[torch.Tensor] = None,
                append_background: bool = False,
                embeddings: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.projection(x.to(self.dtype)).float()
        weight = classifier if classifier is not None else embeddings
        assert weight is not None, "OpenVocabularyClassifier needs `embeddings` or `classifier`"
        w = weight.float().t()  # [D, C]
        if self.norm_weight:
            w = l2_normalize(w, dim=0)
            x = self.norm_temperature * l2_normalize(x, dim=-1)
        if append_background:
            w = torch.cat([w, torch.zeros((w.shape[0], 1), dtype=w.dtype, device=w.device)], dim=1)
        return torch.matmul(x, w)


class DataAwareFeaturesHead(nn.Module):
    """Per image: masked global average pool of the backbone map -> FC(C ->
    C//16) ReLU -> FC(-> prototypes) Tanh -> mixture of the ``[prototypes,
    features_dim]`` prototype embedding; added later to every ROI feature."""

    def __init__(self, in_channels: int, prototype_num: int = 5, features_dim: int = 4096,
                 mrrp_num_branch: int = 0):
        super().__init__()
        self.mrrp_num_branch = mrrp_num_branch
        self.linear1 = nn.Linear(in_channels, in_channels // 16)
        self.linear2 = nn.Linear(in_channels // 16, prototype_num)
        self.datasets_feat = nn.Embedding(prototype_num, features_dim)

    def forward(self, feature: torch.Tensor, pixel_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``feature [B, H, W, C]`` (NHWC), ``pixel_valid [B, H, W]`` ->
        ``[B, features_dim]`` float32. The pool sums in float32 and rounds to
        the feature dtype, the dtype the reference's pooled vector has; the
        head then runs in float32 (the reference's dtype promotion).

        Under MRRP (``mrrp_num_branch`` > 0) a feature whose batch divides
        by the branch count and is at least it is taken as the branch-major
        concat ``[n_br * B, H, W, C]``, averaged over its branches and
        rounded to the feature dtype; the pixel mask then applies only if
        its batch still matches. This is the JAX package's rule
        (``wsovod_tpu/models/class_heads.py:106-116``), kept on purpose: a
        single-branch batch (``TEST_BRANCH_IDX >= 0``) of 3 images is
        averaged into one vector there too."""
        br = self.mrrp_num_branch
        if br and feature.shape[0] % br == 0 and feature.shape[0] >= br:
            feature = feature.float().reshape((br, -1) + feature.shape[1:]).mean(dim=0).to(feature.dtype)
        f = feature.float()
        if pixel_valid is not None and pixel_valid.shape[0] == feature.shape[0]:
            m = pixel_valid[..., None].float()
            x = (f * m).sum(dim=(1, 2)) / (m.sum(dim=(1, 2))).clamp(min=1.0)
        else:
            x = f.mean(dim=(1, 2))
        x = x.to(feature.dtype).float()
        x = F.relu(self.linear1(x))
        x = torch.tanh(self.linear2(x))
        return x @ self.datasets_feat.weight
