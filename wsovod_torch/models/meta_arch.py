"""``GeneralizedRCNN_WSOVOD`` (counterpart of
``wsovod_tpu/models/meta_arch.py:36-190,297-332``): normalise -> backbone ->
RPN -> fuse SAM proposals -> data-aware head -> ROI heads.

``forward`` is inference. ``forward_train`` returns the losses: the RPN's
proposal scores ramp as ``sigmoid(logit) * iteration / MAX_ITER``, the ROI
heads mine pseudo GT and return it, and the RPN's losses are computed from
it afterwards. Backbone stages up to ``MODEL.BACKBONE.FREEZE_AT`` are frozen
(``requires_grad`` off, so autograd records nothing for them: the JAX
package's stop-gradient at ``FREEZE_AT >= 5`` and its optimizer's frozen
label below).

With an FPN backbone (``build_swin_fpn_backbone``) the RPN proposes from
every level of ``RPN.IN_FEATURES``, the ROI heads pool each proposal on its
level of ``ROI_HEADS.IN_FEATURES``, and the data-aware head reads the first
of those (p2), as the JAX meta-arch does (``meta_arch.py:135``).

Under MRRP each proposal carries ``level_ids``, whose ``// 1000`` names the
branch it pools from: RPN rows their branch, SAM rows branch 0 (the JAX
package's inference, which passes no random key), or a random branch drawn
from an explicit ``torch.Generator`` (the trainer passes its own). In
training every branch runs, whatever the test branch index.

Batch convention (padded, static shapes, as the JAX package):
  images      [B, H, W, 3] raw pixels (BGR, the reference's pixel stats)
  image_sizes [B, 2] true (h, w)
  sam_boxes   [B, S, 4], sam_scores [B, S], sam_valid [B, S]
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn

from ..config import check_supported
from ..ops.sampling import Uniforms, generator_uniforms
from ..structures.instances import Instances, cat_instances
from .backbones import build_backbone
from .class_heads import DataAwareFeaturesHead
from .layers import FrozenBatchNorm2d
from .poolers import build_pooler
from .roi_heads import WSOVODROIHeads, build_roi_heads
from .rpn import WSOVODRPN_V2, build_proposal_generator

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class GeneralizedRCNN_WSOVOD(nn.Module):
    def __init__(self, backbone: nn.Module, proposal_generator: Optional[WSOVODRPN_V2],
                 roi_heads: WSOVODROIHeads, data_aware_head: Optional[DataAwareFeaturesHead],
                 pixel_mean=(102.9801, 115.9465, 122.7717), pixel_std=(1.0, 1.0, 1.0),
                 compute_dtype: torch.dtype = torch.float32, in_feature: str = "res5",
                 mrrp_num_branch: int = 0, max_iter: int = 200000):
        super().__init__()
        self.mrrp_num_branch = mrrp_num_branch
        self.max_iter = max_iter
        self.backbone = backbone
        self.proposal_generator = proposal_generator
        self.roi_heads = roi_heads
        self.data_aware_head = data_aware_head
        self.register_buffer("pixel_mean", torch.tensor(pixel_mean, dtype=torch.float32), persistent=False)
        self.register_buffer("pixel_std", torch.tensor(pixel_std, dtype=torch.float32), persistent=False)
        self.compute_dtype = compute_dtype
        self.in_feature = in_feature

    @property
    def device(self) -> torch.device:
        return self.pixel_mean.device

    def _normalize(self, images: torch.Tensor) -> torch.Tensor:
        x = (images - self.pixel_mean.to(images.dtype)) / self.pixel_std.to(images.dtype)
        return x.to(self.compute_dtype)

    def _proposals(self, features: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None, train: bool = False,
                   iteration: int = 0):
        """RPN proposals (score ``sigmoid(logit)``, times ``iteration /
        max_iter`` with ``train``) fused with the loaded SAM proposals: RPN
        rows first, then SAM rows. Under MRRP with an RPN, ``generator``
        draws each SAM row's branch; without one they take branch 0. With
        ``train`` returns ``(proposals, RPNAux)``."""
        parts = []
        aux = None
        if self.proposal_generator is not None:
            rpn = self.proposal_generator(features, batch["image_sizes"], train=train)
            if train:
                rpn, aux = rpn
            score = torch.sigmoid(rpn.objectness_logits).float()
            if train:
                score = score * (torch.tensor(float(iteration)) / float(self.max_iter)).to(score.device)
            score = torch.where(rpn.valid, score, torch.zeros((), device=score.device))
            parts.append(rpn.replace(objectness_logits=score))
        if batch.get("sam_boxes") is not None:
            sam_valid = batch["sam_valid"].bool()
            scores = batch["sam_scores"].float()
            level_ids = torch.zeros(sam_valid.shape, dtype=torch.int32, device=sam_valid.device)
            if generator is not None and self.proposal_generator is not None and self.mrrp_num_branch:
                level_ids = 1000 * torch.randint(
                    0, self.mrrp_num_branch, sam_valid.shape, generator=generator,
                    dtype=torch.int32, device=generator.device).to(sam_valid.device)
            parts.append(Instances(
                sam_valid,
                proposal_boxes=batch["sam_boxes"].float(),
                objectness_logits=torch.where(sam_valid, scores, torch.zeros((), device=scores.device)),
                level_ids=level_ids,
            ))
        assert parts, "need an RPN or loaded proposals"
        proposals = parts[0] if len(parts) == 1 else cat_instances(*parts)
        return (proposals, aux) if train else proposals

    def _data_aware_features(self, feat: torch.Tensor, batch: Dict[str, torch.Tensor]):
        """Masked-GAP data-aware vector; the pixel mask is the image's true
        size divided by the feature stride."""
        stride_h = batch["images"].shape[1] // feat.shape[1]
        sizes = torch.div(batch["image_sizes"], max(stride_h, 1), rounding_mode="floor")
        h_idx = torch.arange(feat.shape[1], device=feat.device)[None, :, None]
        w_idx = torch.arange(feat.shape[2], device=feat.device)[None, None, :]
        pixel_valid = (h_idx < sizes[:, 0, None, None]) & (w_idx < sizes[:, 1, None, None])
        return self.data_aware_head(feat, pixel_valid=pixel_valid)

    def forward(self, batch: Dict[str, torch.Tensor], embeddings: Optional[torch.Tensor] = None,
                classifier: Optional[torch.Tensor] = None, append_background: bool = True,
                return_proposals: bool = False, generator: Optional[torch.Generator] = None):
        """Inference: ``(detections, probs [B, P, C+1], boxes [B, P, 4])``,
        plus ``(proposal_boxes, objectness, valid)`` with
        ``return_proposals``. ``generator``: see ``_proposals``."""
        features = self.backbone(self._normalize(batch["images"]))
        proposals = self._proposals(features, batch, generator)
        daf = None
        if self.data_aware_head is not None:
            daf = self._data_aware_features(features[self.in_feature], batch)
        detections, probs, boxes = self.roi_heads.inference(
            features, proposals, batch["image_sizes"], data_aware_features=daf,
            classifier=classifier, embeddings=embeddings, append_background=append_background,
        )
        if return_proposals:
            return detections, probs, boxes, (
                proposals.proposal_boxes, proposals.objectness_logits, proposals.valid,
            )
        return detections, probs, boxes

    def forward_train(self, batch: Dict[str, torch.Tensor], embeddings: Optional[torch.Tensor] = None,
                      iteration: int = 0, generator: Optional[torch.Generator] = None,
                      uniforms: Optional[Uniforms] = None) -> Dict[str, torch.Tensor]:
        """The train forward (``wsovod_tpu/models/meta_arch.py:110-170``):
        the losses dict of the object miner, the K refineries and the RPN.
        ``batch`` adds ``gt_classes [B, G]`` and ``gt_valid [B, G]`` (the
        image-level supervision) to the inference keys. ``generator`` makes
        every random draw, in a fixed order: the dropout masks and, unless
        ``uniforms`` hands in the draws (the parity tests replay the JAX
        package's), the ROI heads' and then the RPN's subsampling."""
        if uniforms is None:
            uniforms = generator_uniforms(generator)
        features = self.backbone(self._normalize(batch["images"]), train=True)
        proposals, aux = self._proposals(features, batch, generator, train=True,
                                         iteration=iteration)
        daf = None
        if self.data_aware_head is not None:
            daf = self._data_aware_features(features[self.in_feature], batch)
        out = self.roi_heads.forward_train(features, proposals, batch["gt_classes"],
                                           batch["gt_valid"], uniforms, data_aware_features=daf,
                                           embeddings=embeddings, generator=generator)
        losses = dict(out.losses)
        targets = out.proposal_targets
        losses.update(self.proposal_generator.losses(aux, targets.boxes, targets.valid, uniforms))
        return losses


@torch.no_grad()
def init_parameters(model: GeneralizedRCNN_WSOVOD, generator: torch.Generator) -> None:
    """Random parameters with the JAX package's initialiser scales (normal
    draws in place of its truncated normals), drawn from ``generator``:
    backbone convs He fan-out (a Swin backbone's own ``init_parameters``:
    its dense and conv kernels LeCun fan-in, LayerNorms 1 and 0), RPN convs
    N(0, 0.01) with zero bias, DAN fcs N(0, 0.005) with bias 0.1,
    classifier projections and the object miner's linears LeCun fan-in with
    zero bias, box regressor N(0, 0.001),
    data-aware linears U[0, 0.02) and prototypes N(0, 1). The backbone's
    frozen-BN scales are drawn U[0.4, 0.8), its other statistics keep their
    identity defaults: with identity statistics the random convs grow the activations through the residual stages until, at
    the R50 test shape (688x1056), res5 reaches about 1e4 and every RPN
    delta overflows, so the RPN proposes nothing; these scales keep res5 at
    a standard deviation of about 0.3 and give the RPN valid proposals."""
    init_backbone = getattr(model.backbone, "init_parameters", None)
    if init_backbone is not None:  # the Swin backbones: their own initialisers
        init_backbone(generator)
    for name, p in model.named_parameters():
        if name.startswith("backbone.") and init_backbone is not None:
            continue
        if name.startswith("backbone.") and p.dim() == 1:  # VGG's conv biases
            p.zero_()
        elif name.startswith("backbone."):
            o, _, kh, kw = p.shape
            p.normal_(0.0, math.sqrt(2.0 / (o * kh * kw)), generator=generator)
        elif name.startswith("proposal_generator."):
            if name.endswith("weight"):
                p.normal_(0.0, 0.01, generator=generator)
            else:
                p.zero_()
        elif ".box_head." in name:
            if name.endswith("weight"):
                p.normal_(0.0, 0.005, generator=generator)
            else:
                p.fill_(0.1)
        elif ".cls.projection." in name:
            if name.endswith("weight"):
                p.normal_(0.0, math.sqrt(1.0 / p.shape[1]), generator=generator)
            else:
                p.zero_()
        elif ".bbox_pred." in name:
            if name.endswith("weight"):
                p.normal_(0.0, 0.001, generator=generator)
            else:
                p.zero_()
        elif ".object_miner." in name:
            if name.endswith("weight"):
                p.normal_(0.0, math.sqrt(1.0 / p.shape[1]), generator=generator)
            else:
                p.zero_()
        elif name.startswith("data_aware_head.linear"):
            if name.endswith("weight"):
                p.uniform_(0.0, 0.02, generator=generator)
            else:
                p.zero_()
        elif name == "data_aware_head.datasets_feat.weight":
            p.normal_(0.0, 1.0, generator=generator)
        else:
            raise KeyError(f"no initialiser for parameter {name}")
    for module in model.backbone.modules():
        if isinstance(module, FrozenBatchNorm2d):
            module.weight.uniform_(0.4, 0.8, generator=generator)


def build_model(cfg, device=None, seed: Optional[int] = 0) -> GeneralizedRCNN_WSOVOD:
    """Build the model from a config, refuse unported keys
    (``config.check_supported``), freeze the backbone's stages up to
    ``MODEL.BACKBONE.FREEZE_AT``, draw random parameters from a
    ``torch.Generator`` seeded with ``seed`` (``None`` leaves them
    uninitialised, for a checkpoint to fill), and move it to ``device``
    (default ``cfg.MODEL.DEVICE``) in eval mode."""
    check_supported(cfg)
    dtype = _DTYPES[cfg.TPU.COMPUTE_DTYPE]
    backbone = build_backbone(cfg)
    in_feature = cfg.MODEL.ROI_HEADS.IN_FEATURES[0]
    channels = backbone.output_channels()[in_feature]
    strides = list(backbone.output_strides().values())
    proposal_generator = build_proposal_generator(cfg, channels, strides)
    pooled_strides = [backbone.output_strides()[f] for f in cfg.MODEL.ROI_HEADS.IN_FEATURES]
    roi_heads = build_roi_heads(cfg, build_pooler(cfg, pooled_strides), channels, dtype)
    ov = cfg.MODEL.ROI_BOX_HEAD.OPEN_VOCABULARY
    mrrp_num_branch = cfg.MODEL.MRRP.NUM_BRANCH if cfg.MODEL.MRRP.MRRP_ON else 0
    data_aware = (
        DataAwareFeaturesHead(channels, ov.PROTOTYPE_NUM, cfg.MODEL.ROI_BOX_HEAD.DAN_DIM[-1],
                              mrrp_num_branch)
        if ov.DATA_AWARE else None
    )
    model = GeneralizedRCNN_WSOVOD(
        backbone, proposal_generator, roi_heads, data_aware,
        pixel_mean=tuple(cfg.MODEL.PIXEL_MEAN), pixel_std=tuple(cfg.MODEL.PIXEL_STD),
        compute_dtype=dtype, in_feature=in_feature,
        mrrp_num_branch=mrrp_num_branch, max_iter=cfg.SOLVER.MAX_ITER,
    )
    backbone.freeze(cfg.MODEL.BACKBONE.FREEZE_AT)
    if seed is not None:
        init_parameters(model, torch.Generator().manual_seed(seed))
    return model.to(device if device is not None else cfg.MODEL.DEVICE).eval()
