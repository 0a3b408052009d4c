"""JAX parameter tree -> the port's ``state_dict`` (the inverse of
``wsovod_tpu/utils/weight_import.py::import_wsovod_model``).

Names and layouts are the reference torch modules' (``backbone.res2.0.conv1.
weight``, ``roi_heads.box_head.fc1.weight`` as ``[out, c*h*w]``,
``roi_heads.box_refinery.0.cls.projection.0.weight``,
``data_aware_head.datasets_feat.weight``,
``proposal_generator.rpn_head.conv.weight``, ...), so the same ``state_dict``
loader takes a reference WSOVOD checkpoint. Heads the port has no module for
yet (the training-only object miner) are left out. An MRRP model's tree has
the same names: its branches share the stage's weights.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def _conv(k: np.ndarray) -> np.ndarray:
    return np.transpose(k, (3, 2, 0, 1))  # HWIO -> OIHW


def _fc(k: np.ndarray) -> np.ndarray:
    return np.transpose(k, (1, 0))  # [in, out] -> [out, in]


def _convnorm(out: Dict[str, np.ndarray], prefix: str, p: Mapping[str, Any]) -> None:
    out[prefix + ".weight"] = _conv(p["kernel"])
    bn = p.get("FrozenBatchNorm_0")
    if bn is not None:
        out[prefix + ".norm.weight"] = bn["scale"]
        out[prefix + ".norm.bias"] = bn["bias"]
        out[prefix + ".norm.running_mean"] = bn["mean"]
        out[prefix + ".norm.running_var"] = bn["var"]


def _backbone(out, tree: Mapping[str, Any], prefix: str) -> None:
    for i in (1, 2, 3):
        _convnorm(out, f"{prefix}stem.conv{i}", tree["stem"][f"conv{i}"])
    for key in sorted(k for k in tree if k.startswith("res")):
        stage, block = key.split("_")
        for conv, p in tree[key].items():
            _convnorm(out, f"{prefix}{stage}.{block}.{conv}", p)


def fc1_weight_from_jax(kernel) -> np.ndarray:
    """DAN fc1 ``(h, w, c, out)`` kernel -> torch ``[out, c*h*w]``."""
    k = np.asarray(kernel)
    return k.transpose(3, 2, 0, 1).reshape(k.shape[3], -1)


def _tensors(out: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    return {
        k: torch.from_numpy(np.array(v, dtype=np.float32, copy=True)) for k, v in out.items()
    }


def backbone_state_dict_from_jax(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, torch.Tensor]:
    """A ``WSRResNet`` parameter tree -> its ``state_dict`` (names under
    ``prefix``)."""
    out: Dict[str, np.ndarray] = {}
    _backbone(out, tree, prefix)
    return _tensors(out)


def state_dict_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """``params``: the JAX model's parameter tree (``{"params": ...}`` or
    its inner dict), leaves as arrays. Returns ``name -> float tensor``."""
    tree = params.get("params", params)
    out: Dict[str, np.ndarray] = {}
    _backbone(out, tree["backbone"], "backbone.")

    rpn = tree.get("proposal_generator", {}).get("rpn_head")
    if rpn is not None:
        for nm in ("conv", "objectness_logits", "anchor_deltas"):
            out[f"proposal_generator.rpn_head.{nm}.weight"] = _conv(rpn[nm]["kernel"])
            out[f"proposal_generator.rpn_head.{nm}.bias"] = rpn[nm]["bias"]

    heads = tree["roi_heads"]
    dan = heads["box_head"]
    out["roi_heads.box_head.fc1.weight"] = fc1_weight_from_jax(dan["fc1"]["kernel"])
    out["roi_heads.box_head.fc1.bias"] = dan["fc1"]["bias"]
    out["roi_heads.box_head.fc2.weight"] = _fc(dan["fc2"]["kernel"])
    out["roi_heads.box_head.fc2.bias"] = dan["fc2"]["bias"]

    k = 0
    while f"box_refinery_{k}" in heads:
        ref, rp = heads[f"box_refinery_{k}"], f"roi_heads.box_refinery.{k}."
        for j, proj in ((0, "proj1"), (2, "proj2")):
            out[f"{rp}cls.projection.{j}.weight"] = _fc(ref["cls"][proj]["kernel"])
            out[f"{rp}cls.projection.{j}.bias"] = ref["cls"][proj]["bias"]
        if "bbox_pred" in ref:
            out[rp + "bbox_pred.weight"] = _fc(ref["bbox_pred"]["kernel"])
            out[rp + "bbox_pred.bias"] = ref["bbox_pred"]["bias"]
        k += 1

    dah = tree.get("data_aware_head")
    if dah is not None:
        for nm in ("linear1", "linear2"):
            out[f"data_aware_head.{nm}.weight"] = _fc(dah[nm]["kernel"])
            out[f"data_aware_head.{nm}.bias"] = dah[nm]["bias"]
        out["data_aware_head.datasets_feat.weight"] = dah["datasets_feat"]

    return _tensors(out)
