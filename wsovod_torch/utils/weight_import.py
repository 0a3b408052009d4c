"""JAX parameter tree -> the port's ``state_dict`` (the inverse of
``wsovod_tpu/utils/weight_import.py::import_wsovod_model``).

Names and layouts are the reference torch modules' (``backbone.res2.0.conv1.
weight``, ``backbone.plain1.conv1.bias`` of VGG16,
``roi_heads.box_head.fc1.weight`` as ``[out, c*h*w]``,
``roi_heads.box_refinery.0.cls.projection.0.weight``,
``data_aware_head.datasets_feat.weight``,
``proposal_generator.rpn_head.conv.weight``,
``roi_heads.object_miner.cls.weight``, the Swin FPN's
``backbone.bottom_up.layers.0.blocks.1.attn.qkv.weight`` and
``backbone.fpn_lateral2.weight``, ...), so the same ``state_dict`` loader
takes a reference WSOVOD checkpoint. An MRRP model's tree has the
same names: its branches share the stage's weights. The JAX package creates
the object miner's parameters only when it initialises in training mode; a
tree without them maps without them.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch


# np.asarray first: np.transpose of an array type with its own transpose
# method (a JAX array) calls that method, which compiles a program per shape


def _conv(k: np.ndarray) -> np.ndarray:
    return np.transpose(np.asarray(k), (3, 2, 0, 1))  # HWIO -> OIHW


def _fc(k: np.ndarray) -> np.ndarray:
    return np.transpose(np.asarray(k), (1, 0))  # [in, out] -> [out, in]


def _convnorm(out: Dict[str, np.ndarray], prefix: str, p: Mapping[str, Any]) -> None:
    out[prefix + ".weight"] = _conv(p["kernel"])
    if "bias" in p:  # VGG's convs
        out[prefix + ".bias"] = p["bias"]
    bn = p.get("FrozenBatchNorm_0")
    if bn is not None:
        out[prefix + ".norm.weight"] = bn["scale"]
        out[prefix + ".norm.bias"] = bn["bias"]
        out[prefix + ".norm.running_mean"] = bn["mean"]
        out[prefix + ".norm.running_var"] = bn["var"]


def _dense(out: Dict[str, np.ndarray], prefix: str, p: Mapping[str, Any]) -> None:
    out[prefix + ".weight"] = _fc(p["kernel"])
    if "bias" in p:
        out[prefix + ".bias"] = p["bias"]


def _layer_norm(out: Dict[str, np.ndarray], prefix: str, p: Mapping[str, Any]) -> None:
    out[prefix + ".weight"] = p["scale"]
    out[prefix + ".bias"] = p["bias"]


def _swin(out, tree: Mapping[str, Any], prefix: str) -> None:
    """A ``SwinTransformer`` tree: ``patch_embed``/``patch_norm``,
    ``stage{s}_block{j}``, ``merge{s}``, ``stage{s}_norm`` ->
    ``patch_embed.{proj,norm}``, ``layers.{s-2}.blocks.{j}``,
    ``layers.{s-2}.downsample``, ``norm{s-2}``."""
    out[prefix + "patch_embed.proj.weight"] = _conv(tree["patch_embed"]["kernel"])
    out[prefix + "patch_embed.proj.bias"] = tree["patch_embed"]["bias"]
    if "patch_norm" in tree:
        _layer_norm(out, prefix + "patch_embed.norm", tree["patch_norm"])
    for key, p in tree.items():
        m = re.fullmatch(r"stage(\d+)_block(\d+)", key)
        if m:
            bp = f"{prefix}layers.{int(m.group(1)) - 2}.blocks.{m.group(2)}."
            _layer_norm(out, bp + "norm1", p["norm1"])
            _layer_norm(out, bp + "norm2", p["norm2"])
            _dense(out, bp + "attn.qkv", p["attn"]["qkv"])
            _dense(out, bp + "attn.proj", p["attn"]["proj"])
            out[bp + "attn.relative_position_bias_table"] = (
                p["attn"]["relative_position_bias_table"])
            _dense(out, bp + "mlp.fc1", p["mlp_fc1"])
            _dense(out, bp + "mlp.fc2", p["mlp_fc2"])
        m = re.fullmatch(r"merge(\d+)", key)
        if m:
            mp = f"{prefix}layers.{int(m.group(1)) - 2}.downsample."
            _layer_norm(out, mp + "norm", p["norm"])
            _dense(out, mp + "reduction", p["reduction"])
        m = re.fullmatch(r"stage(\d+)_norm", key)
        if m:
            _layer_norm(out, f"{prefix}norm{int(m.group(1)) - 2}", p)


def _backbone(out, tree: Mapping[str, Any], prefix: str) -> None:
    """A WSR ResNet tree (``stem``, ``res{s}_{b}``), a VGG16 tree
    (``plain{k}``, named ``plain{k}.conv{i}`` in torch), a Swin tree or a
    Swin FPN tree (``bottom_up`` and ``fpn_{lateral,output}_stage{s}``,
    named ``fpn_{lateral,output}{s}``: stage s is level p{s})."""
    if "patch_embed" in tree:
        _swin(out, tree, prefix)
        return
    if "bottom_up" in tree:
        _swin(out, tree["bottom_up"], prefix + "bottom_up.")
        for key, p in tree.items():
            m = re.fullmatch(r"fpn_(lateral|output)_stage(\d+)", key)
            if m:
                out[f"{prefix}fpn_{m.group(1)}{m.group(2)}.weight"] = _conv(p["kernel"])
                out[f"{prefix}fpn_{m.group(1)}{m.group(2)}.bias"] = p["bias"]
        return
    if "stem" in tree:
        for i in (1, 2, 3):
            _convnorm(out, f"{prefix}stem.conv{i}", tree["stem"][f"conv{i}"])
    for key in sorted(k for k in tree if k.startswith("res")):
        stage, block = key.split("_")
        for conv, p in tree[key].items():
            _convnorm(out, f"{prefix}{stage}.{block}.{conv}", p)
    for key in sorted(k for k in tree if k.startswith("plain")):
        for conv, p in tree[key].items():
            _convnorm(out, f"{prefix}{key}.{conv}", p)


def fc1_weight_from_jax(kernel) -> np.ndarray:
    """DAN fc1 ``(h, w, c, out)`` kernel -> torch ``[out, c*h*w]``."""
    k = np.asarray(kernel)
    return k.transpose(3, 2, 0, 1).reshape(k.shape[3], -1)


def _tensors(out: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    return {
        k: torch.from_numpy(np.array(v, dtype=np.float32, copy=True)) for k, v in out.items()
    }


def backbone_state_dict_from_jax(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, torch.Tensor]:
    """A ``WSRResNet``, ``VGG16``, ``SwinTransformer`` or ``SwinFPN``
    parameter tree -> its ``state_dict`` (names under ``prefix``)."""
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

    miner = heads.get("object_miner")
    if miner is not None:
        for nm in ("cls", "det"):
            out[f"roi_heads.object_miner.{nm}.weight"] = _fc(miner[nm]["kernel"])
            out[f"roi_heads.object_miner.{nm}.bias"] = miner[nm]["bias"]

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
