"""Hierarchical config system: the port's own copy of
``wsovod_tpu/config/config.py``.

A small yacs/Detectron2-`CfgNode`-compatible config tree so that the reference's
YAML files (`configs/**/*.yaml`, with `_BASE_` inheritance and dotted CLI
overrides — reference `tools/train_net.py:31-42`) load unchanged. Pure Python,
no external deps beyond PyYAML; the port imports nothing of ``wsovod_tpu``.
"""

from __future__ import annotations

import copy
import os
from typing import Any, Dict, List

import yaml

_BASE_KEY = "_BASE_"


class CfgNode(dict):
    """A dict with attribute access, freezing, YAML loading and merging."""

    IMMUTABLE = "__immutable__"

    def __init__(self, init_dict: Dict | None = None):
        init_dict = {} if init_dict is None else init_dict
        super().__init__()
        object.__setattr__(self, CfgNode.IMMUTABLE, False)
        for k, v in init_dict.items():
            if isinstance(v, dict):
                v = CfgNode(v)
            dict.__setitem__(self, k, v)

    # -- attribute access -------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        if name in self:
            return self[name]
        raise AttributeError(
            f"Config has no attribute '{name}'. Available: {sorted(self.keys())}"
        )

    def __setattr__(self, name: str, value: Any) -> None:
        if object.__getattribute__(self, CfgNode.IMMUTABLE):
            raise AttributeError(f"CfgNode is frozen; cannot set {name}")
        if isinstance(value, dict) and not isinstance(value, CfgNode):
            value = CfgNode(value)
        self[name] = value

    def __setitem__(self, name: str, value: Any) -> None:
        if object.__getattribute__(self, CfgNode.IMMUTABLE):
            raise AttributeError(f"CfgNode is frozen; cannot set {name}")
        dict.__setitem__(self, name, value)

    # -- freeze -----------------------------------------------------------
    def freeze(self) -> "CfgNode":
        object.__setattr__(self, CfgNode.IMMUTABLE, True)
        for v in self.values():
            if isinstance(v, CfgNode):
                v.freeze()
        return self

    def defrost(self) -> "CfgNode":
        object.__setattr__(self, CfgNode.IMMUTABLE, False)
        for v in self.values():
            if isinstance(v, CfgNode):
                v.defrost()
        return self

    def is_frozen(self) -> bool:
        return object.__getattribute__(self, CfgNode.IMMUTABLE)

    def clone(self) -> "CfgNode":
        return copy.deepcopy(self)

    def __deepcopy__(self, memo):
        out = CfgNode()
        memo[id(self)] = out
        for k, v in self.items():
            dict.__setitem__(out, copy.deepcopy(k, memo), copy.deepcopy(v, memo))
        return out

    def __reduce__(self):
        return (CfgNode, (self.to_dict(),))

    def to_dict(self) -> Dict:
        out = {}
        for k, v in self.items():
            out[k] = v.to_dict() if isinstance(v, CfgNode) else v
        return out

    # -- merging ----------------------------------------------------------
    def merge_from_other_cfg(self, other: "CfgNode") -> None:
        _merge_a_into_b(other, self)

    def merge_from_file(self, cfg_filename: str, allow_unsafe: bool = True) -> None:
        loaded = load_yaml_with_base(cfg_filename)
        _merge_a_into_b(CfgNode(loaded), self)

    def merge_from_list(self, opts: List[str]) -> None:
        assert len(opts) % 2 == 0, f"Override list has odd length: {opts}"
        for full_key, v in zip(opts[0::2], opts[1::2]):
            d = self
            key_parts = full_key.split(".")
            for sub in key_parts[:-1]:
                assert sub in d, f"Non-existent key: {full_key}"
                d = d[sub]
            sub = key_parts[-1]
            assert sub in d, f"Non-existent key: {full_key}"
            d[sub] = _decode_value(v, d[sub], full_key)

    def dump(self, **kwargs) -> str:
        return yaml.safe_dump(self.to_dict(), **kwargs)

    def __str__(self) -> str:
        def _indent(s, n):
            return "\n".join((n * " ") + line for line in s.split("\n"))

        lines = []
        for k in sorted(self.keys()):
            v = self[k]
            if isinstance(v, CfgNode):
                lines.append(f"{k}:")
                lines.append(_indent(str(v), 2))
            else:
                lines.append(f"{k}: {v}")
        return "\n".join(lines)


def _decode_value(value: str, original: Any, full_key: str) -> Any:
    """Parse a CLI string override to the type of the existing value."""
    if not isinstance(value, str):
        return value
    try:
        parsed = yaml.safe_load(value)
    except yaml.YAMLError:
        parsed = value
    if original is None:
        return parsed
    if isinstance(original, bool) and not isinstance(parsed, bool):
        raise ValueError(f"Cannot override bool {full_key} with {value!r}")
    if isinstance(original, (list, tuple)) and isinstance(parsed, (list, tuple)):
        return type(original)(parsed)
    if isinstance(original, float) and isinstance(parsed, int):
        return float(parsed)
    return parsed


def _literal_eval_str(v: Any) -> Any:
    """yacs-style decoding: YAML leaves things like ``(140000,)`` as strings;
    try to interpret them as Python literals."""
    if not isinstance(v, str):
        return v
    try:
        import ast

        parsed = ast.literal_eval(v)
        if not isinstance(parsed, str):
            return parsed
    except (ValueError, SyntaxError):
        pass
    return v


def _merge_a_into_b(a: Dict, b: CfgNode, path: str = "") -> None:
    for k, v in a.items():
        full = f"{path}.{k}" if path else k
        if isinstance(v, dict):
            if k not in b or not isinstance(b[k], CfgNode):
                dict.__setitem__(b, k, CfgNode())
            _merge_a_into_b(v, b[k], full)
        else:
            if not (k in b and isinstance(b[k], str)):
                v = _literal_eval_str(v)
            if k in b and b[k] is not None and v is not None:
                orig = b[k]
                if isinstance(orig, (list, tuple)) and isinstance(v, (list, tuple)):
                    v = type(orig)(v)
                elif isinstance(orig, float) and isinstance(v, int):
                    v = float(v)
                elif (
                    not isinstance(v, type(orig))
                    and not (isinstance(v, (int, float)) and isinstance(orig, (int, float)))
                ):
                    raise ValueError(
                        f"Type mismatch for {full}: {type(orig).__name__} vs {type(v).__name__}"
                    )
            dict.__setitem__(b, k, v)


def load_yaml_with_base(filename: str) -> Dict:
    """Load a YAML file, recursively resolving `_BASE_` inheritance."""
    with open(filename, "r") as f:
        cfg = yaml.safe_load(f)
    if cfg is None:
        cfg = {}
    base_cfg: Dict = {}
    if _BASE_KEY in cfg:
        base_filename = cfg.pop(_BASE_KEY)
        if not os.path.isabs(base_filename):
            base_filename = os.path.join(os.path.dirname(filename), base_filename)
        base_cfg = load_yaml_with_base(base_filename)
    merged = CfgNode(base_cfg)
    _merge_a_into_b(cfg, merged)
    return merged.to_dict()
