"""Static-shape ``Instances`` (counterpart of
``wsovod_tpu/structures/instances.py``): a fixed-capacity table of tensors
whose leading dims are ``valid.shape``, plus the boolean ``valid`` mask.
Concatenation keeps the padding; downstream ops are mask-aware."""

from __future__ import annotations

from typing import Any, Dict

import torch


class Instances:
    def __init__(self, valid: torch.Tensor, **fields: Any):
        object.__setattr__(self, "_fields", dict(fields))
        object.__setattr__(self, "valid", valid)

    def __getattr__(self, name: str) -> Any:
        fields = object.__getattribute__(self, "_fields")
        if name in fields:
            return fields[name]
        raise AttributeError(f"Instances has no field '{name}'; has {sorted(fields)}")

    def __setattr__(self, name, value):
        raise AttributeError("Instances is immutable; use .replace()")

    def fields(self) -> Dict[str, Any]:
        return dict(self._fields)

    def replace(self, **updates: Any) -> "Instances":
        new = dict(self._fields)
        valid = updates.pop("valid", self.valid)
        new.update(updates)
        return Instances(valid, **new)

    def __repr__(self) -> str:
        fs = ", ".join(f"{k}:{tuple(v.shape)}" for k, v in sorted(self._fields.items()))
        return f"Instances(valid:{tuple(self.valid.shape)}, {fs})"


def cat_instances(*instances: Instances) -> Instances:
    """Concatenate along the instance (last ``valid``) axis; shared fields
    only. Floating fields of different dtypes promote as in ``torch.cat``."""
    assert instances
    keys = set(instances[0]._fields)
    for ins in instances[1:]:
        keys &= set(ins._fields)
    axis = instances[0].valid.dim() - 1
    valid = torch.cat([i.valid for i in instances], dim=axis)
    fields = {k: torch.cat([i._fields[k] for i in instances], dim=axis) for k in sorted(keys)}
    return Instances(valid, **fields)
