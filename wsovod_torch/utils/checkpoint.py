"""Training checkpoints with ``torch.save`` (counterpart of
``wsovod_tpu/utils/checkpoint.py``, which saves with orbax).

A checkpoint holds the model's ``state_dict`` (reference names and
layouts), the optimizer's (momentum buffers), the iteration and update
counts, the generator's state and, when saved between two updates of an
``ITER_SIZE`` accumulation, the accumulated gradients; so a resumed run
continues where the saved one stopped. ``last_checkpoint`` names the newest.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import torch
from torch import nn

from ..engine.train_loop import TrainStep

logger = logging.getLogger(__name__)


class Checkpointer:
    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, name: str) -> str:
        return os.path.join(self.directory, name + ".pth")

    def save(self, name: str, model: nn.Module, step: TrainStep) -> None:
        """Write ``<name>.pth`` (through a temporary file, so a reader never
        sees half of it), then point ``last_checkpoint`` at it."""
        names = {id(p): n for n, p in model.named_parameters()}
        state = {
            "model": model.state_dict(),
            "optimizer": step.optimizer.state_dict(),
            "step": step.step,
            "updates": step.updates,
            "generator": None if step.generator is None else step.generator.get_state(),
            "acc_grads": {names[id(p)]: p.grad for p in step.params if p.grad is not None},
        }
        path = self._path(name)
        torch.save(state, path + ".tmp")
        os.replace(path + ".tmp", path)
        with open(os.path.join(self.directory, "last_checkpoint"), "w") as f:
            f.write(name)
        logger.info("saved checkpoint %s", path)

    def last_checkpoint_name(self) -> Optional[str]:
        marker = os.path.join(self.directory, "last_checkpoint")
        if not os.path.exists(marker):
            return None
        with open(marker) as f:
            return f.read().strip()

    def load(self, name: str, model: nn.Module, step: TrainStep) -> None:
        """Restore everything ``save`` wrote into ``model`` and ``step``."""
        device = next(model.parameters()).device
        state = torch.load(self._path(name), map_location="cpu", weights_only=True)
        model.load_state_dict(state["model"])
        step.optimizer.load_state_dict(state["optimizer"])
        step.step, step.updates = int(state["step"]), int(state["updates"])
        if step.generator is not None and state["generator"] is not None:
            step.generator.set_state(state["generator"])
        params = dict(model.named_parameters())
        for n, g in state["acc_grads"].items():
            params[n].grad = g.to(device)

    def resume_or_load(self, model: nn.Module, step: TrainStep, weights_path: str,
                       resume: bool) -> bool:
        """With ``resume`` and a ``last_checkpoint``, restore it and return
        True. Otherwise load ``weights_path`` (a ``torch.save`` file of a
        ``state_dict``, or of a dict holding one under ``"model"``; names as
        the port's) into the model, if given, and return False."""
        name = self.last_checkpoint_name() if resume else None
        if name is not None:
            self.load(name, model, step)
            logger.info("resumed from %s at iteration %d", name, step.step)
            return True
        if weights_path:
            if not os.path.isfile(weights_path):
                raise FileNotFoundError(f"MODEL.WEIGHTS {weights_path} does not exist")
            blob = torch.load(weights_path, map_location="cpu", weights_only=True)
            missing, unexpected = model.load_state_dict(blob.get("model", blob), strict=False)
            logger.info("loaded %s (missing %d keys, unexpected %d)", weights_path,
                        len(missing), len(unexpected))
        return False
