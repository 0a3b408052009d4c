"""One training iteration (counterpart of
``wsovod_tpu/engine/train_loop.py:42-95``): the losses, their sum, the
backward pass, and every ``WSOVOD.ITER_SIZE`` iterations one optimizer
update on the mean gradient (optax ``MultiSteps``), clipped if
``SOLVER.CLIP_GRADIENTS`` asks, at the schedule's rate for the update
count. The metrics are the losses, ``total_loss`` and ``grad_norm``, the
global norm of the iteration's own gradients (before accumulation) over the
trainable parameters. (The JAX package's norm also counts the gradients of
frozen leaves, which are zero with ``FREEZE_AT >= 5``.)

The phases are separate methods so a caller can time them; ``__call__``
runs them in order.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ..solver.build import make_lr_schedule


class TrainStep:
    def __init__(self, model: nn.Module, optimizer: torch.optim.Optimizer, cfg,
                 generator: Optional[torch.Generator] = None):
        self.model = model
        self.optimizer = optimizer
        self.generator = generator
        self.schedule = make_lr_schedule(cfg)
        self.iter_size = max(1, int(cfg.WSOVOD.ITER_SIZE))
        clip = cfg.SOLVER.CLIP_GRADIENTS
        self.clip = (clip.CLIP_TYPE, float(clip.CLIP_VALUE)) if clip.ENABLED else None
        self.params = [p for p in model.parameters() if p.requires_grad]
        self.step = 0  # iterations taken (the RPN ramp's iteration)
        self.updates = 0  # optimizer updates (the schedule's count)

    def forward(self, batch: Dict[str, torch.Tensor],
                embeddings: Optional[torch.Tensor]) -> Dict[str, torch.Tensor]:
        return self.model.forward_train(batch, embeddings, iteration=self.step,
                                        generator=self.generator)

    def backward(self, losses: Dict[str, torch.Tensor]):
        """Add this iteration's gradients to the accumulated ones; returns
        ``(total_loss, grad_norm)``."""
        total = sum(losses.values())
        grads = torch.autograd.grad(total, self.params, allow_unused=True)
        norms = []
        for p, g in zip(self.params, grads):
            if g is None:
                continue
            norms.append(torch.linalg.vector_norm(g.float()))
            if p.grad is None:
                p.grad = g
            else:
                p.grad.add_(g)
        norm = torch.linalg.vector_norm(torch.stack(norms)) if norms else total.new_zeros(())
        return total.detach(), norm

    def update(self) -> bool:
        """Count the iteration; on every ``iter_size``-th, average, clip and
        apply the accumulated gradients. Returns whether it updated."""
        self.step += 1
        if self.step % self.iter_size:
            return False
        grads = [p.grad for p in self.params if p.grad is not None]
        if self.iter_size > 1:
            torch._foreach_div_(grads, float(self.iter_size))
        if self.clip is not None:
            kind, value = self.clip
            if kind == "value":
                for g in grads:
                    g.clamp_(-value, value)
            else:  # optax clip_by_global_norm
                norm = torch.linalg.vector_norm(
                    torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))
                scale = torch.where(norm < value, torch.ones_like(norm), value / norm)
                torch._foreach_mul_(grads, scale)
        lr = self.schedule(self.updates)
        for group in self.optimizer.param_groups:
            group["lr"] = lr * group["lr_mult"]
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        self.updates += 1
        return True

    def __call__(self, batch: Dict[str, torch.Tensor],
                 embeddings: Optional[torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One iteration; the metrics stay on the device."""
        losses = self.forward(batch, embeddings)
        total, norm = self.backward(losses)
        self.update()
        return {"total_loss": total, **{k: v.detach() for k, v in losses.items()},
                "grad_norm": norm}
