"""Optimizer, LR schedule and worker scaling (counterpart of
``wsovod_tpu/solver/build.py``, which builds them with optax).

* ``param_labels``: frozen / backbone / bias / default per parameter. The
  frozen-BN statistics are buffers here, and the stages up to ``FREEZE_AT``
  have ``requires_grad`` off (``WSRResNet.freeze``, ``VGG16.freeze``, by
  the JAX package's stage rule, ``wsovod_tpu/solver/build.py:22-31``), so
  "frozen" is exactly the backbone parameters without a gradient; every
  other backbone parameter, VGG's conv biases too, is "backbone".
* ``make_lr_schedule``: WarmupMultiStep as a function of the optimizer
  update count.
* ``build_optimizer``: ``torch.optim.SGD`` with one parameter group per
  label (LR x ``BIAS_LR_FACTOR`` and ``WEIGHT_DECAY_BIAS`` for biases, LR x
  ``BACKBONE_MULTIPLIER`` for the backbone). optax's chain
  ``add_decayed_weights`` -> ``sgd(momentum)`` is ``v = m * v + (g + wd *
  p); p -= lr * v`` with ``v`` starting at 0, which is ``torch.optim.SGD``'s
  update with dampening 0 (its first step sets ``v = g + wd * p``, the
  same). The schedule is evaluated at the update count before the update,
  as optax's ``scale_by_schedule``.
* ``ITER_SIZE`` accumulation and gradient clipping live in
  ``engine/train_loop.py``: optax's ``MultiSteps`` averages the gradients of
  ``ITER_SIZE`` calls and its inner optimizer (and schedule) counts only the
  updates; clipping acts on that mean.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
from torch import nn


def param_labels(model: nn.Module) -> Dict[str, str]:
    """``name -> "frozen" | "backbone" | "bias" | "default"`` for every
    parameter, by the JAX package's rules: a backbone parameter is "frozen"
    when its stage is frozen (``requires_grad`` off, set by the backbone's
    ``freeze``), else "backbone", a bias too."""
    labels = {}
    for name, p in model.named_parameters():
        if name.startswith("backbone."):
            labels[name] = "backbone" if p.requires_grad else "frozen"
        elif name.rsplit(".", 1)[-1] == "bias":
            labels[name] = "bias"
        else:
            labels[name] = "default"
    return labels


def make_lr_schedule(cfg) -> Callable[[int], float]:
    """``update count -> learning rate`` of ``WarmupMultiStepLR`` (float32
    arithmetic, as the JAX schedule): ``BASE_LR`` times ``GAMMA`` per passed
    step, times the linear warmup from ``WARMUP_FACTOR`` over
    ``WARMUP_ITERS`` updates."""
    s = cfg.SOLVER
    if s.LR_SCHEDULER_NAME != "WarmupMultiStepLR":
        raise NotImplementedError(f"SOLVER.LR_SCHEDULER_NAME={s.LR_SCHEDULER_NAME!r} is not ported")
    steps = [st for st in s.STEPS if st <= s.MAX_ITER]

    def schedule(count: int) -> float:
        c = torch.tensor(float(count))
        mult = torch.tensor(1.0)
        for st in steps:
            mult = mult * (s.GAMMA if count >= st else 1.0)
        warm = torch.tensor(1.0)
        if count < s.WARMUP_ITERS:
            alpha = c / max(s.WARMUP_ITERS, 1)
            warm = s.WARMUP_FACTOR * (1 - alpha) + alpha
        return float(s.BASE_LR * mult * warm)

    return schedule


def build_optimizer(cfg, model: nn.Module) -> torch.optim.SGD:
    """SGD with momentum over the trainable parameters, one group per label;
    each group's ``lr_mult`` scales the schedule's rate (set by the train
    loop before every update)."""
    s = cfg.SOLVER
    if s.OPTIMIZER.upper() != "SGD":
        raise NotImplementedError(f"SOLVER.OPTIMIZER={s.OPTIMIZER!r} is not ported")
    wd = s.WEIGHT_DECAY
    wd_bias = wd if s.WEIGHT_DECAY_BIAS is None else s.WEIGHT_DECAY_BIAS
    labels = param_labels(model)
    settings = {"default": (1.0, wd), "bias": (s.BIAS_LR_FACTOR, wd_bias),
                "backbone": (s.BACKBONE_MULTIPLIER, wd)}
    groups = []
    for label, (lr_mult, decay) in settings.items():
        params = [p for n, p in model.named_parameters() if labels[n] == label]
        if params:
            groups.append({"params": params, "lr": s.BASE_LR * lr_mult, "lr_mult": lr_mult,
                           "weight_decay": decay, "label": label})
    return torch.optim.SGD(groups, lr=s.BASE_LR, momentum=s.MOMENTUM, nesterov=s.NESTEROV)


def auto_scale_workers(cfg, num_workers: int):
    """d2's ``auto_scale_workers`` as the JAX package has it: on fewer
    workers than ``REFERENCE_WORLD_SIZE``, divide ``BASE_LR`` and multiply
    ``ITER_SIZE`` by the ratio, so the effective batch is the recipe's."""
    old_world = cfg.SOLVER.REFERENCE_WORLD_SIZE
    if old_world == 0 or old_world == num_workers:
        return cfg
    if old_world % num_workers and num_workers % old_world:
        raise ValueError(f"{num_workers} workers do not divide or multiply "
                         f"REFERENCE_WORLD_SIZE {old_world}")
    cfg = cfg.clone()
    frozen = cfg.is_frozen()
    if frozen:
        cfg.defrost()
    scale = old_world / num_workers
    cfg.SOLVER.BASE_LR = cfg.SOLVER.BASE_LR / scale
    cfg.WSOVOD.ITER_SIZE = int(round(cfg.WSOVOD.ITER_SIZE * scale))
    cfg.SOLVER.REFERENCE_WORLD_SIZE = num_workers
    if frozen:
        cfg.freeze()
    return cfg
