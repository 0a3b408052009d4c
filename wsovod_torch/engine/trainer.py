"""The trainer (counterpart of ``wsovod_tpu/engine/trainer.py:48-290``):
builds the model, optimizer and checkpointer from a config, then runs
``SOLVER.MAX_ITER`` iterations over a loader, writing metrics (to the log
and ``OUTPUT_DIR/metrics.json``) on the first, every 20th and the last
iteration and checkpoints every ``SOLVER.CHECKPOINT_PERIOD``.

The loader is any iterator of padded batch dicts (``images``,
``image_sizes``, ``sam_boxes``, ``sam_scores``, ``sam_valid``,
``gt_classes``, ``gt_valid``); the dataset loader is not ported yet. The
port runs on one card, so ``auto_scale_workers`` scales the recipe to one
worker (``BASE_LR`` divided and ``ITER_SIZE`` multiplied by
``REFERENCE_WORLD_SIZE``), as the JAX trainer on one chip.

``WSOVOD.BBOX_REFINE`` (SAM refinement of the mined boxes) turns itself off
with a warning when its SAM checkpoint is absent, as in the JAX trainer;
the SAM refiner itself is not ported, so a present checkpoint raises.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Iterator

import torch

from ..config import check_train_supported
from ..models import build_model
from ..solver.build import auto_scale_workers, build_optimizer
from ..utils.checkpoint import Checkpointer
from ..utils.events import CommonMetricPrinter, EventStorage, JSONWriter
from .train_loop import TrainStep

logger = logging.getLogger(__name__)

BATCH_KEYS = ("images", "image_sizes", "sam_boxes", "sam_scores", "sam_valid", "gt_classes",
              "gt_valid")


class WSOVODTrainer:
    def __init__(self, cfg, loader: Iterator[Dict], embeddings: torch.Tensor,
                 resume: bool = False, device=None):
        """``embeddings [C, D]``: the training classes' CLIP text embeddings
        (``OPEN_VOCABULARY.WEIGHT_PATH_TRAIN`` in the JAX trainer).
        ``device``: default ``cfg.MODEL.DEVICE`` (``cuda``)."""
        cfg = auto_scale_workers(cfg, 1)
        cfg = self._bbox_refine(cfg)
        check_train_supported(cfg)
        self.cfg = cfg
        self.device = torch.device(device if device is not None else cfg.MODEL.DEVICE)
        seed = cfg.SEED if cfg.SEED >= 0 else 0
        self.model = build_model(cfg, device=self.device, seed=seed).train()
        self.generator = torch.Generator(device=self.device).manual_seed(seed + 1)
        self.step = TrainStep(self.model, build_optimizer(cfg, self.model), cfg, self.generator)
        self.embeddings = embeddings.to(self.device)
        self.loader = loader
        self.checkpointer = Checkpointer(cfg.OUTPUT_DIR)
        self.resumed = self.checkpointer.resume_or_load(self.model, self.step, cfg.MODEL.WEIGHTS,
                                                        resume)
        self.storage = EventStorage(self.step.step)
        self.writers = [CommonMetricPrinter(cfg.SOLVER.MAX_ITER),
                        JSONWriter(os.path.join(cfg.OUTPUT_DIR, "metrics.json"))]

    @staticmethod
    def _bbox_refine(cfg):
        br = cfg.WSOVOD.BBOX_REFINE
        if not br.ENABLE:
            return cfg
        if os.path.exists(br.MODEL_CHECKPOINT):
            raise NotImplementedError(
                f"WSOVOD.BBOX_REFINE.ENABLE=True with the SAM checkpoint {br.MODEL_CHECKPOINT}: "
                "the SAM box refiner is not ported to wsovod_torch yet")
        logger.warning("BBOX_REFINE enabled but SAM checkpoint %s not found; pseudo-GT "
                       "refinement disabled", br.MODEL_CHECKPOINT)
        cfg = cfg.clone()
        frozen = cfg.is_frozen()
        cfg.defrost()
        cfg.WSOVOD.BBOX_REFINE.ENABLE = False
        if frozen:
            cfg.freeze()
        return cfg

    def device_batch(self, batch: Dict) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(batch[k]).to(self.device, non_blocking=True)
                for k in BATCH_KEYS if batch.get(k) is not None}

    def run_step(self) -> Dict[str, torch.Tensor]:
        """One iteration on the loader's next batch; metrics on the device."""
        return self.step(self.device_batch(next(self.loader)), self.embeddings)

    def save(self, name: str) -> None:
        self.checkpointer.save(name, self.model, self.step)

    def train(self) -> None:
        """Iterate from the current iteration to ``SOLVER.MAX_ITER``, then
        save ``model_final``."""
        cfg = self.cfg
        max_iter = cfg.SOLVER.MAX_ITER
        start = self.step.step
        logger.info("training from iter %d to %d", start, max_iter)
        try:
            for it in range(start, max_iter):
                metrics = self.run_step()
                self.storage.iter = it
                if (it + 1) % 20 == 0 or it in (start, max_iter - 1):
                    self.storage.put_scalars(**{k: float(v) for k, v in metrics.items()})
                    for w in self.writers:
                        w.write(self.storage)
                if (it + 1) % cfg.SOLVER.CHECKPOINT_PERIOD == 0:
                    self.save(f"model_{it:07d}")
            self.save("model_final")
        finally:
            for w in self.writers:
                w.close()
