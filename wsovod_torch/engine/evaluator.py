"""Dataset evaluation loop (counterpart of
``wsovod_tpu/engine/evaluator.py::inference_on_dataset``), the slice's entry
point.

Runs the model's inference forward over a loader of padded batch dicts,
rescales each image's detections to its original size on the host and feeds
them to an evaluator (``process(image_id, boxes, scores, classes)``, then
``evaluate()``). The dataset CLI and the port-side VOC/COCO evaluators come
later.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, Iterable, Optional

import numpy as np
import torch

logger = logging.getLogger(__name__)

DEVICE_KEYS = ("images", "image_sizes", "sam_boxes", "sam_scores", "sam_valid")


def _to_device(batch: Dict, device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(batch[k]).to(device, non_blocking=True)
            for k in DEVICE_KEYS if k in batch and batch[k] is not None}


def inference_on_dataset(model, loader: Iterable[Dict], evaluator,
                         embeddings: Optional[torch.Tensor] = None,
                         classifier: Optional[torch.Tensor] = None):
    """Feed every batch through ``model`` under ``torch.inference_mode()``.

    A batch holds ``images``, ``image_sizes``, ``sam_boxes``,
    ``sam_scores``, ``sam_valid`` (arrays or tensors) and, for the host side,
    ``image_id`` and optionally ``orig_size`` (default: ``image_sizes``) and
    ``batch_valid``. The forward of batch i+1 is enqueued before batch i's
    detections are copied back, so the host work overlaps the device's.
    Returns ``evaluator.evaluate()``."""
    device = model.device
    emb = embeddings.to(device) if embeddings is not None else None
    cls = classifier.to(device) if classifier is not None else None
    n_images = 0

    def consume(batch, det):
        nonlocal n_images
        boxes_all = det.boxes.cpu().numpy()
        scores_all = det.scores.cpu().numpy()
        classes_all = det.classes.cpu().numpy()
        valid_all = det.valid.cpu().numpy()
        image_sizes = np.asarray(batch["image_sizes"])
        orig_sizes = np.asarray(batch.get("orig_size", image_sizes))
        batch_valid = np.asarray(batch.get("batch_valid", np.ones(len(image_sizes), bool)))
        for i in range(len(image_sizes)):
            if not batch_valid[i]:
                continue
            n_images += 1
            v = valid_all[i]
            sy = orig_sizes[i][0] / max(image_sizes[i][0], 1)
            sx = orig_sizes[i][1] / max(image_sizes[i][1], 1)
            boxes = boxes_all[i][v] * np.array([sx, sy, sx, sy], np.float32)
            boxes[:, 0::2] = np.clip(boxes[:, 0::2], 0, orig_sizes[i][1])
            boxes[:, 1::2] = np.clip(boxes[:, 1::2], 0, orig_sizes[i][0])
            evaluator.process(batch["image_id"][i], boxes, scores_all[i][v], classes_all[i][v])

    t0 = time.perf_counter()
    pending = None
    with torch.inference_mode():
        for batch in loader:
            det, _, _ = model(_to_device(batch, device), embeddings=emb, classifier=cls)
            if pending is not None:
                consume(*pending)
            pending = (batch, det)
        if pending is not None:
            consume(*pending)
    dt = time.perf_counter() - t0
    if n_images:
        logger.info("inference done: %d images in %.3fs (%.3f img/s)", n_images, dt, n_images / dt)
    return evaluator.evaluate()
