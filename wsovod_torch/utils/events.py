"""Metric storage and writers (counterpart of ``wsovod_tpu/utils/events.py``,
d2's ``EventStorage``, ``JSONWriter`` and ``CommonMetricPrinter``)."""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict, Optional

logger = logging.getLogger(__name__)


class EventStorage:
    """The latest value of each scalar and the iteration it belongs to."""

    def __init__(self, start_iter: int = 0):
        self.iter = start_iter
        self._latest: Dict[str, float] = {}

    def put_scalar(self, name: str, value):
        self._latest[name] = float(value)

    def put_scalars(self, **kwargs):
        for k, v in kwargs.items():
            self.put_scalar(k, v)

    def latest(self) -> Dict[str, float]:
        return dict(self._latest)


class JSONWriter:
    """Appends one JSON line of the latest scalars per ``write``."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "a")

    def write(self, storage: EventStorage):
        self._f.write(json.dumps({"iteration": storage.iter, **storage.latest()}) + "\n")
        self._f.flush()

    def close(self):
        self._f.close()


class CommonMetricPrinter:
    """Logs the losses and the seconds per iteration since the last write."""

    def __init__(self, max_iter: Optional[int] = None):
        self.max_iter = max_iter
        self._last_time = time.perf_counter()
        self._last_iter = None

    def write(self, storage: EventStorage):
        now = time.perf_counter()
        it = storage.iter
        rate = ""
        if self._last_iter is not None and it > self._last_iter:
            sec_per_iter = (now - self._last_time) / (it - self._last_iter)
            rate = f" {sec_per_iter:.3f}s/it"
            if self.max_iter:
                rate += f" eta {sec_per_iter * (self.max_iter - it) / 3600:.1f}h"
        self._last_time = now
        self._last_iter = it
        losses = "  ".join(f"{k}: {v:.4g}" for k, v in sorted(storage.latest().items())
                           if "loss" in k)
        logger.info("iter %d  %s%s", it, losses, rate)

    def close(self):
        pass
