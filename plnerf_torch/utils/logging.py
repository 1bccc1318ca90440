"""Training observability (port of ``plnerf/utils/logging.py``): every
scalar goes to an append-only ``metrics.jsonl`` and every image to a png,
``<log_dir>/<tag>_<step>.png``.

Unlike the JAX package's logger, nothing goes to TensorBoard: where
TensorFlow is installed, importing ``torch.utils.tensorboard`` loads it,
and with it PIL and cv2, which the port never loads; its image summaries
need PIL in any case.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict

from ..data.png import write_png
from .misc import to8b


class MetricsLogger:
    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self._dir = log_dir
        self._f = open(os.path.join(log_dir, "metrics.jsonl"), "a")

    def scalars(self, step: int, values: Dict[str, float],
                prefix: str = "") -> None:
        rec = {"step": int(step), "ts": time.time()}
        for k, v in values.items():
            rec[prefix + k] = float(v)
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def image(self, step: int, tag: str, img) -> str:
        """Write ``img`` ([H, W, 3] in [0, 1]) as an 8-bit png; returns
        its path (a ``/`` in ``tag`` makes a subdirectory)."""
        path = os.path.join(self._dir, f"{tag}_{int(step):06d}.png")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        write_png(path, to8b(img))
        return path

    def close(self) -> None:
        self._f.close()
