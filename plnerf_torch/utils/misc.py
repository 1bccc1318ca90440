"""Small shared utilities (own copy of ``plnerf/utils/misc.py``:
``img2mse`` / ``mse2psnr`` on tensors, ``to8b`` / ``to16b`` and
``MeanTracker`` on the host)."""
from __future__ import annotations

import math

import numpy as np
import torch


def img2mse(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.mean((x - y) ** 2)


def mse2psnr(mse: torch.Tensor) -> torch.Tensor:
    return -10.0 * torch.log(mse) / math.log(10.0)


def to8b(x) -> np.ndarray:
    return (255 * np.clip(np.asarray(x), 0, 1)).astype(np.uint8)


def to16b(x) -> np.ndarray:
    return ((2 ** 16 - 1) * np.clip(np.asarray(x), 0, 1)).astype(np.uint16)


class MeanTracker:
    """Running weighted means of metric dicts (reference
    run_nerf_helpers.py:541-570)."""

    def __init__(self):
        self.mean_dict = {}
        self.notes = {}
        self.total_weight = 0.0

    def add(self, metrics: dict, weight: float = 1.0):
        for key, value in metrics.items():
            prev = self.mean_dict.get(key, 0.0)
            self.mean_dict[key] = (prev * self.total_weight + value) / (
                self.total_weight + weight)
        self.total_weight += weight

    def get(self, key):
        return self.mean_dict[key]

    def as_dict(self):
        return dict(self.mean_dict)

    def note(self, key: str, text: str):
        """Non-numeric annotation printed after the means (e.g. ``lpips:
        UNAVAILABLE (...)``: a consumer diffing metrics.txt against the
        reference must see the metric named, not silently missing)."""
        self.notes[key] = text

    def print(self, f=None):
        for key, value in self.mean_dict.items():
            print(f"{key}: {value}", file=f)
        for key, text in self.notes.items():
            print(f"{key}: {text}", file=f)
