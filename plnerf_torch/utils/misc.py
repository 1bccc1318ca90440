"""Photometric metrics (own copy of ``plnerf/utils/misc.py``
``img2mse`` / ``mse2psnr``)."""
from __future__ import annotations

import math

import torch


def img2mse(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.mean((x - y) ** 2)


def mse2psnr(mse: torch.Tensor) -> torch.Tensor:
    return -10.0 * torch.log(mse) / math.log(10.0)
