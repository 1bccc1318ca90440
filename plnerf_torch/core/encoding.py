"""Sinusoidal positional encoding (port of ``plnerf/core/encoding.py``).

Channel order ``[x, sin(f0 x), cos(f0 x), sin(f1 x), cos(f1 x), ...]``
with log-spaced bands 2^0 .. 2^(multires-1); ``pi_bands`` multiplies the
bands by pi (depth-experiments variant).
"""
from __future__ import annotations

import math

import numpy as np
import torch


def freq_bands(multires: int) -> np.ndarray:
    """Log-spaced bands 2**linspace(0, multires-1, multires)."""
    return 2.0 ** np.linspace(0.0, multires - 1, multires)


def embed(x: torch.Tensor, multires: int, pi_bands: bool = False
          ) -> torch.Tensor:
    """gamma(x): [..., d] -> [..., d * (1 + 2*multires)]."""
    if multires <= 0:
        return x
    bands = torch.as_tensor(freq_bands(multires), dtype=x.dtype,
                            device=x.device)
    if pi_bands:
        bands = bands * math.pi
    xb = x[..., None, :] * bands[:, None]                  # [..., F, d]
    sc = torch.stack([torch.sin(xb), torch.cos(xb)], dim=-2)  # [..., F, 2, d]
    sc = sc.reshape(*x.shape[:-1], 2 * multires * x.shape[-1])
    return torch.cat([x, sc], dim=-1)
