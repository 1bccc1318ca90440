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


def bands(multires: int, dtype: torch.dtype, device) -> torch.Tensor:
    """``freq_bands(multires)`` as a tensor made on ``device``, as ``1 <<
    k`` (exact powers of two, so the same bits), with no copy from the
    host and so no wait on the device."""
    k = torch.arange(multires, device=device)
    return torch.bitwise_left_shift(torch.ones_like(k), k).to(dtype)


def embed(x: torch.Tensor, multires: int, pi_bands: bool = False
          ) -> torch.Tensor:
    """gamma(x): [..., d] -> [..., d * (1 + 2*multires)]."""
    if multires <= 0:
        return x
    b = bands(multires, x.dtype, x.device)
    if pi_bands:
        b = b * math.pi
    xb = x[..., None, :] * b[:, None]                      # [..., F, d]
    sc = torch.stack([torch.sin(xb), torch.cos(xb)], dim=-2)  # [..., F, 2, d]
    sc = sc.reshape(*x.shape[:-1], 2 * multires * x.shape[-1])
    return torch.cat([x, sc], dim=-1)
