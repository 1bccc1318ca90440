"""Volume-rendering quadrature (port of ``plnerf/core/quadrature.py``):
piecewise-constant and the paper's piecewise-linear weights, and
``raw2outputs`` compositing.

Shapes (R rays, S samples): constant weights [R, S]; linear augments z
with near/far (S+2 boundaries, S+1 intervals): tau [R, S+2],
T [R, S+2], weights [R, S+1].
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F

TAU_NEAR = 1e-10  # tau at the near boundary (reference run_plnerf.py:528)
TAU_FAR = 1e10    # tau at the far boundary ("will hit an opaque surface")

Noise = Union[torch.Tensor, float]


def _ray_norm(rays_d: torch.Tensor) -> torch.Tensor:
    return torch.linalg.norm(rays_d[..., None, :], dim=-1)   # [R, 1]


def compute_weights_constant(sigma: torch.Tensor, z_vals: torch.Tensor,
                             rays_d: torch.Tensor, noise: Noise = 0.0
                             ) -> torch.Tensor:
    """Classic NeRF alpha compositing weights. sigma: [R, S] raw density."""
    dists = z_vals[..., 1:] - z_vals[..., :-1]
    dists = torch.cat([dists, torch.full_like(dists[..., :1], 1e10)], dim=-1)
    dists = dists * _ray_norm(rays_d)
    alpha = 1.0 - torch.exp(-F.relu(sigma + noise) * dists)
    ones = torch.ones_like(alpha[..., :1])
    trans = torch.cumprod(
        torch.cat([ones, 1.0 - alpha + 1e-10], dim=-1), dim=-1)[..., :-1]
    return alpha * trans


def compute_weights_piecewise_linear(
    sigma: torch.Tensor, z_vals: torch.Tensor, near: torch.Tensor,
    far: torch.Tensor, rays_d: torch.Tensor, noise: Noise = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Piecewise-linear-density weights with exact closed-form
    transmittance.  sigma, z_vals: [R, S]; near/far: [R, 1].
    Returns (weights [R, S+1], tau [R, S+2], T [R, S+2])."""
    z_aug = torch.cat([near, z_vals, far], dim=-1)               # [R, S+2]
    dists = (z_aug[..., 1:] - z_aug[..., :-1]) * _ray_norm(rays_d)
    tau = torch.cat([torch.full_like(sigma[..., :1], TAU_NEAR),
                     sigma + noise,
                     torch.full_like(sigma[..., :1], TAU_FAR)], dim=-1)
    tau = F.relu(tau)                                            # [R, S+2]
    interval_ave_tau = 0.5 * (tau[..., 1:] + tau[..., :-1])      # [R, S+1]
    expr = torch.exp(-interval_ave_tau * dists)
    ones = torch.ones_like(expr[..., :1])
    T = torch.cumprod(torch.cat([ones, expr], dim=-1), dim=-1)   # [R, S+2]
    weights = (1.0 - expr) * T[..., :-1]                         # [R, S+1]
    return weights, tau, T


def raw2outputs(raw: torch.Tensor, z_vals: torch.Tensor, near: torch.Tensor,
                far: torch.Tensor, rays_d: torch.Tensor, mode: str,
                color_mode: str = "midpoint", noise: Noise = 0.0,
                white_bkgd: bool = False, farcolorfix: bool = False
                ) -> Dict[str, Optional[torch.Tensor]]:
    """Composite raw network output [R, S, 4] into per-ray maps: rgb,
    disp, acc, weights, depth, tau, T (tau/T None in constant mode)."""
    rgb = torch.sigmoid(raw[..., :3])                            # [R, S, 3]

    if mode == "linear":
        weights, tau, T = compute_weights_piecewise_linear(
            raw[..., 3], z_vals, near, far, rays_d, noise)
        first = rgb[:, :1, :]
        last = torch.zeros_like(rgb[:, -1:, :]) if farcolorfix \
            else rgb[:, -1:, :]
        if color_mode == "midpoint":
            rgb_cat = torch.cat([first, rgb, last], dim=1)       # [R, S+2, 3]
            rgb_used = 0.5 * (rgb_cat[:, 1:, :] + rgb_cat[:, :-1, :])
        elif color_mode == "left":
            rgb_used = torch.cat([first, rgb], dim=1)            # [R, S+1, 3]
        elif color_mode == "tau_weighted":
            rgb_cat = torch.cat([first, rgb, last], dim=1)
            tl, tr = tau[..., :-1, None], tau[..., 1:, None]
            mid = 0.5 * (rgb_cat[:, 1:, :] + rgb_cat[:, :-1, :])
            tw = (tl * rgb_cat[:, :-1, :] + tr * rgb_cat[:, 1:, :]) / (
                tl + tr + 1e-12)
            rgb_used = torch.where((tl + tr) < 1e-9, mid, tw)
        else:
            raise ValueError(f"unknown color_mode {color_mode!r}")
        rgb_map = torch.sum(weights[..., None] * rgb_used, dim=-2)
        z_aug = torch.cat([near, z_vals, far], dim=-1)
        z_mid = 0.5 * (z_aug[..., 1:] + z_aug[..., :-1])
        depth_map = torch.sum(weights * z_mid, dim=-1)
    elif mode == "constant":
        weights = compute_weights_constant(raw[..., 3], z_vals, rays_d, noise)
        rgb_map = torch.sum(weights[..., None] * rgb, dim=-2)
        depth_map = torch.sum(weights * z_vals, dim=-1)
        tau = None
        T = None
    else:
        raise ValueError(f"unknown mode {mode!r}")

    acc_map = torch.sum(weights, dim=-1)
    # maximum propagates NaN (0/0 on an empty ray) exactly as jnp.maximum
    disp_map = 1.0 / torch.maximum(depth_map / acc_map,
                                   depth_map.new_tensor(1e-10))
    if white_bkgd:
        rgb_map = rgb_map + (1.0 - acc_map[..., None])
    return {"rgb_map": rgb_map, "disp_map": disp_map, "acc_map": acc_map,
            "weights": weights, "depth_map": depth_map, "tau": tau, "T": T}
