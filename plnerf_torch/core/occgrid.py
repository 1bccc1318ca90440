"""Occupancy-grid guided coarse sampling (port of ``plnerf/core/occgrid.py``).

A coarse density grid over an axis-aligned box decides where a fixed
number of coarse samples land: each ray tests ``candidates`` uniform bins
against the grid and places its ``n_samples`` stratified samples by
inverse CDF over ``occupied + floor`` bin weights.  The grid is a per-voxel
mean-EMA of the densities the train step already evaluates at its samples
(no extra MLP evaluations): visited voxels only, then a threshold and a
one-voxel dilation give the occupancy the sampler reads.

No reference equivalent; the JAX package's flag-gated extension
(``--occ_grid``, ``configs/blender_linear_occ.txt``).  Plain PyTorch: the
JAX package computes these in plain XLA, with no Pallas kernel.  The
per-voxel max is a ``scatter_reduce(..., "amax")``, whose result does not
depend on the order of the scattered values.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..device import DeviceLike
from . import sampling

Grid = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class OccGridConfig:
    """Static configuration (see the JAX package's ``OccGridConfig`` for
    how each default was chosen)."""
    resolution: int = 128        # G: the grid is [G, G, G]
    candidates: int = 128        # M: uniform candidate bins per ray
    decay: float = 0.7           # per-observation EMA coefficient
    threshold: float = 1e-2      # density above which a cell is occupied
    floor: float = 0.03          # PDF floor of unoccupied candidate bins
    warmup: int = 256            # drivers: uniform sampling for N steps


def init_grid(aabb_min, aabb_max, cfg: OccGridConfig,
              device: DeviceLike) -> Grid:
    """A fresh grid on ``device``: density above the threshold everywhere
    (unvisited space is presumed occupied) and ``occ`` all ones."""
    g = cfg.resolution
    return {
        "density": torch.full((g, g, g), 10.0 * cfg.threshold,
                              dtype=torch.float32, device=device),
        "occ": torch.ones((g, g, g), dtype=torch.float32, device=device),
        "aabb_min": torch.as_tensor(aabb_min, dtype=torch.float32,
                                    device=device),
        "aabb_max": torch.as_tensor(aabb_max, dtype=torch.float32,
                                    device=device),
    }


def _dilate_max3(x: torch.Tensor) -> torch.Tensor:
    """3x3x3 max-pool with -inf padding: a one-voxel dilation."""
    return F.max_pool3d(x[None, None], 3, stride=1, padding=1)[0, 0]


def refresh_occ(grid: Grid, cfg: OccGridConfig) -> Grid:
    """The sampled occupancy from the density EMA: threshold, then dilate
    by one voxel (a bin's midpoint test can miss a thin occupied
    structure beside an empty voxel)."""
    occ = (grid["density"] > cfg.threshold).to(torch.float32)
    return {**grid, "occ": _dilate_max3(occ)}


def _voxel_index(grid: Grid, pts: torch.Tensor, g: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """pts [..., 3] -> (flat int64 index [...], in-bounds mask [...])."""
    rel = (pts - grid["aabb_min"]) / (grid["aabb_max"] - grid["aabb_min"])
    # clamped before the cast so far-out points stay out of bounds
    idx = torch.floor(torch.clamp(rel * g, -1.0, float(g))).to(torch.int64)
    inb = ((idx >= 0) & (idx < g)).all(dim=-1)
    idx = idx.clamp(0, g - 1)
    flat = (idx[..., 0] * g + idx[..., 1]) * g + idx[..., 2]
    return flat, inb


def update_grid(grid: Grid, pts: torch.Tensor, sigma: torch.Tensor,
                cfg: OccGridConfig) -> Grid:
    """Blend the voxels this step visited toward their largest observed
    density (mean-EMA at ``decay``), then refresh ``occ``.  pts [..., 3],
    sigma [...] (post-activation densities); points out of the box are
    dropped.  No gradient flows."""
    g = cfg.resolution
    with torch.no_grad():
        sigma = sigma.reshape(-1)
        flat, inb = _voxel_index(grid, pts.reshape(-1, 3), g)
        contrib = torch.where(inb.reshape(-1), sigma,
                              torch.full_like(sigma, -torch.inf))
        dens = grid["density"].reshape(-1)
        obs = torch.full_like(dens, -torch.inf).scatter_reduce(
            0, flat.reshape(-1), contrib, "amax")
        visited = obs > -torch.inf
        blended = cfg.decay * dens + (1.0 - cfg.decay) * torch.clamp_min(
            obs, 0.0)
        dens = torch.where(visited, blended, dens)
        return refresh_occ({**grid, "density": dens.reshape(g, g, g)}, cfg)


def occupancy_along_rays(grid: Grid, rays_o: torch.Tensor,
                         rays_d: torch.Tensor, near: torch.Tensor,
                         far: torch.Tensor, m: int, cfg: OccGridConfig
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(edges [R, m+1] z values, occ [R, m] in {0, 1}): each candidate
    bin's midpoint tested against the grid by one gather."""
    t = sampling.linspace01(m + 1, near.dtype, near.device)
    edges = near * (1.0 - t) + far * t
    mids = 0.5 * (edges[..., 1:] + edges[..., :-1])
    pts = rays_o[:, None, :] + rays_d[:, None, :] * mids[..., None]
    flat, inb = _voxel_index(grid, pts, cfg.resolution)
    occ = grid["occ"].reshape(-1)[flat]
    return edges, occ * inb.to(torch.float32)


def occ_guided_z_vals(grid: Grid, rays_o: torch.Tensor, rays_d: torch.Tensor,
                      near: torch.Tensor, far: torch.Tensor, n_samples: int,
                      t_rand: Optional[torch.Tensor], cfg: OccGridConfig
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``n_samples`` z values per ray by stratified inverse CDF over the
    candidate-bin weights ``occ + floor``, ascending; ``t_rand`` [R,
    n_samples] jitters each stratum (None: its middle).  Returns ``(z_vals,
    occ_ray_frac)``, the second the mean occupied fraction of candidate
    bins over the batch (the drivers' degenerate-guidance signal)."""
    edges, occ = occupancy_along_rays(grid, rays_o, rays_d, near, far,
                                      cfg.candidates, cfg)
    w = occ + cfg.floor
    offs = (t_rand if t_rand is not None else
            torch.full((rays_o.shape[0], n_samples), 0.5, dtype=near.dtype,
                       device=near.device))
    u = (torch.arange(n_samples, dtype=near.dtype, device=near.device)
         + offs) / n_samples
    # the inverse CDF in float64, rounded once at the end: an unoccupied
    # bin holds ~1e-3 of the CDF, so float32 cumsums that sum in another
    # order (the card's scan, the CPU's loop, XLA's) move a sample by up to
    # 3e-5, and the positional encoding's top band by ~1e-2 rad
    z = sampling.sample_pdf(edges.double(), w.double(), u.double())
    return z.to(near.dtype), occ.mean()
