"""Synthetic analytic scene for tests and smoke runs (own copy of the
sphere scene of ``plnerf/data/synthetic.py``): a constant-density sphere
rendered by independent numpy ray-marching, so the trainer runs without
dataset files."""
from __future__ import annotations

from typing import Tuple

import numpy as np


def pose_spherical_np(theta_deg: float, phi_deg: float,
                      radius: float) -> np.ndarray:
    """Camera-to-world on a sphere looking at the origin (the blender
    loaders' ``pose_spherical`` convention)."""
    t, p = np.deg2rad(theta_deg), np.deg2rad(phi_deg)
    trans = np.eye(4, dtype=np.float32)
    trans[2, 3] = radius
    rx = np.eye(4, dtype=np.float32)
    rx[1, 1], rx[1, 2] = np.cos(p), -np.sin(p)
    rx[2, 1], rx[2, 2] = np.sin(p), np.cos(p)
    ry = np.eye(4, dtype=np.float32)
    ry[0, 0], ry[0, 2] = np.cos(t), -np.sin(t)
    ry[2, 0], ry[2, 2] = np.sin(t), np.cos(t)
    flip = np.array(
        [[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]], np.float32)
    return flip @ ry @ rx @ trans


def render_sphere_image(
    c2w: np.ndarray, H: int, W: int, focal: float,
    radius: float = 1.0, density: float = 20.0,
    color=(0.8, 0.3, 0.2), near: float = 2.0, far: float = 6.0,
    n_march: int = 256, white_bkgd: bool = True,
) -> np.ndarray:
    """Numpy volume rendering of a homogeneous sphere."""
    i, j = np.meshgrid(np.arange(W, dtype=np.float32),
                       np.arange(H, dtype=np.float32), indexing="xy")
    dirs = np.stack(
        [(i - W / 2) / focal, -(j - H / 2) / focal, -np.ones_like(i)], -1)
    rays_d = dirs @ c2w[:3, :3].T
    rays_o = np.broadcast_to(c2w[:3, 3], rays_d.shape)

    t = np.linspace(near, far, n_march, dtype=np.float32)
    pts = rays_o[..., None, :] + rays_d[..., None, :] * t[:, None]
    sigma = density * (np.linalg.norm(pts, axis=-1) < radius)

    dt = (far - near) / (n_march - 1) * np.linalg.norm(
        rays_d, axis=-1)[..., None]
    alpha = 1 - np.exp(-sigma * dt)
    trans = np.cumprod(np.concatenate(
        [np.ones_like(alpha[..., :1]), 1 - alpha + 1e-10], -1), -1)[..., :-1]
    w = alpha * trans
    rgb = w.sum(-1)[..., None] * np.asarray(color, np.float32)
    if white_bkgd:
        rgb = rgb + (1 - w.sum(-1))[..., None]
    return rgb.astype(np.float32)


def make_sphere_dataset(
    n_views: int = 8, H: int = 48, W: int = 48, seed: int = 0,
    radius: float = 1.0, density: float = 20.0,
) -> Tuple[np.ndarray, np.ndarray, list, np.ndarray]:
    """(images, poses, hwf, K) of a hemisphere of views at distance 4."""
    focal = 0.5 * W / np.tan(0.25)  # ~fov 28deg
    rng = np.random.default_rng(seed)
    thetas = np.linspace(-180, 180, n_views, endpoint=False)
    phis = rng.uniform(-45, -15, n_views)
    poses = np.stack([pose_spherical_np(t, p, 4.0)
                      for t, p in zip(thetas, phis)])
    images = np.stack([render_sphere_image(p, H, W, focal, radius, density)
                       for p in poses])
    K = np.array([[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]],
                 np.float32)
    return images, poses.astype(np.float32), [H, W, focal], K
