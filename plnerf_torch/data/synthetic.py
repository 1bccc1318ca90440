"""Synthetic analytic scenes for tests and smoke runs (own copy of the
sphere scene and the forward-facing LLFF fixture of
``plnerf/data/synthetic.py``): constant-density shapes rendered by
independent numpy ray-marching, so the trainer runs without dataset
files."""
from __future__ import annotations

import os
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


# ---------------------------------------------------------------------------
# The forward-facing (LLFF-style) fixture: textured planes over a depth
# range, written in the poses_bounds.npy + images/ layout that data/llff.py
# loads (the JAX package's make_llff_fixture, its pngs written by data/png.py).
# ---------------------------------------------------------------------------

def _ff_sigma_rgb(pts: np.ndarray, density: float = 80.0):
    """Density and albedo of the forward-facing scene: three textured planes
    staggered in depth (front card, mid stripes, full background checker)
    and a sphere for parallax.  Cameras sit near z=0 looking down -z."""
    sigma = np.zeros(pts.shape[:-1], np.float32)
    rgb = np.zeros(pts.shape[:-1] + (3,), np.float32)
    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]

    # background plane, z in [-5.2, -5.0]: coarse checker
    m = (z > -5.2) & (z < -5.0)
    checker = ((np.floor(x * 1.2) + np.floor(y * 1.2)) % 2).astype(np.float32)
    c = np.where(checker[..., None] > 0,
                 np.asarray((0.75, 0.75, 0.7), np.float32),
                 np.asarray((0.2, 0.35, 0.25), np.float32))
    sigma = np.where(m, density, sigma)
    rgb = np.where(m[..., None], c, rgb)

    # mid plane card, z in [-3.0, -2.9]: diagonal stripes
    m = ((z > -3.0) & (z < -2.9)
         & (x > -0.3) & (x < 1.0) & (y > -0.8) & (y < 0.6))
    stripes = (np.floor((x + y) * 5.0) % 2).astype(np.float32)
    c = np.where(stripes[..., None] > 0,
                 np.asarray((0.25, 0.35, 0.9), np.float32),
                 np.asarray((0.95, 0.95, 0.95), np.float32))
    sigma = np.where(m, density, sigma)
    rgb = np.where(m[..., None], c, rgb)

    # parallax sphere
    m = np.linalg.norm(
        pts - np.asarray((0.5, -0.3, -2.4), np.float32), axis=-1) < 0.35
    sigma = np.where(m, density, sigma)
    rgb = np.where(m[..., None], np.asarray((0.2, 0.75, 0.3), np.float32),
                   rgb)

    # front card, z in [-1.8, -1.7]: fine checker
    m = ((z > -1.8) & (z < -1.7)
         & (x > -0.6) & (x < 0.1) & (y > -0.5) & (y < 0.3))
    checker = ((np.floor(x * 8.0) + np.floor(y * 8.0)) % 2).astype(
        np.float32)
    c = np.where(checker[..., None] > 0,
                 np.asarray((0.9, 0.2, 0.15), np.float32),
                 np.asarray((0.95, 0.8, 0.2), np.float32))
    sigma = np.where(m, density, sigma)
    rgb = np.where(m[..., None], c, rgb)
    return sigma, rgb


def _lookat_c2w(eye, target, up=(0.0, 1.0, 0.0)) -> np.ndarray:
    """NeRF camera axes: columns [right, up, backward, eye]."""
    eye = np.asarray(eye, np.float32)
    b = eye - np.asarray(target, np.float32)
    b = b / np.linalg.norm(b)
    r = np.cross(np.asarray(up, np.float32), b)
    r = r / np.linalg.norm(r)
    u = np.cross(b, r)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = r, u, b, eye
    return c2w


def render_ff_image(c2w: np.ndarray, H: int, W: int, focal: float,
                    near: float = 0.5, far: float = 7.0,
                    n_march: int = 640, row_chunk: int = 16):
    """Numpy volume render of the forward-facing scene, on white."""
    i, j = np.meshgrid(np.arange(W, dtype=np.float32),
                       np.arange(H, dtype=np.float32), indexing="xy")
    dirs = np.stack(
        [(i - W / 2) / focal, -(j - H / 2) / focal, -np.ones_like(i)], -1)
    rays_d = (dirs @ c2w[:3, :3].T).astype(np.float32)
    rays_o = np.broadcast_to(c2w[:3, 3].astype(np.float32), rays_d.shape)
    t = np.linspace(near, far, n_march, dtype=np.float32)
    out = np.zeros((H, W, 3), np.float32)
    for r0 in range(0, H, row_chunk):
        r1 = min(H, r0 + row_chunk)
        pts = (rays_o[r0:r1, :, None, :]
               + rays_d[r0:r1, :, None, :] * t[:, None])
        sigma, rgb = _ff_sigma_rgb(pts)
        dt = (far - near) / (n_march - 1) * np.linalg.norm(
            rays_d[r0:r1], axis=-1)[..., None]
        alpha = 1 - np.exp(-sigma * dt)
        trans = np.cumprod(np.concatenate(
            [np.ones_like(alpha[..., :1]), 1 - alpha + 1e-10], -1), -1
        )[..., :-1]
        w = alpha * trans
        out[r0:r1] = (w[..., None] * rgb).sum(-2) + (1 - w.sum(-1))[..., None]
    return out


def make_llff_fixture(basedir: str, n: int = 12, H: int = 120, W: int = 160,
                      seed: int = 0, factor: int = 1, workers: int = 1,
                      n_march: int = 640) -> str:
    """Write the forward-facing fixture in the LLFF layout: NNN.png images
    and ``poses_bounds.npy`` ([N, 17]: the 3x5 pose in LLFF's (down, right,
    back) column order and the [near, far] bounds), so ``load_llff_data``
    reads it.  Cameras jitter around z=0 looking at (0, 0, -3.2).

    ``factor`` 1 writes ``images/`` at H x W, as the JAX package does.  A
    larger factor writes the H x W images to ``images_{factor}/`` and the
    full-resolution hwf (H, W and focal times ``factor``) to the poses, as
    a published scene's minified folder reads.  ``workers`` renders that
    many views at once in threads; ``n_march`` is the samples per ray (the
    JAX package's 640)."""
    from concurrent.futures import ThreadPoolExecutor

    from .png import write_png

    img_dir = os.path.join(basedir,
                           "images" if factor == 1 else f"images_{factor}")
    os.makedirs(img_dir, exist_ok=True)
    focal = 0.85 * W
    rng = np.random.default_rng(seed)
    rows, cams = [], []
    for k in range(n):
        # deterministic spread + jitter: good parallax coverage
        gx = (k % 4 - 1.5) / 1.5 * 0.35
        gy = (k // 4 - 1.0) * 0.3
        eye = np.array([gx + rng.uniform(-0.05, 0.05),
                        gy + rng.uniform(-0.05, 0.05),
                        rng.uniform(-0.08, 0.08)], np.float32)
        c2w = _lookat_c2w(eye, (0.0, 0.0, -3.2))
        cams.append((os.path.join(img_dir, f"{k:03d}.png"), c2w))
        r, u, b, tvec = (c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3])
        hwf = np.array([H, W, focal], np.float32) * factor
        m = np.stack([-u, r, b, tvec, hwf], axis=1)  # 3x5
        close = 1.7 - float(eye[2]) - 0.3
        inf = 5.2 - float(eye[2]) + 0.3
        rows.append(np.concatenate([m.reshape(-1), [close, inf]]))

    def render(cam):
        path, c2w = cam
        img = render_ff_image(c2w, H, W, focal, n_march=n_march)
        write_png(path, (np.clip(img, 0, 1) * 255).astype(np.uint8))

    with ThreadPoolExecutor(max(1, workers)) as ex:
        list(ex.map(render, cams))
    np.save(os.path.join(basedir, "poses_bounds.npy"),
            np.stack(rows).astype(np.float64))
    return basedir
