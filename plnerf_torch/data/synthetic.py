"""Synthetic analytic scenes for tests and smoke runs (own copy of the
sphere scene, the multi-object scene with ground-truth depth and the
forward-facing LLFF fixture of ``plnerf/data/synthetic.py``):
constant-density shapes rendered by independent numpy ray-marching, so
the trainers run without dataset files.  ``write_blender2_depth_scene``
lays the multi-object scene out as a blender2_depth dataset,
``write_sphere_scene`` and ``write_fixed_dist_scene`` the sphere as a
Blender and a blender_fixeddist dataset."""
from __future__ import annotations

import json
import os
from typing import Dict, Optional, Tuple

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
# The multi-object scene with ground-truth depth (the JAX package's
# convergence fixture): spheres of varied albedo over a checkered ground
# slab, its expected-depth maps, and a writer of the blender2_depth layout.
# ---------------------------------------------------------------------------

_SCENE_SPHERES = [
    # (center, radius, albedo)
    ((0.0, 0.0, 0.35), 0.55, (0.85, 0.25, 0.2)),
    ((0.9, -0.45, 0.05), 0.32, (0.2, 0.45, 0.9)),
    ((-0.85, 0.55, -0.05), 0.28, (0.95, 0.8, 0.15)),
    ((-0.15, -0.9, -0.12), 0.22, (0.2, 0.8, 0.35)),
]
_SLAB_Z = (-0.55, -0.38)        # thin ground slab (sharp boundaries)
_SLAB_R = 1.6                    # slab extent |x|, |y| < R


def _scene_sigma_rgb(pts: np.ndarray, density: float, slab: bool = True):
    """Density and albedo of the multi-object scene at points [..., 3].
    ``slab=False`` drops the ground slab (an object-centric scene whose
    rays are mostly empty space)."""
    sigma = np.zeros(pts.shape[:-1], np.float32)
    rgb = np.zeros(pts.shape[:-1] + (3,), np.float32)
    for (c, r, a) in _SCENE_SPHERES:
        inside = (np.linalg.norm(pts - np.asarray(c, np.float32), axis=-1)
                  < r)
        sigma = np.where(inside, density, sigma)
        rgb = np.where(inside[..., None], np.asarray(a, np.float32), rgb)
    if not slab:
        return sigma, rgb
    z = pts[..., 2]
    slab = ((z > _SLAB_Z[0]) & (z < _SLAB_Z[1])
            & (np.abs(pts[..., 0]) < _SLAB_R)
            & (np.abs(pts[..., 1]) < _SLAB_R))
    checker = ((np.floor(pts[..., 0] * 2.5) + np.floor(pts[..., 1] * 2.5))
               % 2).astype(np.float32)
    slab_rgb = np.where(checker[..., None] > 0,
                        np.asarray((0.9, 0.9, 0.9), np.float32),
                        np.asarray((0.25, 0.25, 0.3), np.float32))
    sigma = np.where(slab, density, sigma)
    rgb = np.where(slab[..., None], slab_rgb, rgb)
    return sigma, rgb


def render_scene_image(
    c2w: np.ndarray, H: int, W: int, focal: float,
    density: float = 80.0, near: float = 2.0, far: float = 6.0,
    n_march: int = 512, white_bkgd: bool = True, row_chunk: int = 16,
    slab: bool = True, pixel_center: bool = False, with_acc: bool = False,
):
    """Numpy volume render of the multi-object scene.  Returns (rgb [H, W,
    3], depth [H, W]), depth the expected termination distance (sum w *
    t, the renderer's depth_map), and the opacity [H, W] third with
    ``with_acc``.  Rays leave pixel corners as in the JAX package, or
    pixel centres (the depth loaders' convention) with ``pixel_center``."""
    i, j = np.meshgrid(np.arange(W, dtype=np.float32),
                       np.arange(H, dtype=np.float32), indexing="xy")
    if pixel_center:
        i, j = i + 0.5, j + 0.5
    dirs = np.stack(
        [(i - W / 2) / focal, -(j - H / 2) / focal, -np.ones_like(i)], -1)
    rays_d = (dirs @ c2w[:3, :3].T).astype(np.float32)
    rays_o = np.broadcast_to(c2w[:3, 3].astype(np.float32), rays_d.shape)
    t = np.linspace(near, far, n_march, dtype=np.float32)

    rgb_out = np.zeros((H, W, 3), np.float32)
    depth_out = np.zeros((H, W), np.float32)
    acc_out = np.zeros((H, W), np.float32)
    for r0 in range(0, H, row_chunk):
        r1 = min(H, r0 + row_chunk)
        pts = (rays_o[r0:r1, :, None, :]
               + rays_d[r0:r1, :, None, :] * t[:, None])
        sigma, rgb = _scene_sigma_rgb(pts, density, slab=slab)
        dt = (far - near) / (n_march - 1) * np.linalg.norm(
            rays_d[r0:r1], axis=-1)[..., None]
        alpha = 1 - np.exp(-sigma * dt)
        trans = np.cumprod(np.concatenate(
            [np.ones_like(alpha[..., :1]), 1 - alpha + 1e-10], -1), -1
        )[..., :-1]
        w = alpha * trans
        rgb_px = (w[..., None] * rgb).sum(-2)
        acc = w.sum(-1)
        depth_out[r0:r1] = (w * t).sum(-1)
        acc_out[r0:r1] = acc
        if white_bkgd:
            rgb_px = rgb_px + (1 - acc)[..., None]
        rgb_out[r0:r1] = rgb_px
    if with_acc:
        return rgb_out, depth_out, acc_out
    return rgb_out, depth_out


def _multi_object_poses(n: int, seed: int) -> np.ndarray:
    """n cameras at radius 4 around the scene, in a seeded random order."""
    rng = np.random.default_rng(seed)
    thetas = np.linspace(-180, 180, n, endpoint=False)
    phis = rng.uniform(-55, -12, n)
    order = rng.permutation(n)
    return np.stack([pose_spherical_np(thetas[k], phis[k], 4.0)
                     for k in order]).astype(np.float32)


def make_multi_object_dataset(
    n_train: int = 30, n_test: int = 6, H: int = 160, W: int = 160,
    seed: int = 0, density: float = 80.0, cache_dir: Optional[str] = None,
    slab: bool = True,
):
    """Train / test splits of the multi-object scene with its depth maps:
    dict(images, poses, depths, K, i_train, i_test, hwf, near, far).
    Renders are cached in ``cache_dir`` under the geometry's key."""
    focal = 0.5 * W / np.tan(0.25)
    key = (f"mobj_{n_train}_{n_test}_{H}x{W}_{seed}_{density:g}"
           + ("" if slab else "_noslab"))
    cache = os.path.join(cache_dir, key + ".npz") if cache_dir else None
    if cache and os.path.exists(cache):
        z = np.load(cache)
        return {k: z[k] for k in z.files} | {
            "hwf": [H, W, focal], "near": 2.0, "far": 6.0}

    n = n_train + n_test
    poses = _multi_object_poses(n, seed)
    images, depths = [], []
    for p in poses:
        rgb, d = render_scene_image(p, H, W, focal, density=density,
                                    slab=slab)
        images.append(rgb)
        depths.append(d)
    K = np.array([[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]],
                 np.float32)
    out = {"images": np.stack(images), "poses": poses,
           "depths": np.stack(depths), "K": K,
           "i_train": np.arange(n_train), "i_test": np.arange(n_train, n)}
    if cache:
        os.makedirs(cache_dir, exist_ok=True)
        np.savez_compressed(cache, **out)
    return out | {"hwf": [H, W, focal], "near": 2.0, "far": 6.0}


# one stored depth unit is max_depth / 255 (the loaders divide by 255 /
# max_depth); this puts depth 8 at the top of 16 bits
DEPTH_PNG_MAX_DEPTH = 8.0 * 255.0 / 65535.0


def write_blender2_depth_scene(
    basedir: str, views: Dict[str, int], H: int, W: int,
    camera_angle_x: float, seed: int = 0, density: float = 80.0,
    n_march: int = 512, max_depth: float = DEPTH_PNG_MAX_DEPTH,
    workers: int = 1, slab: bool = True) -> str:
    """Write the multi-object scene in the blender2_depth layout that
    ``data.blender.load_blender2_depth`` reads: per split of ``views``
    ({"train": n, "val": n, "test": n}), ``{split}_transforms.json``
    (``camera_angle_x``; per frame ``file_path``, ``depth_file_path``,
    ``max_depth``, ``transform_matrix``), RGBA pngs ``{split}/r_{i}.png``
    (straight colour, alpha the opacity, so compositing over white gives
    the white-background render) and 16-bit depth pngs
    ``{split}/r_{i}_depth.png`` holding ``depth * 255 / max_depth``.
    Cameras come from one seeded set over every split, rays from pixel
    centres.  Mind the loader's stride of 8 over the test split: 9 test
    views are read as 2.  ``workers`` renders that many views at once in
    threads."""
    from concurrent.futures import ThreadPoolExecutor

    from .png import write_png

    focal = 0.5 * W / np.tan(0.5 * camera_angle_x)
    poses = _multi_object_poses(sum(views.values()), seed)
    jobs, k = [], 0
    for split, n in views.items():
        os.makedirs(os.path.join(basedir, split), exist_ok=True)
        frames = []
        for i in range(n):
            c2w = poses[k]
            k += 1
            frames.append({"file_path": f"./{split}/r_{i}",
                           "depth_file_path": f"./{split}/r_{i}_depth_",
                           "max_depth": max_depth,
                           "transform_matrix": c2w.tolist()})
            jobs.append((os.path.join(basedir, split, f"r_{i}"), c2w))
        with open(os.path.join(basedir, f"{split}_transforms.json"),
                  "w") as f:
            json.dump({"camera_angle_x": camera_angle_x, "frames": frames},
                      f)

    def render(job):
        path, c2w = job
        rgb, depth, acc = render_scene_image(
            c2w, H, W, focal, density=density, n_march=n_march,
            white_bkgd=False, slab=slab, pixel_center=True, with_acc=True)
        color = rgb / np.maximum(acc, 1e-8)[..., None]
        rgba = np.concatenate([color, acc[..., None]], -1)
        write_png(path + ".png",
                  np.rint(np.clip(rgba, 0, 1) * 255).astype(np.uint8))
        stored = np.rint(depth * (255.0 / max_depth))
        if stored.max() > 65535:
            raise ValueError(f"depth {depth.max()} does not fit 16 bits at "
                             f"max_depth {max_depth}")
        write_png(path + "_depth.png", stored.astype(np.uint16))

    with ThreadPoolExecutor(max(1, workers)) as ex:
        list(ex.map(render, jobs))
    return basedir


# ---------------------------------------------------------------------------
# The sphere scene in the Blender layout that data/blender.py loads (8 / 1 /
# 2 views at 400x400 in chip_smoke.py's driver and occ phases and in
# tools/occ_quality.py).
# ---------------------------------------------------------------------------

LEGO_CAMERA_ANGLE_X = 0.6911112070083618


def _write_sphere_pngs(size: int, jobs) -> None:
    """Render the numpy sphere for each (path, c2w) of ``jobs`` at size x
    size with the lego camera_angle_x, as RGBA pngs in straight alpha (the
    sphere's colour, alpha its opacity), so compositing over white gives
    the white-background render."""
    from concurrent.futures import ThreadPoolExecutor

    from ..utils.misc import to8b
    from .png import write_png

    focal = 0.5 * size / np.tan(0.5 * LEGO_CAMERA_ANGLE_X)
    color = np.array([0.8, 0.3, 0.2], np.float32)

    def render(job):
        path, c2w = job
        os.makedirs(os.path.dirname(path), exist_ok=True)
        rgb = render_sphere_image(c2w, size, size, focal, color=color,
                                  white_bkgd=False)
        alpha = np.clip(rgb[..., :1] / color[0], 0.0, 1.0)
        rgba = np.concatenate([np.broadcast_to(color, rgb.shape), alpha], -1)
        write_png(path, to8b(rgba))

    # numpy releases the interpreter lock in the render's large ops; each
    # 400x400 render holds ~2 GB of intermediates
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as ex:
        list(ex.map(render, jobs))


def _write_frames(scene_dir: str, json_name: str, frames) -> None:
    with open(os.path.join(scene_dir, json_name), "w") as f:
        json.dump({"camera_angle_x": LEGO_CAMERA_ANGLE_X,
                   "frames": frames}, f)


def write_sphere_scene(scene_dir: str, size: int, views: dict) -> None:
    """A Blender-layout scene of the numpy sphere: ``transforms_{split}.
    json`` and RGBA pngs.  Train views ring the sphere; val and test views
    sit between them."""
    rng = np.random.default_rng(0)
    jobs = []
    for k, (split, n) in enumerate(views.items()):
        thetas = np.linspace(-180, 180, n, endpoint=False) + 360 / 16 * k
        frames = []
        for i, theta in enumerate(thetas):
            c2w = pose_spherical_np(theta, rng.uniform(-40, -20), 4.0)
            frames.append({"file_path": f"./{split}/r_{i}",
                           "transform_matrix": c2w.tolist()})
            jobs.append((os.path.join(scene_dir, split, f"r_{i}.png"), c2w))
        os.makedirs(scene_dir, exist_ok=True)
        _write_frames(scene_dir, f"transforms_{split}.json", frames)
    _write_sphere_pngs(size, jobs)


def write_fixed_dist_scene(scene_dir: str, size: int, dists, n: int) -> None:
    """The blender_fixeddist layout of the numpy sphere: ``n`` test views
    at radius 4 x d for each distance d (``radius_{d}_test/r_i.png`` and
    ``transforms_radius{d}_test.json``)."""
    jobs = []
    os.makedirs(scene_dir, exist_ok=True)
    for d in dists:
        frames = []
        for i, theta in enumerate(np.linspace(-180, 180, n, endpoint=False)
                                  + 15.0):
            c2w = pose_spherical_np(theta, -30.0, 4.0 * d)
            rel = f"radius_{d}_test/r_{i}"
            frames.append({"file_path": "./" + rel,
                           "transform_matrix": c2w.tolist()})
            jobs.append((os.path.join(scene_dir, rel + ".png"), c2w))
        _write_frames(scene_dir, f"transforms_radius{d}_test.json", frames)
    _write_sphere_pngs(size, jobs)


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
