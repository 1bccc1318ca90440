"""Ray batches for training (port of ``plnerf/train/batching.py``), on the
device of the images.

* ``sample_one_image_batch`` (blender recipes): one training image per
  step and ``n_rand`` pixels of it, drawn with replacement, from the
  central crop during the precrop iterations.
* ``build_ray_pool`` / ``pool_batch`` (LLFF ``use_batching`` recipes): a
  shuffled pool of every training ray (NDC-warped for LLFF scenes),
  consumed in contiguous slices.

Draws come from an explicit ``torch.Generator``; ``draws`` injects them
(image index into ``i_train``, pixel rows, pixel cols), so tests can drive
this module and the JAX package with the same numbers.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..core import rays as raysmod
from ..device import as_tensor


def select_pixels(generator: Optional[torch.Generator], H: int, W: int,
                  n_rand: int, precrop: bool, precrop_frac: float,
                  device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Random pixel (row, col) indices, optionally from the central crop."""
    if precrop:
        dH = int(H // 2 * precrop_frac)
        dW = int(W // 2 * precrop_frac)
        y_lo, y_hi, x_lo, x_hi = H // 2 - dH, H // 2 + dH, W // 2 - dW, \
            W // 2 + dW
    else:
        y_lo, y_hi, x_lo, x_hi = 0, H, 0, W
    y = torch.randint(y_lo, y_hi, (n_rand,), generator=generator,
                      device=device)
    x = torch.randint(x_lo, x_hi, (n_rand,), generator=generator,
                      device=device)
    return y, x


def rays_for_pixels(K, c2w: torch.Tensor, y: torch.Tensor, x: torch.Tensor,
                    pixel_center: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ray origins/directions of the given pixels (OpenGL axes, as
    ``core.rays.get_rays``)."""
    K = as_tensor(K, c2w.device)
    xf, yf = x.float(), y.float()
    if pixel_center:
        xf, yf = xf + 0.5, yf + 0.5
    dirs = torch.stack([(xf - K[0, 2]) / K[0, 0], -(yf - K[1, 2]) / K[1, 1],
                        -torch.ones_like(xf)], dim=-1)
    rays_d = dirs @ c2w[:3, :3].t()
    rays_o = c2w[:3, -1].expand(rays_d.shape)
    return rays_o, rays_d


def sample_one_image_batch(
    images: torch.Tensor,         # [N, H, W, 3]
    poses: torch.Tensor,          # [N, 3, 4] or [N, 4, 4]
    K,
    i_train: torch.Tensor,        # [T] training image indices
    generator: Optional[torch.Generator],
    n_rand: int,
    near: float,
    far: float,
    use_viewdirs: bool,
    precrop: bool = False,
    precrop_frac: float = 0.5,
    ndc: bool = False,
    focal: float = 0.0,
    draws: Optional[Tuple] = None,
):
    """One-image ray batch.  Returns (rays [R, 8|11], target [R, 3],
    img_idx).  ``draws`` = (index into i_train, rows, cols) replaces the
    generator's draws.  With ``ndc`` the origins/directions are NDC-warped
    while the viewdirs stay world-space."""
    H, W = images.shape[1], images.shape[2]
    dev = images.device
    if draws is None:
        ti = torch.randint(0, i_train.shape[0], (1,), generator=generator,
                           device=dev)
        y, x = select_pixels(generator, H, W, n_rand, precrop, precrop_frac,
                             dev)
    else:
        ti, y, x = (torch.as_tensor(d, device=dev) for d in draws)
    # the image index stays a 1-element tensor: a 0-dim one used as an
    # index is read on the host
    img_i = i_train.index_select(0, ti.reshape(1).long())
    c2w = poses.index_select(0, img_i)[0, :3, :4]
    y, x = y.long(), x.long()
    rays_o, rays_d = rays_for_pixels(K, c2w, y, x)
    target = images[img_i, y, x]
    viewdirs = None
    if use_viewdirs:
        viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    if ndc:
        rays_o, rays_d = raysmod.ndc_rays(H, W, focal, 1.0, rays_o, rays_d)
    return raysmod.pack_rays(rays_o, rays_d, near, far, viewdirs), target, \
        img_i[0]


def build_ray_pool(images: np.ndarray, poses: np.ndarray, K, i_train,
                   seed: int = 0, ndc: bool = False,
                   focal: float = 0.0) -> np.ndarray:
    """Host-side shuffled pool [M, 9]: (o, d, rgb) of every pixel of the
    training images (the JAX package's pool, same rows and order).  With
    ``ndc`` the rows are [M, 12]: o and d warped into NDC once, here, and
    the world-space d kept as columns 9-11 for the viewdirs (the
    reference's render computes them before the warp, run_plnerf.py:
    145-155)."""
    rows = []
    H, W = images.shape[1], images.shape[2]
    for i in np.asarray(i_train):
        ro, rd = raysmod.get_rays(H, W, np.asarray(K, np.float32),
                                  torch.as_tensor(poses[i][:3, :4]),
                                  device="cpu")
        rows.append(np.concatenate(
            [ro.reshape(-1, 3).numpy(), rd.reshape(-1, 3).numpy(),
             images[i].reshape(-1, 3)], axis=-1))
    pool = np.concatenate(rows, 0).astype(np.float32)
    np.random.default_rng(seed).shuffle(pool)
    if ndc:
        ro, rd = raysmod.ndc_rays(H, W, focal, 1.0, torch.from_numpy(
            pool[:, 0:3]), torch.from_numpy(pool[:, 3:6]))
        pool = np.concatenate([ro.numpy(), rd.numpy(), pool[:, 6:9],
                               pool[:, 3:6]], -1)
    return pool


def pool_batch(pool: torch.Tensor, i_batch, n_rand: int, near: float,
               far: float, use_viewdirs: bool):
    """Contiguous slice of the shuffled pool: (rays, target).  Pool rows
    are [o, d, rgb] (9 columns) or, for NDC pools, [ndc_o, ndc_d, rgb,
    world viewdirs] (12 columns).  ``i_batch``: the first row, an int or
    a 0-dim / 1-element device tensor (a window's staged offset, which
    the host never reads: the rows are gathered, as the JAX driver's
    fused window slices at ``i_batch + k * n_rand``)."""
    if isinstance(i_batch, torch.Tensor):
        rows = pool.index_select(0, i_batch.reshape(1) + torch.arange(
            n_rand, device=pool.device))
    else:
        rows = pool[i_batch:i_batch + n_rand]
    rays_o, rays_d, target = rows[:, 0:3], rows[:, 3:6], rows[:, 6:9]
    viewdirs = None
    if use_viewdirs:
        vd = rows[:, 9:12] if pool.shape[1] >= 12 else rays_d
        viewdirs = vd / torch.linalg.norm(vd, dim=-1, keepdim=True)
    return raysmod.pack_rays(rays_o, rays_d, near, far, viewdirs), target
