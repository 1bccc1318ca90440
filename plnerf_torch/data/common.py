"""Shared dataset helpers: spherical camera paths, image reads, intrinsics
and background compositing (own copy of ``plnerf/data/common.py``).

Conventions match the reference loaders (load_blender.py:10-50,
load_dtu.py:19-44): OpenGL camera axes, hemisphere render paths of 40
poses at radius 4, reads that keep alpha when present.  Images are read
with ``data/png.py`` in place of ``cv2``; ``downsample_2x`` stands in for
``cv2.resize`` at the factor of 2 the loaders use.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from .png import read_png


def _rot_xyz(phi: float, theta: float, radius: float) -> np.ndarray:
    trans = np.eye(4, dtype=np.float32)
    trans[2, 3] = radius
    rx = np.eye(4, dtype=np.float32)
    rx[1, 1], rx[1, 2] = np.cos(phi), -np.sin(phi)
    rx[2, 1], rx[2, 2] = np.sin(phi), np.cos(phi)
    ry = np.eye(4, dtype=np.float32)
    ry[0, 0], ry[0, 2] = np.cos(theta), -np.sin(theta)
    ry[2, 0], ry[2, 2] = np.sin(theta), np.cos(theta)
    return ry @ rx @ trans


def pose_spherical(theta_deg: float, phi_deg: float, radius: float) -> np.ndarray:
    """Camera-to-world for a camera on a sphere looking at the origin."""
    c2w = _rot_xyz(np.deg2rad(phi_deg), np.deg2rad(theta_deg), radius)
    flip = np.array(
        [[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]], np.float32
    )
    return flip @ c2w


def hemisphere_render_poses(n: int = 40, phi: float = -30.0,
                            radius: float = 4.0) -> np.ndarray:
    """The standard 40-pose spiral used by every blender-family loader."""
    angles = np.linspace(-180, 180, n + 1)[:-1]
    return np.stack([pose_spherical(a, phi, radius) for a in angles], 0)


def downsample_2x(img: np.ndarray) -> np.ndarray:
    """Halve an image's height and width by the mean of each 2x2 block.

    This is what ``cv2.resize`` computes at an exact factor of 2 with the
    interpolation the loaders ask for: ``INTER_AREA`` on float images,
    ``((p00 + p01) + (p10 + p11)) * 0.25``; ``INTER_LINEAR`` on ``uint8``,
    rounded half up in fixed point, ``(sum + 2) >> 2``, and on ``uint16``,
    rounded half to even.  Odd sizes (where cv2 weighs fractional areas)
    raise ``ValueError``."""
    H, W = img.shape[:2]
    if H % 2 or W % 2:
        raise ValueError(f"cannot halve a {H}x{W} image exactly (odd size)")
    p = img.reshape(H // 2, 2, W // 2, 2, *img.shape[2:])
    if np.issubdtype(img.dtype, np.integer):
        s = p.astype(np.int64).sum((1, 3))
        if img.dtype == np.uint8:
            return ((s + 2) >> 2).astype(np.uint8)
        return np.rint(s / 4).astype(img.dtype)
    return ((p[:, 0, :, 0] + p[:, 0, :, 1]) + (p[:, 1, :, 0] + p[:, 1, :, 1])
            ) * img.dtype.type(0.25)


def read_image_rgb(path: str, downsample: Optional[float] = None,
                   keep_alpha: bool = True) -> np.ndarray:
    """RGB(A) read, [0, 1] float32 (the integer value over 255), optional
    downsample by 2 before the division (reference read_files,
    load_blender.py:36-50, which resizes bilinearly)."""
    img = read_png(path)
    if downsample is not None and downsample != 1:
        if downsample != 2:
            raise ValueError(f"downsample {downsample}: only 2 is supported")
        img = downsample_2x(img)
    img = (img / 255.0).astype(np.float32)
    if not keep_alpha and img.ndim == 3 and img.shape[-1] == 4:
        img = img[..., :3]
    return img


def intrinsics_from_fov(H: int, W: int, camera_angle_x: float):
    focal = 0.5 * W / np.tan(0.5 * camera_angle_x)
    K = np.array(
        [[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]], np.float32
    )
    return focal, K


def composite_white_background(images: np.ndarray) -> np.ndarray:
    """RGBA -> RGB over white (reference run_plnerf.py:1022-1025)."""
    if images.shape[-1] == 4:
        return images[..., :3] * images[..., -1:] + (1.0 - images[..., -1:])
    return images


def strip_alpha(images: np.ndarray) -> np.ndarray:
    return images[..., :3]
