"""LLFF forward-facing dataset loader (own copy of ``plnerf/data/llff.py``).

Reference: load_llff.py (the ``poses_bounds.npy`` layout, the axis fixup,
the bounds rescale by 1 / (bds.min * bd_factor), pose recentering around
the average camera, spherification for 360 scenes, the spiral render
path).  The pose algebra is numpy, copied op for op, so poses, bounds and
render poses come out equal to the JAX package's.

Images are read with ``data/png.py`` and ``data/jpeg.py`` (the JAX
package reads them with imageio and cv2, which decode JPEG with
libjpeg-turbo; the port's decoder is bit-equal to both).  Minification
(``images_{factor}/`` or ``images_{W}x{H}/``, written when missing) decodes
the PNG or JPEG sources and writes ``area_resize``, cv2's ``INTER_AREA``
in numpy, as PNGs; the JAX package calls cv2, and the reference shells
out to ImageMagick (load_llff.py:8-57).
"""
from __future__ import annotations

import os
import struct
from typing import Tuple

import numpy as np

from .jpeg import read_jpeg
from .png import read_png, write_png

_IMAGE_EXTS = (".jpg", ".jpeg", ".png")


def _normalize(v):
    """Reference load_llff.py:120-121 ``normalize``."""
    return v / np.linalg.norm(v)


def _view_matrix(z, up, pos):
    """Reference load_llff.py:123-129 ``viewmatrix`` (columns [right, up,
    forward, position])."""
    vec2 = _normalize(z)
    vec0 = _normalize(np.cross(up, vec2))
    vec1 = _normalize(np.cross(vec2, vec0))
    return np.stack([vec0, vec1, vec2, pos], 1)


def _poses_avg(poses):
    """Reference load_llff.py:137-145 ``poses_avg``: the average camera
    from the mean position, summed forward axes and summed up axes."""
    hwf = poses[0, :3, -1:]
    center = poses[:, :3, 3].mean(0)
    vec2 = _normalize(poses[:, :3, 2].sum(0))
    up = poses[:, :3, 1].sum(0)
    return np.concatenate([_view_matrix(vec2, up, center), hwf], 1)


def _recenter_poses(poses):
    """Reference load_llff.py:166-178 ``recenter_poses``: rebase every pose
    by the inverse average camera."""
    poses_ = poses + 0
    bottom = np.reshape([0, 0, 0, 1.0], [1, 4])
    c2w = _poses_avg(poses)
    c2w = np.concatenate([c2w[:3, :4], bottom], -2)
    bottom = np.tile(np.reshape(bottom, [1, 1, 4]), [poses.shape[0], 1, 1])
    p44 = np.concatenate([poses[:, :3, :4], bottom], -2)
    p44 = np.linalg.inv(c2w) @ p44
    poses_[:, :3, :4] = p44[:, :3, :4]
    return poses_


def _spiral_path(c2w, up, rads, focal, zrate, rots, N):
    """Reference load_llff.py:147-162 ``render_path_spiral``."""
    out = []
    rads = np.array(list(rads) + [1.0])
    hwf = c2w[:, 4:5]
    for theta in np.linspace(0.0, 2.0 * np.pi * rots, N + 1)[:-1]:
        c = np.dot(
            c2w[:3, :4],
            np.array([np.cos(theta), -np.sin(theta), -np.sin(theta * zrate),
                      1.0]) * rads)
        z = _normalize(c - np.dot(c2w[:3, :4], np.array([0, 0, -focal, 1.0])))
        out.append(np.concatenate([_view_matrix(z, up, c), hwf], 1))
    return np.stack(out, 0)


def _spherify(poses, bds):
    """Reference load_llff.py:184-240 ``spherify_poses``: (1) the point
    closest to all camera z-axes, (2) poses rebased to the sphere frame,
    (3) rescaled to unit radius, (4) a 120-pose circular render path at
    the cameras' mean height.  The constants and the op order define the
    camera layout that trained checkpoints depend on."""
    p34_to_44 = lambda p: np.concatenate(  # noqa: E731
        [p, np.tile(np.reshape(np.eye(4)[-1], [1, 1, 4]), [p.shape[0], 1, 1])],
        1)
    rays_d = poses[:, :3, 2:3]
    rays_o = poses[:, :3, 3:4]

    A_i = np.eye(3) - rays_d * np.transpose(rays_d, [0, 2, 1])
    b_i = -A_i @ rays_o
    pt_mindist = np.squeeze(
        -np.linalg.inv((np.transpose(A_i, [0, 2, 1]) @ A_i).mean(0))
        @ b_i.mean(0))

    center = pt_mindist
    up = (poses[:, :3, 3] - center).mean(0)
    vec0 = _normalize(up)
    vec1 = _normalize(np.cross([0.1, 0.2, 0.3], vec0))
    vec2 = _normalize(np.cross(vec0, vec1))
    c2w = np.stack([vec1, vec2, vec0, center], 1)

    poses_reset = (np.linalg.inv(p34_to_44(c2w[None]))
                   @ p34_to_44(poses[:, :3, :4]))
    rad = np.sqrt(np.mean(np.sum(np.square(poses_reset[:, :3, 3]), -1)))

    sc = 1.0 / rad
    poses_reset[:, :3, 3] *= sc
    bds = bds * sc
    rad *= sc

    centroid = np.mean(poses_reset[:, :3, 3], 0)
    zh = centroid[2]
    radcircle = np.sqrt(rad ** 2 - zh ** 2)
    new_poses = []
    for th in np.linspace(0.0, 2.0 * np.pi, 120):
        camorigin = np.array(
            [radcircle * np.cos(th), radcircle * np.sin(th), zh])
        up = np.array([0, 0, -1.0])
        vec2 = _normalize(camorigin)
        vec0 = _normalize(np.cross(vec2, up))
        vec1 = _normalize(np.cross(vec2, vec0))
        new_poses.append(np.stack([vec0, vec1, vec2, camorigin], 1))
    new_poses = np.stack(new_poses, 0)

    new_poses = np.concatenate(
        [new_poses,
         np.broadcast_to(poses[0, :3, -1:], new_poses[:, :3, -1:].shape)], -1)
    poses_reset = np.concatenate(
        [poses_reset[:, :3, :4],
         np.broadcast_to(poses[0, :3, -1:], poses_reset[:, :3, -1:].shape)],
        -1)
    return poses_reset, new_poses, bds


def _area_weights(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in]: the share of each output pixel's footprint (n_in /
    n_out source pixels wide) that falls on each source pixel."""
    scale = n_in / n_out
    lo = np.arange(n_out)[:, None] * scale
    edges = np.arange(n_in + 1)[None, :]
    overlap = (np.minimum(lo + scale, edges[:, 1:])
               - np.maximum(lo, edges[:, :-1]))
    return np.clip(overlap, 0.0, None) / scale


def area_resize(img: np.ndarray, size) -> np.ndarray:
    """Shrink a uint8 image [H, W(, C)] to ``size`` = (W, H) by area
    averaging, as cv2's ``INTER_AREA`` does, rounded to the nearest level
    (cv2 reaches its sum in another order, so a level can differ by one).
    Enlarging raises ``ValueError``."""
    w, h = int(size[0]), int(size[1])
    H, W = img.shape[:2]
    if w > W or h > H or w < 1 or h < 1:
        raise ValueError(f"area_resize shrinks only: {W}x{H} -> {w}x{h}")
    if (w, h) == (W, H):
        return img.copy()
    wy, wx = _area_weights(H, h), _area_weights(W, w)
    # rows, then columns: two products (one three-operand einsum would
    # loop over h x H x W x w terms)
    out = np.tensordot(wy, img.astype(np.float64), axes=(1, 0))
    out = np.moveaxis(np.tensordot(wx, out, axes=(1, 1)), 0, 1)
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def _image_names(d: str):
    return sorted(f for f in os.listdir(d) if f.lower().endswith(_IMAGE_EXTS))


def _is_jpeg(name: str) -> bool:
    return name.lower().endswith((".jpg", ".jpeg"))


def _image_shape(path: str) -> Tuple[int, int]:
    """(H, W) of a PNG or JPEG file, from its header alone: a PNG's IHDR,
    or a JPEG's SOF, reached by seeking over the marker segments before it
    whatever their size (EXIF thumbnails, XMP, ICC and MPF segments can
    fill more than 64 KiB).  Bytes before a marker and 0xFF fill bytes are
    skipped, as libjpeg's next_marker does."""
    with open(path, "rb") as f:
        head = f.read(24)
        if head[:8] == b"\x89PNG\r\n\x1a\n":
            W, H = struct.unpack(">II", head[16:24])
            return H, W
        if head[:2] == b"\xff\xd8":
            f.seek(2)
            while (b := f.read(1)):
                if b != b"\xff":
                    continue
                while b == b"\xff":
                    b = f.read(1)
                if not b or b[0] in (0xD9, 0xDA):        # EOI, SOS
                    break
                m = b[0]
                if m == 0 or m == 0x01 or 0xD0 <= m <= 0xD8:
                    continue                         # no segment follows
                at = f.tell()
                seg = f.read(7)
                if len(seg) < 2:
                    break
                if 0xC0 <= m <= 0xCF and m not in (0xC4, 0xC8, 0xCC):
                    if len(seg) < 7:
                        break
                    H, W = struct.unpack(">HH", seg[3:7])
                    return H, W
                f.seek(at + struct.unpack(">H", seg[:2])[0])
    raise ValueError(f"{path}: no PNG or JPEG size in its header")


def _read_rgb(path: str) -> np.ndarray:
    return read_jpeg(path) if _is_jpeg(path) else read_png(path)


def _minify(basedir: str, factor: int = None, resolution=None):
    """Write ``images_{factor}/`` (or ``images_{W}x{H}/`` for an explicit
    ``resolution=(H, W)``) beside ``images/`` when it is missing: each PNG
    or JPEG source decoded and written as an area-resized PNG
    (load_llff.py:8-57's two target kinds)."""
    if resolution is not None:
        h, w = resolution
        out_dir = os.path.join(basedir, f"images_{w}x{h}")
    else:
        out_dir = os.path.join(basedir, f"images_{factor}")
    if os.path.exists(out_dir):
        return
    src_dir = os.path.join(basedir, "images")
    names = _image_names(src_dir)
    os.makedirs(out_dir)
    for name in names:
        img = _read_rgb(os.path.join(src_dir, name))
        h, w = img.shape[:2]
        size = ((int(round(w / factor)), int(round(h / factor)))
                if resolution is None else (resolution[1], resolution[0]))
        base = os.path.splitext(name)[0]
        write_png(os.path.join(out_dir, base + ".png"),
                  area_resize(img, size))


def _load_data(basedir: str, factor: int, width: int = None,
               height: int = None):
    """``factor`` wins; otherwise an explicit ``height`` (then ``width``)
    target derives the other dimension from the native aspect ratio (the
    precedence chain of load_llff.py:62-89).

    As in the JAX package, ``factor=1`` means no downsampling and falls
    through to the resolution branch (or the native images); the
    reference would minify into an identical ``images_1/`` copy."""
    poses_arr = np.load(os.path.join(basedir, "poses_bounds.npy"))
    poses = poses_arr[:, :-2].reshape([-1, 3, 5]).transpose([1, 2, 0])
    bds = poses_arr[:, -2:].transpose([1, 0])

    sfx = ""
    if factor is not None and factor != 1:
        sfx = f"_{factor}"
        _minify(basedir, factor)
    elif height is not None or width is not None:
        src_dir = os.path.join(basedir, "images")
        sh = _image_shape(os.path.join(src_dir, _image_names(src_dir)[0]))
        if height is not None:
            factor = sh[0] / float(height)
            width = int(sh[1] / factor)
        else:
            factor = sh[1] / float(width)
            height = int(sh[0] / factor)
        _minify(basedir, resolution=(height, width))
        sfx = f"_{width}x{height}"
    else:
        factor = 1

    imgdir = os.path.join(basedir, "images" + sfx)
    imgfiles = [os.path.join(imgdir, f) for f in _image_names(imgdir)]
    if poses.shape[-1] != len(imgfiles):
        raise ValueError(
            f"pose/image count mismatch: {poses.shape[-1]} vs {len(imgfiles)}")

    imgs = [_read_rgb(f) for f in imgfiles]
    poses[:2, 4, :] = np.array(imgs[0].shape[:2]).reshape([2, 1])
    poses[2, 4, :] = poses[2, 4, :] * 1.0 / factor

    imgs = np.stack([im[..., :3] / 255.0 for im in imgs], -1)
    return poses, bds, imgs


def load_llff_data(
    basedir: str, factor: int = 8, recenter: bool = True,
    bd_factor: float = 0.75, spherify: bool = False,
    path_zflat: bool = False, width: int = None, height: int = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, int]:
    """Returns (images [N, H, W, 3], poses [N, 3, 5], bds [N, 2],
    render_poses, i_test), the reference ``load_llff_data`` contract
    (with its width / height variant, load_llff.py:246)."""
    poses, bds, imgs = _load_data(basedir, factor, width=width,
                                  height=height)

    # column swap: (down, right, back) -> (right, up, back)
    poses = np.concatenate(
        [poses[:, 1:2, :], -poses[:, 0:1, :], poses[:, 2:, :]], 1)
    poses = np.moveaxis(poses, -1, 0).astype(np.float32)
    images = np.moveaxis(imgs, -1, 0).astype(np.float32)
    bds = np.moveaxis(bds, -1, 0).astype(np.float32)

    sc = 1.0 if bd_factor is None else 1.0 / (bds.min() * bd_factor)
    poses[:, :3, 3] *= sc
    bds = bds * sc

    if recenter:
        poses = _recenter_poses(poses)

    if spherify:
        poses, render_poses, bds = _spherify(poses, bds)
    else:
        c2w = _poses_avg(poses)
        up = _normalize(poses[:, :3, 1].sum(0))
        close_depth, inf_depth = bds.min() * 0.9, bds.max() * 5.0
        dt = 0.75
        focal = 1.0 / ((1.0 - dt) / close_depth + dt / inf_depth)

        tt = poses[:, :3, 3]
        rads = np.percentile(np.abs(tt), 90, 0)
        c2w_path = c2w
        n_views, n_rots = 120, 2
        if path_zflat:
            zloc = -close_depth * 0.1
            c2w_path[:3, 3] = c2w_path[:3, 3] + zloc * c2w_path[:3, 2]
            rads[2] = 0.0
            n_rots = 1
            n_views //= 2
        render_poses = _spiral_path(
            c2w_path, up, rads, focal, zrate=0.5, rots=n_rots, N=n_views)

    render_poses = np.array(render_poses, np.float32)
    c2w = _poses_avg(poses)
    dists = np.sum(np.square(c2w[:3, 3] - poses[:, :3, 3]), -1)
    i_test = int(np.argmin(dists))
    return images.astype(np.float32), poses.astype(np.float32), bds, \
        render_poses, i_test
