"""DTU multi-view stereo loaders (own copy of ``plnerf/data/dtu.py``).

Reference: load_dtu.py.

* ``load_dtu``: Rectified/scan{id}_train pngs (lighting 3) and
  Cameras/train txt files; intrinsics x4, then x the downsample;
  extrinsic translation scaled by 1/200; near / far from the per-view
  depth ranges (load_dtu.py:47-130).
* ``load_dtu2``: scan{id}/cameras.npz world matrices decomposed into
  K / R / t, scale-normalised, averaged intrinsics, near / far 0.1 / 5.0
  (load_dtu.py:135-214).

Both use the every-8th-view test split unless a split is given.  The JAX
package reads and resizes with PIL and decomposes with cv2; here
``bilinear_resize`` is PIL's ``Image.resize(BILINEAR)`` and
``decompose_projection`` is cv2's ``decomposeProjectionMatrix``, both in
numpy.
"""
from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from .common import hemisphere_render_poses
from .png import read_png

N_VIEWS = 49
LIGHTING_ID = 3
_OPENCV2BLENDER = np.array(
    [[1, 0, 0, 0], [0, -1, 0, 0], [0, 0, -1, 0], [0, 0, 0, 1]], np.float32)
# PIL's fixed-point resampling of 8-bit images (Resample.c)
_PRECISION_BITS = 32 - 8 - 2


def _pil_coeffs(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] fixed-point weights of PIL's bilinear (triangle)
    filter, widened by the scale when shrinking (``precompute_coeffs``
    and ``normalize_coeffs_8bpc``)."""
    scale = n_in / n_out
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    kk = np.zeros((n_out, n_in), np.int64)
    for xx in range(n_out):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), n_in)
        x = np.arange(xmin, xmax)
        w = np.clip(1.0 - np.abs((x - center + 0.5) / filterscale), 0.0, None)
        if w.sum() != 0.0:
            w = w / w.sum()
        # rounded half up (the triangle filter has no negative weights)
        kk[xx, xmin:xmax] = (0.5 + w * (1 << _PRECISION_BITS)).astype(
            np.int64)
    return kk


def _pil_pass(img: np.ndarray, kk: np.ndarray, axis: int) -> np.ndarray:
    """One 8-bit pass along ``axis``: fixed-point sums, rounded, clipped."""
    acc = np.tensordot(kk, img.astype(np.int64), axes=([1], [axis]))
    acc = np.moveaxis(acc, 0, axis) + (1 << (_PRECISION_BITS - 1))
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def bilinear_resize(img: np.ndarray, size) -> np.ndarray:
    """PIL's ``Image.resize(size, BILINEAR)`` of a uint8 gray or RGB image
    [H, W(, 3)] to ``size`` = (W, H): an antialiasing triangle filter
    (widened by the scale factor when shrinking), the horizontal pass,
    then the vertical, each rounded to 8 bits in PIL's fixed point.  The
    same size returns a copy.  Images with alpha raise ``ValueError``
    (PIL premultiplies them first)."""
    w, h = int(size[0]), int(size[1])
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (
            img.ndim == 3 and img.shape[-1] != 3):
        raise ValueError(f"bilinear_resize takes uint8 gray or RGB, not "
                         f"{img.dtype} {img.shape}")
    H, W = img.shape[:2]
    out = img.copy()
    if w != W:
        out = _pil_pass(out, _pil_coeffs(W, w), 1)
    if h != H:
        out = _pil_pass(out, _pil_coeffs(H, h), 0)
    return out


def decompose_projection(P: np.ndarray):
    """cv2's ``decomposeProjectionMatrix`` of a 3x4 P = K [R | -R c]:
    (K, R, t), K upper triangular with a positive first and second
    diagonal entry, R a rotation (det +1), and t [4, 1] the camera centre
    in homogeneous coordinates (P's null vector, up to scale and sign)."""
    P = np.asarray(P, np.float64)
    # RQ of M = P[:, :3] through QR of its row-and-column-reversed transpose
    rev = np.eye(3)[::-1]
    q, r = np.linalg.qr((rev @ P[:, :3]).T)
    K = rev @ r.T @ rev
    R = rev @ q.T
    d = np.sign(np.diag(K))
    d[d == 0] = 1.0
    d[2] = d[0] * d[1] * np.sign(np.linalg.det(R))    # det(D R) = +1
    D = np.diag(d)
    K, R = K @ D, D @ R
    t = np.linalg.svd(np.vstack([P, np.zeros((1, 4))]))[2][3][:, None]
    return K, R, t


def _default_split(train_split: Optional[List[int]], num_train: int):
    if train_split is None:
        i_test = list(range(N_VIEWS))[::8]
        i_train = [i for i in range(N_VIEWS) if i not in i_test]
    else:
        if len(train_split) != num_train:
            raise ValueError(f"the train split has {len(train_split)} "
                             f"views, not --num_train {num_train}")
        i_train = train_split
        i_test = [i for i in range(N_VIEWS) if i not in i_train]
    return i_train, i_test


def _read_cam_file(path: str, scale_factor: float):
    with open(path) as f:
        lines = [ln.rstrip() for ln in f.readlines()]
    extr = np.array(" ".join(lines[1:5]).split(), np.float32).reshape(4, 4)
    extr = extr @ _OPENCV2BLENDER
    intr = np.array(" ".join(lines[7:10]).split(), np.float32).reshape(3, 3)
    d0, dint = lines[11].split()[:2]
    depth_min = float(d0) * scale_factor
    depth_max = depth_min + float(dint) * 192 * scale_factor
    return intr, extr, (depth_min, depth_max)


def _read_resized(path: str, downsample: float) -> np.ndarray:
    img = read_png(path)
    wh = np.round(np.array(img.shape[1::-1]) * downsample).astype(int)
    return bilinear_resize(img, wh).astype(np.float32) / 255.0


def _read_view(root_dir, scene_id, vid, downsample):
    return _read_resized(os.path.join(
        root_dir, f"Rectified/scan{scene_id}_train/"
        f"rect_{vid + 1:03d}_{LIGHTING_ID}_r5000.png"), downsample)


def load_dtu(root_dir: str, scene_id: int, num_train: int = 42,
             scale_factor: float = 1.0 / 200.0, half_res: bool = True,
             train_split=None):
    """Returns (imgs, intrinsics [3x3 per view], poses, render_poses, hwf,
    i_split, near, far, [i_train, i_test]).

    As the reference (load_dtu.py:71-130) does, the pose is the
    transformed cam-file extrinsic itself, not its inverse."""
    i_train, i_test = _default_split(train_split, num_train)
    downsample = 0.5 if half_res else 1.0

    imgs, intrinsics, c2ws, near_fars = [], [], [], []
    H = W = 0
    focal = 0.0
    for vid in list(i_train) + list(i_test):
        img = _read_view(root_dir, scene_id, vid, downsample)
        imgs.append(img)
        intr, extr, nf = _read_cam_file(
            os.path.join(root_dir, f"Cameras/train/{vid:08d}_cam.txt"),
            scale_factor)
        intr = intr.copy()
        intr[:2] *= 4  # rectified images are 4x the camera-file resolution
        extr = extr.copy()
        extr[:3, 3] *= scale_factor
        intr[:2] *= downsample
        intrinsics.append(intr)
        c2ws.append(extr)
        near_fars.append(nf)
        H, W = img.shape[:2]
        focal = intr[0, 0]

    near = min(nf[0] for nf in near_fars)
    far = max(nf[1] for nf in near_fars)
    counts = [0, len(i_train), N_VIEWS]
    i_split = [np.arange(counts[i], counts[i + 1]) for i in range(2)]
    return (np.stack(imgs).astype(np.float32),
            np.stack(intrinsics).astype(np.float32),
            np.stack(c2ws).astype(np.float32),
            hemisphere_render_poses(), [H, W, focal], i_split, near, far,
            [i_train, i_test])


def load_dtu2(root_dir: str, scene_id: int, num_train: int = 42,
              half_res: bool = True, train_split=None):
    """IDR-style layout: scan{id}/image/%06d.png and cameras.npz."""
    scene_dir = os.path.join(root_dir, f"scan{scene_id}")
    all_cam = np.load(os.path.join(scene_dir, "cameras.npz"))
    downsample = 0.5 if half_res else 1.0

    fx = fy = cx = cy = 0.0
    imgs, poses = [], []
    H = W = 0
    for i in range(N_VIEWS):
        img = _read_resized(os.path.join(scene_dir, "image", f"{i:06d}.png"),
                            downsample)
        H, W = img.shape[:2]
        imgs.append(img)

        K, R, t = decompose_projection(all_cam[f"world_mat_{i}"][:3])
        K = K / K[2, 2]
        pose = np.eye(4, dtype=np.float32)
        pose[:3, :3] = R.transpose()
        pose[:3, 3] = (t[:3] / t[3])[:, 0]

        scale_mtx = all_cam.get(f"scale_mat_{i}")
        if scale_mtx is not None:
            pose[:3, 3:] -= scale_mtx[:3, 3:]
            pose[:3, 3:] /= np.diagonal(scale_mtx[:3, :3])[..., None]

        fx += K[0, 0] * downsample
        fy += K[1, 1] * downsample
        cx += K[0, 2] * downsample
        cy += K[1, 2] * downsample
        poses.append(_OPENCV2BLENDER @ pose @ _OPENCV2BLENDER)

    fx, fy, cx, cy = (v / N_VIEWS for v in (fx, fy, cx, cy))
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)

    i_train, i_test = _default_split(train_split, num_train)
    order = list(i_train) + list(i_test)
    imgs = np.stack([imgs[i] for i in order]).astype(np.float32)
    poses = np.stack([poses[i] for i in order]).astype(np.float32)
    counts = [0, len(i_train), N_VIEWS]
    i_split = [np.arange(counts[i], counts[i + 1]) for i in range(2)]
    return (imgs, K, poses, hemisphere_render_poses(), [H, W, fx], i_split,
            0.1, 5.0, [i_train, i_test])


def build_json_for_dtu(splits, intrinsics, poses, near, far):
    """The split dump the DTU branch of the driver writes to
    ``<expname>/split.json`` (reference run_plnerf.py:44-65)."""
    i_train, i_test = splits

    def frames(idx):
        return [{"extrinsic": np.asarray(poses[i]).tolist(),
                 "intrinsic": np.asarray(intrinsics[i]).tolist(),
                 "pose_id": int(i)} for i in idx]

    return {"near": float(near), "far": float(far),
            "train_frames": frames(i_train), "test_frames": frames(i_test)}
