"""Blender-family dataset loaders (own copy of ``plnerf/data/blender.py``),
with the reference's file layouts and skip rules:

* ``load_blender``: ``transforms_{split}.json`` and RGBA pngs, optional
  half-res ``INTER_AREA`` resize (reference load_blender.py:64-116).
* ``load_blender2``: ``{split}_transforms.json`` naming, per-frame
  intrinsics, test skip 8 (reference load_blender.py:209-280).
* ``load_blender_fixed_dist``: ``radius_{dist}_{split}`` folders and
  ``transforms_radius{dist}_{split}.json``, test skip 4 (reference
  load_blender.py:119-206).
* ``load_blender2_depth`` / ``load_blender_depth``: blender2 (or
  ``transforms_{split}.json``) naming plus a depth png per frame, its
  value over ``255 / max_depth``, valid where near < d < far before the
  clip to [near, far], and a ``video`` split of 40 hemisphere poses when
  the scene has none (reference depth_supervised_exps/data/
  load_scene_blender.py:521-635).

Images are read with ``data/png.py`` and halved with
``common.downsample_2x`` (cv2's result at a factor of 2; odd sizes raise).
The pngs of these datasets are 8-bit; a 16-bit color png reads at 16 bits
here, where the JAX package's ``imageio`` cuts it to 8.  A depth png reads
as ``cv2.imread(..., IMREAD_UNCHANGED)`` reads it: 8 or 16 bits, colour
channels in BGR(A) order (channel 0 of a colour depth png is its blue),
and is not halved under ``half_res`` while the images are.  All return
numpy arrays on the host.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from .common import (
    composite_white_background, downsample_2x, hemisphere_render_poses,
    intrinsics_from_fov, read_image_rgb, strip_alpha,
)
from .png import read_png


@dataclass
class SceneData:
    images: np.ndarray                 # [N, H, W, C]
    poses: np.ndarray                  # [N, 4, 4] or [N, 3, 5]
    render_poses: np.ndarray
    hwf: list                          # [H, W, focal]
    i_split: list                      # [i_train, i_val, i_test]
    K: Optional[np.ndarray] = None
    intrinsics: Optional[np.ndarray] = None   # [N, 4] (fx, fy, cx, cy)
    near: Optional[float] = None
    far: Optional[float] = None
    depths: Optional[np.ndarray] = None
    valid_depths: Optional[np.ndarray] = None
    gt_depths: Optional[np.ndarray] = None
    gt_valid_depths: Optional[np.ndarray] = None


def load_blender(basedir: str, half_res: bool = False,
                 testskip: int = 1) -> SceneData:
    all_imgs, all_poses, counts = [], [], [0]
    meta = None
    for split in ("train", "val", "test"):
        with open(os.path.join(basedir, f"transforms_{split}.json")) as fp:
            meta = json.load(fp)
        skip = 1 if (split == "train" or testskip == 0) else testskip
        imgs, poses = [], []
        for frame in meta["frames"][::skip]:
            fname = os.path.join(basedir, frame["file_path"] + ".png")
            imgs.append(read_png(fname))
            poses.append(np.array(frame["transform_matrix"], np.float32))
        imgs = (np.array(imgs) / 255.0).astype(np.float32)  # keep RGBA
        counts.append(counts[-1] + imgs.shape[0])
        all_imgs.append(imgs)
        all_poses.append(np.array(poses, np.float32))

    i_split = [np.arange(counts[i], counts[i + 1]) for i in range(3)]
    imgs = np.concatenate(all_imgs, 0)
    poses = np.concatenate(all_poses, 0)

    H, W = imgs[0].shape[:2]
    focal, _ = intrinsics_from_fov(H, W, float(meta["camera_angle_x"]))
    render_poses = hemisphere_render_poses()

    if half_res:
        H, W, focal = H // 2, W // 2, focal / 2.0
        imgs = np.stack([downsample_2x(img) for img in imgs])

    return SceneData(imgs, poses, render_poses, [H, W, focal], i_split)


def read_depth_png(path: str) -> np.ndarray:
    """A depth png's pixels as ``cv2.imread(path, IMREAD_UNCHANGED)``
    returns them: [H, W] gray, else [H, W, C] with the colour channels in
    BGR order (alpha stays last; gray + alpha becomes BGRA)."""
    px = read_png(path)
    if px.ndim == 2:
        return px
    if px.shape[-1] == 2:                       # gray + alpha
        g = px[..., :1]
        return np.concatenate([g, g, g, px[..., 1:]], -1)
    return np.concatenate([px[..., 2::-1], px[..., 3:]], -1)


def _read_depth(path: str, max_depth: float, near_plane: float,
                far_plane: float):
    """(depth [H, W, C] clipped to [near, far], valid [H, W]): the stored
    value over ``255 / max_depth`` (8- and 16-bit alike), valid where
    channel 0 lies strictly between near and far before the clip."""
    d = read_depth_png(path).astype(np.float64)
    d = (d / (255.0 / max_depth)).astype(np.float32)
    if d.ndim == 2:
        d = d[..., None]
    valid = np.logical_and(d[:, :, 0] > near_plane, d[:, :, 0] < far_plane)
    return np.clip(d, near_plane, far_plane), valid


def _load_blender2_family(basedir: str, json_name_fn, skips,
                          half_res: bool = True, near_plane: float = 2.0,
                          far_plane: float = 6.0, with_depth: bool = False,
                          depth_path_fn=None) -> SceneData:
    """Shared frame walk of the blender2, fixed-dist and depth loaders
    (they differ in json naming, per-split skip, and whether depth maps
    are read).  The depth loaders add a ``video`` split, 40 hemisphere
    poses at the last image's intrinsics when the scene has none."""
    folder_splits = ("train", "val", "test") + (
        ("video",) if with_depth else ())
    downsample = 2 if half_res else 1
    all_imgs: List[np.ndarray] = []
    all_depths: List[np.ndarray] = []
    all_valid: List[np.ndarray] = []
    all_poses: List[np.ndarray] = []
    all_intr: List[np.ndarray] = []
    counts = [0]
    H = W = 0
    focal = 0.0

    for split in folder_splits:
        json_path = os.path.join(basedir, json_name_fn(split))
        if not os.path.exists(json_path):
            if split == "video" and H > 0:
                vposes = hemisphere_render_poses(40)
                all_poses.append(vposes.astype(np.float32))
                all_intr.append(np.repeat(
                    np.array([(focal, focal, W / 2.0, H / 2.0)], np.float32),
                    len(vposes), axis=0))
                counts.append(counts[-1] + len(vposes))
                continue
            counts.append(counts[-1])
            continue
        with open(json_path) as fp:
            meta = json.load(fp)
        camera_angle_x = float(meta["camera_angle_x"])

        imgs, depths, valids, poses, intr = [], [], [], [], []
        for frame in meta["frames"][::skips[split]]:
            if len(frame["file_path"]) != 0:
                imgs.append(read_image_rgb(
                    os.path.join(basedir, frame["file_path"] + ".png"),
                    downsample=downsample))
                if with_depth:
                    dp = frame["depth_file_path"]
                    d, valid = _read_depth(
                        os.path.join(basedir, depth_path_fn(dp)
                                     if depth_path_fn is not None
                                     else dp[:-1] + ".png"),
                        frame["max_depth"], near_plane, far_plane)
                    depths.append(d)
                    valids.append(valid)
            poses.append(np.array(frame["transform_matrix"], np.float32))
            if imgs:  # dims from the last actually-read image
                H, W = imgs[-1].shape[:2]
                focal = 0.5 * W / np.tan(0.5 * camera_angle_x)
            if H == 0:
                raise ValueError(
                    f"{json_path}: first frame has an empty file_path; "
                    "cannot infer image dimensions")
            intr.append(np.array((focal, focal, W / 2.0, H / 2.0),
                                 np.float32))

        counts.append(counts[-1] + len(poses))
        if imgs:
            all_imgs.append(np.array(imgs))
            if with_depth:
                all_depths.append(np.array(depths))
                all_valid.append(np.array(valids))
        all_poses.append(np.array(poses, np.float32))
        all_intr.append(np.array(intr, np.float32))

    if not all_imgs:
        raise ValueError(f"{basedir}: no split of {folder_splits} has a "
                         "json with frames to read")
    i_split = [np.arange(counts[i], counts[i + 1])
               for i in range(len(folder_splits))]
    data = SceneData(
        images=np.concatenate(all_imgs, 0),
        poses=np.concatenate(all_poses, 0),
        render_poses=hemisphere_render_poses(),
        hwf=[H, W, focal],
        i_split=i_split,
        intrinsics=np.concatenate(all_intr, 0),
        near=near_plane,
        far=far_plane,
    )
    if with_depth:
        data.depths = np.concatenate(all_depths, 0)
        data.valid_depths = np.concatenate(all_valid, 0)
        data.gt_depths = data.depths
        data.gt_valid_depths = data.valid_depths
    return data


def load_blender2(basedir: str, half_res: bool = True) -> SceneData:
    return _load_blender2_family(
        basedir, lambda s: f"{s}_transforms.json",
        {"train": 1, "val": 1, "test": 8}, half_res=half_res)


def load_blender_fixed_dist(
    basedir: str, half_res: bool = True, train_dist: float = 1.0,
    test_dist: float = 1.0, val_dist: float = 1.0,
) -> SceneData:
    dists = {"train": train_dist, "val": val_dist, "test": test_dist}
    return _load_blender2_family(
        basedir, lambda s: f"transforms_radius{dists[s]}_{s}.json",
        {"train": 1, "val": 1, "test": 4}, half_res=half_res)


def load_blender2_depth(basedir: str, half_res: bool = True,
                        train_skip: int = 1,
                        near_plane: float = 2.0) -> SceneData:
    """``{split}_transforms.json`` naming; the depth png of a frame is its
    ``depth_file_path`` less the last character, plus ``.png``."""
    return _load_blender2_family(
        basedir, lambda s: f"{s}_transforms.json",
        {"train": train_skip, "val": 1, "test": 8, "video": 1},
        half_res=half_res, near_plane=near_plane, with_depth=True)


def load_blender_depth(basedir: str, half_res: bool = True,
                       train_skip: int = 1,
                       near_plane: float = 2.0) -> SceneData:
    """``transforms_{split}.json`` naming; the depth png is
    ``depth_file_path + "0000.png"`` for a scene whose path names a chair,
    ``"0001.png"`` otherwise (the reference's suffix, :568-571)."""
    suffix = "0000.png" if "chair" in basedir else "0001.png"
    return _load_blender2_family(
        basedir, lambda s: f"transforms_{s}.json",
        {"train": train_skip, "val": 1, "test": 8, "video": 1},
        half_res=half_res, near_plane=near_plane, with_depth=True,
        depth_path_fn=lambda dp: dp + suffix)


def apply_background(images: np.ndarray, white_bkgd: bool) -> np.ndarray:
    if white_bkgd:
        return composite_white_background(images)
    return strip_alpha(images)
