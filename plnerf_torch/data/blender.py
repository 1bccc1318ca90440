"""Blender-family dataset loaders (own copy of ``plnerf/data/blender.py``),
with the reference's file layouts and skip rules:

* ``load_blender``: ``transforms_{split}.json`` and RGBA pngs, optional
  half-res ``INTER_AREA`` resize (reference load_blender.py:64-116).
* ``load_blender2``: ``{split}_transforms.json`` naming, per-frame
  intrinsics, test skip 8 (reference load_blender.py:209-280).
* ``load_blender_fixed_dist``: ``radius_{dist}_{split}`` folders and
  ``transforms_radius{dist}_{split}.json``, test skip 4 (reference
  load_blender.py:119-206).

Images are read with ``data/png.py`` and halved with
``common.downsample_2x`` (cv2's result at a factor of 2; odd sizes raise).
The pngs of these datasets are 8-bit; a 16-bit color png reads at 16 bits
here, where the JAX package's ``imageio`` cuts it to 8.  The depth loaders
(``load_blender2_depth``, ``load_blender_depth``) are not ported yet
(ROADMAP A9).  All return numpy arrays on the host.
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


def _load_blender2_family(basedir: str, json_name_fn, skips,
                          half_res: bool = True, near_plane: float = 2.0,
                          far_plane: float = 6.0) -> SceneData:
    """Shared frame walk of the blender2 and fixed-dist loaders (they
    differ only in json naming and per-split skip)."""
    folder_splits = ("train", "val", "test")
    downsample = 2 if half_res else 1
    all_imgs: List[np.ndarray] = []
    all_poses: List[np.ndarray] = []
    all_intr: List[np.ndarray] = []
    counts = [0]
    H = W = 0
    focal = 0.0

    for split in folder_splits:
        json_path = os.path.join(basedir, json_name_fn(split))
        if not os.path.exists(json_path):
            counts.append(counts[-1])
            continue
        with open(json_path) as fp:
            meta = json.load(fp)
        camera_angle_x = float(meta["camera_angle_x"])

        imgs, poses, intr = [], [], []
        for frame in meta["frames"][::skips[split]]:
            if len(frame["file_path"]) != 0:
                imgs.append(read_image_rgb(
                    os.path.join(basedir, frame["file_path"] + ".png"),
                    downsample=downsample))
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
        all_poses.append(np.array(poses, np.float32))
        all_intr.append(np.array(intr, np.float32))

    i_split = [np.arange(counts[i], counts[i + 1])
               for i in range(len(folder_splits))]
    return SceneData(
        images=np.concatenate(all_imgs, 0),
        poses=np.concatenate(all_poses, 0),
        render_poses=hemisphere_render_poses(),
        hwf=[H, W, focal],
        i_split=i_split,
        intrinsics=np.concatenate(all_intr, 0),
        near=near_plane,
        far=far_plane,
    )


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


def load_blender2_depth(*args, **kwargs) -> SceneData:
    raise NotImplementedError("the depth loaders are not ported yet "
                              "(ROADMAP A9)")


load_blender_depth = load_blender2_depth


def apply_background(images: np.ndarray, white_bkgd: bool) -> np.ndarray:
    if white_bkgd:
        return composite_white_background(images)
    return strip_alpha(images)
