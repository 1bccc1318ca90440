"""Dataset dispatch for the CLI drivers (own copy of the blender branch of
``plnerf/cli/datasets.py``): blender / blender2 / blender_fixeddist, with
near from ``--set_near_plane``, far 6 and the white-background composite
(reference run_plnerf.py:981-1128).  The llff and DTU branches are not
ported yet (ROADMAP A7b).  Returns a uniform bundle the tasks consume.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np

from ..data import blender as dblender
from ..data.blender import SceneData


@dataclasses.dataclass
class DatasetBundle:
    data: SceneData
    near: float
    far: float
    ndc: bool = False
    i_train: np.ndarray = None
    i_val: np.ndarray = None
    i_test: np.ndarray = None


def _composite(images: np.ndarray, white_bkgd: bool) -> np.ndarray:
    if images.shape[-1] == 4:
        if white_bkgd:
            return images[..., :3] * images[..., -1:] + (1.0 - images[..., -1:])
        return images[..., :3]
    return images


def _ensure_K(data: SceneData) -> SceneData:
    """Fill the intrinsics matrix from hwf when the loader didn't
    (reference run_plnerf.py:1138-1143)."""
    if data.K is None:
        H, W, focal = int(data.hwf[0]), int(data.hwf[1]), float(data.hwf[2])
        data.K = np.array(
            [[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]], np.float32
        )
    return data


def load_dataset(args) -> DatasetBundle:
    scene_dir = os.path.join(args.data_dir, args.scene_id)
    if args.dataset in ("llff", "DTU", "DTU2"):
        raise SystemExit(f"--dataset {args.dataset}: the llff and DTU "
                         "loaders are not ported yet (ROADMAP A7b)")
    if args.dataset not in ("blender", "blender2", "blender_fixeddist"):
        raise SystemExit(f"Unknown dataset type {args.dataset}")
    if args.dataset == "blender":
        data = dblender.load_blender(
            scene_dir, half_res=args.half_res, testskip=args.testskip)
    elif args.dataset == "blender2":
        data = dblender.load_blender2(scene_dir, half_res=args.half_res)
    else:
        data = dblender.load_blender_fixed_dist(
            scene_dir, half_res=args.half_res, train_dist=1.0,
            test_dist=args.test_dist)
    data.images = _composite(data.images, args.white_bkgd)
    near = float(args.set_near_plane)
    far = 6.0
    data.near, data.far = near, far
    i_train, i_val, i_test = [np.asarray(s) for s in data.i_split]
    return DatasetBundle(_ensure_K(data), near, far, False, i_train, i_val,
                         i_test)
