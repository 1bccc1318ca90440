"""Dataset dispatch for the CLI drivers (own copy of
``plnerf/cli/datasets.py``, the reference driver's dataset branches,
run_plnerf.py:981-1128): llff (NDC bounds, or the scene's bounds with
``--no_ndc``), blender / blender2 / blender_fixeddist (near from
``--set_near_plane``, far 6, the white-background composite), DTU / DTU2
(the split.json dump).  Returns a uniform bundle the tasks consume.
"""
from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

from ..data import blender as dblender
from ..data import dtu as ddtu
from ..data import llff as dllff
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


def _load_llff(args, scene_dir: str) -> DatasetBundle:
    images, poses, bds, render_poses, i_test0 = dllff.load_llff_data(
        scene_dir, factor=args.factor, recenter=True, bd_factor=0.75,
        spherify=args.spherify)
    hwf = [int(poses[0, 0, -1]), int(poses[0, 1, -1]),
           float(poses[0, 2, -1])]
    poses = poses[:, :3, :4]
    n = images.shape[0]
    if args.llffhold > 0:
        i_test = np.arange(n)[::args.llffhold]
    else:
        i_test = np.atleast_1d(np.asarray(i_test0))
    i_val = i_test
    i_train = np.array(
        [i for i in range(n) if i not in i_test and i not in i_val])
    if args.no_ndc:
        near, far, ndc = float(np.min(bds) * 0.9), float(np.max(bds)), False
    else:
        near, far, ndc = 0.0, 1.0, True
    data = SceneData(images=images, poses=poses, render_poses=render_poses,
                     hwf=hwf, i_split=[i_train, i_val, i_test], near=near,
                     far=far)
    return DatasetBundle(_ensure_K(data), near, far, ndc, i_train, i_val,
                         i_test)


def _load_dtu(args) -> DatasetBundle:
    train_split = None
    if args.dtu_split is not None:
        with open(args.dtu_split) as f:
            train_split = json.load(f)
    loader = ddtu.load_dtu if args.dataset == "DTU" else ddtu.load_dtu2
    # (imgs, intrinsics | K, poses, render_poses, hwf, i_split, near, far,
    # [i_train, i_test])
    images, intr, poses, render_poses, hwf, i_split, near, far, _ = loader(
        args.data_dir, args.dtu_scene_id, num_train=args.num_train,
        half_res=args.half_res, train_split=train_split)
    images = _composite(images, args.white_bkgd)
    intr = np.asarray(intr, np.float32)
    K = intr[0] if intr.ndim == 3 else intr
    per_view_K = intr if intr.ndim == 3 else None
    i_train, i_test = [np.asarray(s) for s in i_split[:2]]
    data = SceneData(images=images, poses=np.asarray(poses),
                     render_poses=np.asarray(render_poses), hwf=list(hwf),
                     i_split=[i_train, i_test, i_test], K=K,
                     intrinsics=per_view_K, near=float(near), far=float(far))
    # the split dump (reference run_plnerf.py:1095-1099)
    if getattr(args, "expname", None) and getattr(args, "ckpt_dir", ""):
        exp = os.path.join(args.ckpt_dir, args.expname)
        if os.path.isdir(exp):
            Ks = per_view_K if per_view_K is not None \
                else [K] * data.poses.shape[0]
            with open(os.path.join(exp, "split.json"), "w") as f:
                json.dump(ddtu.build_json_for_dtu(
                    (i_train, i_test), Ks, data.poses, near, far), f,
                    indent=4)
    return DatasetBundle(data, float(near), float(far), False, i_train,
                         i_test, i_test)


def load_dataset(args) -> DatasetBundle:
    scene_dir = os.path.join(args.data_dir, args.scene_id)
    if args.dataset == "llff":
        return _load_llff(args, scene_dir)
    if args.dataset in ("DTU", "DTU2"):
        return _load_dtu(args)
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
