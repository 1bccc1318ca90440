"""Depth-supervised (sample-based space-carving) driver (port of
``plnerf/cli/run_depth.py``, the reference ``depth_supervised_exps/
run_nerf_sample_based_depth.py``):

    python -m plnerf_torch.cli.run_depth {train,test,test_opt,
        test_samples_error,video} --dataset blender2_depth [--device cpu] ...

Differences from the NVS driver, all the reference's:

* a positional ``task`` and its own flag surface (:1256-1406);
* pi-scaled positional encoding, multires 9 and no view encoding by
  default, softplus(beta=10) density, Xavier init;
* pixel-centre rays from each image's vector intrinsics;
* one joint Adam over both networks with an elementwise grad clip of
  +-0.1 and the staged decay between ``--start_decay_lrate`` and
  ``--end_decay_lrate``;
* per-image depth scale / shift trained by their own Adam while
  ``i < freeze_ss``, and with ``--opt_ch_cam`` per-image camera
  embeddings by a third;
* loss = mse + space_carving_weight * space carving (the predicted
  termination quantiles against the image's scaled depth) + mse0.

Tasks: ``train``; ``test`` and ``test_opt`` (held-out views with PSNR /
SSIM / depth RMSE; with camera channels, ``test_opt`` or a model trained
with ``--opt_ch_cam`` first fits each view's embedding,
``train/camera_opt.py``); ``test_samples_error`` (the importance-sampling
error over the valid-depth pixels); ``video`` (the 40 hemisphere poses of
the ``video`` split, rgb and depth frames as PNGs in ``video/``).  Result
folders are named as the JAX driver names them.  Datasets:
blender2_depth, blender_depth.

``--occ_grid``: grid-guided coarse samples, the grid updated by each
step and checkpointed as a ``.occ`` sidecar, as in ``run_plnerf``; here
the degenerate-guidance advisory only prints (at the ``i_print``
cadence), with no fallback, and test-time camera optimization renders
without the grid (uniform samples), as in the JAX driver.

Runs on the CUDA device unless ``--device cpu`` is given, and raises where
there is none.  ``--use_kernel`` (for ``--use_pallas``) is AUTO, on
whenever the device is CUDA, as in ``run_plnerf``.  Refused with
``SystemExit`` naming their ROADMAP item: ``--lpips_weights`` (A14),
more than one CUDA device without ``--no_mesh`` (A15), and
``--steps_per_dispatch`` above 1 (the port runs one step per loop
iteration).

Randomness: each step's image is ``np.random.default_rng(--random_seed)
.choice(i_train)``, the sequence the JAX driver draws; its pixels and the
renderer's draws come from one ``torch.Generator`` seeded
``--random_seed``.  A resumed run restarts both from the seed, as the JAX
driver does.  Unlike the JAX driver, the eval tasks honour
``--no_reload`` (evaluate the fresh init), as ``run_plnerf``'s do.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch

from ..checkpoint import io as ckio
from ..core import rays as raysmod
from ..core.config import ModelConfig, RenderConfig
from ..data import blender as dblender
from ..device import make_generator, resolve_device
from ..eval import images as EI
from ..eval import metrics as Mx
from ..train import batching
from ..train.camera_opt import optimize_camera_embedding
from ..train.step import (TrainSetup, apply_occ_update, init_state,
                          make_depth_train_step)
from ..utils.logging import MetricsLogger
from .config import (ConfigArgumentParser, add_occ_flags, resolve_args,
                     str2bool)
from .run_plnerf import (_occ_advisory, _resolve_kernel, eval_render_config,
                         occ_cfg_from_args, occ_for_eval, occ_train_grid,
                         save_checkpoint)

TASKS = ("train", "test", "test_opt", "test_samples_error", "video")


def config_parser() -> ConfigArgumentParser:
    """Flag surface of the depth script (reference :1256-1406) with the
    JAX package's additions; ``--use_kernel`` and ``--device`` as in
    ``cli/config.py``."""
    p = ConfigArgumentParser()
    a = p.add_argument
    a("task", type=str, nargs="?", default="train",
      help="train | test | test_opt | test_samples_error | video")
    a("--config", type=str, default=None)
    a("--expname", type=str, default=None)
    a("--dataset", type=str, default="blender2_depth")
    a("--netdepth", type=int, default=8)
    a("--netwidth", type=int, default=256)
    a("--netdepth_fine", type=int, default=8)
    a("--netwidth_fine", type=int, default=256)
    a("--N_rand", type=int, default=32 * 32)
    a("--num_iterations", type=int, default=500000)
    a("--lrate", type=float, default=5e-4)
    a("--start_decay_lrate", type=int, default=400000)
    a("--end_decay_lrate", type=int, default=500000)
    a("--chunk", type=int, default=1024 * 32)
    a("--netchunk_per_gpu", type=int, default=1024 * 64 * 4)
    a("--no_reload", action="store_true")
    a("--N_samples", type=int, default=256)
    a("--N_importance", type=int, default=0)
    a("--perturb", type=float, default=1.0)
    a("--use_viewdirs", action="store_true", default=True)
    a("--i_embed", type=int, default=0)
    a("--multires", type=int, default=9)
    a("--multires_views", type=int, default=0)
    a("--raw_noise_std", type=float, default=0.0)
    a("--lindisp", action="store_true", default=False)
    a("--i_print", type=int, default=100)
    a("--i_img", type=int, default=600000)
    a("--i_weights", type=int, default=100000)
    a("--ckpt_dir", type=str, default="")
    a("--scene_id", type=str, default="chair")
    a("--data_dir", type=str, default="")
    a("--train_jsonfile", type=str, default="transforms_train.json")
    a("--precrop_iters", type=int, default=0)
    a("--precrop_frac", type=float, default=0.5)
    a("--white_bkgd", action="store_true")
    a("--half_res", action="store_true")
    a("--random_seed", type=int, default=0)
    a("--cimle_dir", type=str, default="")
    a("--num_hypothesis", type=int, default=20)
    a("--space_carving_weight", type=float, default=0.007)
    a("--warm_start_nerf", type=int, default=0)
    a("--scaleshift_lr", default=1e-6, type=float)
    a("--scale_init", default=1.0, type=float)
    a("--shift_init", default=0.0, type=float)
    a("--freeze_ss", type=int, default=0)
    a("--is_joint", default=False, type=str2bool)
    a("--norm_p", type=int, default=2)
    a("--space_carving_threshold", type=float, default=0.0)
    a("--mask_corners", default=False, type=str2bool)
    a("--input_ch_cam", type=int, default=0)
    a("--opt_ch_cam", action="store_true", default=False)
    a("--ch_cam_lr", default=1e-4, type=float)
    a("--mode", type=str, default="constant")
    a("--color_mode", type=str, default="midpoint")
    a("--quad_solution_v2", default=True, type=str2bool)
    a("--zero_tol", type=float, default=1e-4)
    a("--epsilon", type=float, default=1e-3)
    a("--set_near_plane", default=0.5, type=float)
    a("--train_skip", default=1, type=int)
    # additions of the JAX package and the port
    a("--lpips_weights", type=str, default=None,
      help="LPIPS weights for eval (not ported yet: ROADMAP A14)")
    a("--steps_per_dispatch", type=int, default=1,
      help="kept for config parity with the JAX driver, which scans N "
           "steps in one program; the port accepts only 1")
    a("--mlp_dtype", type=str, default="float32")
    a("--use_kernel", action=argparse.BooleanOptionalAction, default=None,
      help="the fused CUDA MLP kernels (folded heads); unset is AUTO: on "
           "for a CUDA device, off on the CPU")
    a("--device", type=str, default=None, choices=["cpu", "cuda"],
      help="where to run; unset means the CUDA device (raises without "
           "one)")
    a("--no_mesh", action="store_true",
      help="run on one device where several are visible (the port has no "
           "data parallelism yet, ROADMAP A15)")
    a("--eval_N_samples", type=int, default=None,
      help="eval tasks: sample-budget override (see run_plnerf)")
    a("--eval_N_importance", type=int, default=None)
    a("--eval_det", action="store_true",
      help="eval tasks: deterministic sample placement (see run_plnerf)")
    add_occ_flags(a)
    return p


def build_configs(args):
    device = resolve_device(getattr(args, "device", None))
    mcfg = ModelConfig(
        netdepth=args.netdepth, netwidth=args.netwidth,
        use_viewdirs=args.use_viewdirs, multires=args.multires,
        multires_views=args.multires_views, i_embed=args.i_embed,
        pi_bands=True, input_ch_cam=args.input_ch_cam,
        density_activation="softplus10", init="xavier")
    mcfg_fine = None
    if (args.netdepth_fine != args.netdepth
            or args.netwidth_fine != args.netwidth):
        mcfg_fine = dataclasses.replace(mcfg, netdepth=args.netdepth_fine,
                                        netwidth=args.netwidth_fine)
    kernel = _resolve_kernel(args, device)
    rcfg = RenderConfig(
        n_samples=args.N_samples, n_importance=args.N_importance,
        mode=args.mode, color_mode=args.color_mode, lindisp=args.lindisp,
        perturb=args.perturb > 0.0, use_viewdirs=args.use_viewdirs,
        white_bkgd=args.white_bkgd, raw_noise_std=args.raw_noise_std,
        zero_tol=args.zero_tol, epsilon=args.epsilon,
        compute_pred_hyp=args.space_carving_weight > 0.0,
        is_joint=args.is_joint, trim_first_weight=True,
        mlp_dtype=args.mlp_dtype, use_fused_mlp=kernel,
        fused_fold_heads=kernel)
    setup = TrainSetup(
        mcfg=mcfg, mcfg_fine=mcfg_fine, rcfg=rcfg, lrate=args.lrate,
        joint_optimizer=True, grad_clip_value=0.1,
        space_carving_weight=args.space_carving_weight,
        warm_start_nerf=args.warm_start_nerf, is_joint=args.is_joint,
        norm_p=args.norm_p,
        space_carving_threshold=args.space_carving_threshold,
        scaleshift_lr=args.scaleshift_lr, freeze_ss=args.freeze_ss,
        start_decay_lrate=args.start_decay_lrate,
        end_decay_lrate=args.end_decay_lrate,
        opt_ch_cam=args.opt_ch_cam, ch_cam_lr=args.ch_cam_lr)
    return mcfg, rcfg, setup


def load_depth_dataset(args) -> dblender.SceneData:
    scene_dir = os.path.join(args.data_dir, args.scene_id)
    if args.dataset == "blender_depth":
        loader = dblender.load_blender_depth
    elif args.dataset == "blender2_depth":
        loader = dblender.load_blender2_depth
    else:
        raise SystemExit(
            f"Dataloader not implemented for dataset: {args.dataset}")
    data = loader(scene_dir, half_res=args.half_res,
                  train_skip=args.train_skip, near_plane=args.set_near_plane)
    data.images = dblender.apply_background(data.images, args.white_bkgd)
    # the per-frame vector intrinsics are the pixel-centre convention's K
    data.K = np.asarray(data.intrinsics[0])
    return data


def exp_dir(args) -> str:
    return os.path.join(args.ckpt_dir, args.expname)


def depth_batch(images: torch.Tensor, poses: torch.Tensor,
                intrinsics: torch.Tensor, depths: torch.Tensor,
                sc_mask: torch.Tensor, img_i: int, n_rand: int, near: float,
                far: float, use_viewdirs: bool,
                generator: torch.Generator) -> dict:
    """One step's batch from image ``img_i`` (every array on the device,
    indexed by image): ``n_rand`` random pixels, their pixel-centre rays
    from the image's vector intrinsics, colours, depth hypothesis
    ``target_h`` [1, R, 1] and validity mask."""
    H, W = images.shape[1], images.shape[2]
    y, x = batching.select_pixels(generator, H, W, n_rand, False, 0.5,
                                  device=images.device)
    rays_o, rays_d = raysmod.get_rays_pixelcenter(
        H, W, intrinsics[img_i], poses[img_i, :3, :4],
        torch.stack([y, x], -1))
    viewdirs = (rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
                if use_viewdirs else None)
    return {"rays": raysmod.pack_rays(rays_o, rays_d, near, far, viewdirs),
            "target": images[img_i, y, x],
            "target_h": depths[img_i, y, x][None, :, None],
            "sc_mask": sc_mask[img_i, y, x], "img_idx": img_i}


def init_depth_state(args, setup: TrainSetup, n_images: int,
                     device: torch.device):
    """Returns ``(state, start, path)``: a fresh state seeded
    ``--random_seed`` (scales times ``--scale_init``, shifts plus
    ``--shift_init``), then, unless ``--no_reload``, the experiment's
    latest checkpoint when there is one; ``path`` is the file restored or
    None."""
    state = init_state(make_generator(args.random_seed, device), setup,
                       device, n_images=n_images)
    with torch.no_grad():
        state.depth_scales.mul_(args.scale_init)
        state.depth_shifts.add_(args.shift_init)
    path = None if args.no_reload else ckio.latest_checkpoint(exp_dir(args))
    if path:
        ckio.restore_checkpoint(path, state, device)
        print(f"Resumed from {path} at step {state.step}")
    return state, state.step, path


def run_training(args, data, setup: TrainSetup, mcfg: ModelConfig,
                 rcfg: RenderConfig):
    """The train loop; returns the final ``TrainState``."""
    device = resolve_device(args.device)
    i_train, i_val, i_test = [np.asarray(s) for s in data.i_split[:3]]
    if len(i_val) == 0:
        i_val = i_test
    state, start, ckpt_path = init_depth_state(args, setup,
                                               data.images.shape[0], device)
    logger = MetricsLogger(exp_dir(args))
    occ_cfg = occ_cfg_from_args(args)
    occ_state, occ_warm_end = None, 0
    if occ_cfg is not None:
        occ_state, occ_warm_end = occ_train_grid(args, occ_cfg, ckpt_path,
                                                 start, device)

    def dev(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    # the ground-truth depth is the single space-carving hypothesis
    # (reference :1068-1070)
    images, poses, intrinsics = (dev(data.images), dev(data.poses),
                                 dev(data.intrinsics))
    depths = dev(np.asarray(data.gt_depths)[..., 0])
    sc_mask = np.asarray(data.gt_valid_depths).astype(np.float32)
    sc_mask = dev(sc_mask[..., 0] if sc_mask.ndim == 4 else sc_mask)
    step_fn = make_depth_train_step(setup)
    occ_setup = occ_step = None
    if occ_cfg is not None:
        occ_setup = dataclasses.replace(setup, rcfg=dataclasses.replace(
            rcfg, occ=occ_cfg))
        occ_step = make_depth_train_step(occ_setup)
    g = make_generator(args.random_seed, device)
    rng = np.random.default_rng(args.random_seed)
    t0 = time.time()
    steps_since_print = 0
    occ_warned = False
    for i in range(start + 1, args.num_iterations + 1):
        img_i = int(rng.choice(i_train))
        batch = depth_batch(images, poses, intrinsics, depths, sc_mask,
                            img_i, args.N_rand, data.near, data.far,
                            rcfg.use_viewdirs, g)
        occ_on = occ_cfg is not None and i > occ_warm_end
        if occ_on:
            state, metrics = occ_step(state, dict(batch, occ_grid=occ_state),
                                      g)
            occ_state, metrics = apply_occ_update(occ_setup, occ_state,
                                                  batch, metrics)
        else:
            state, metrics = step_fn(state, batch, g)
        steps_since_print += 1

        if i % args.i_print == 0:
            m = {k: float(v) for k, v in metrics.items()}   # host sync
            m["steps_per_sec"] = steps_since_print / max(
                time.time() - t0, 1e-9)
            t0 = time.time()
            steps_since_print = 0
            with torch.no_grad():
                m["depth_scale_mean"] = float(state.depth_scales.mean())
                m["depth_shift_mean"] = float(state.depth_shifts.mean())
            logger.scalars(i, m, prefix="train/")
            print(f"[DEPTH TRAIN] Iter: {i} Loss: {m['loss']:.5f} "
                  f"PSNR: {m['psnr']:.2f} SC: "
                  f"{m.get('space_carving_loss', 0.0):.5f}")
            if occ_on:
                # depth supervision usually closes the degenerate-scene
                # gap, so this only advises
                occ_warned = _occ_advisory(m, i, occ_warm_end, occ_warned)
        if i % args.i_img == 0 and len(i_val) > 0:
            # a val view and its depth RMSE (reference :1203-1232)
            vi = int(i_val[(i // args.i_img) % len(i_val)])
            out = EI.render_image(
                state.params_coarse, state.params_fine, data.poses[vi],
                data.hwf, data.intrinsics[vi], mcfg,
                EI.test_render_config(rcfg, occ=occ_cfg), near=data.near,
                far=data.far, chunk=args.chunk, pixel_center=True,
                mcfg_fine=setup.mcfg_fine, occ_grid=occ_state)
            val_mse = float(np.mean(
                (out["rgb_map"] - np.asarray(data.images[vi])) ** 2))
            rec = {"mse": val_mse, "psnr": Mx.mse2psnr(val_mse)}
            gt = np.asarray(data.gt_depths[vi])[..., 0]
            valid = np.asarray(data.gt_valid_depths[vi]).astype(bool)
            if valid.any():
                rec["depth_rmse"] = Mx.depth_rmse(out["depth_map"], gt,
                                                  valid)
            logger.scalars(i, rec, prefix="val/")
            logger.image(i, "val/rgb", np.clip(out["rgb_map"], 0, 1))
        if i % args.i_weights == 0:
            save_checkpoint(args, state, occ_state)
    save_checkpoint(args, state, occ_state)
    logger.close()
    return state


def run_test(args, data, setup: TrainSetup, mcfg: ModelConfig, test_rcfg,
             state, occ_grid=None):
    """``test`` / ``test_opt``: the held-out views, each first fitted its
    camera embedding where the model has camera channels and the task is
    ``test_opt`` or the model trained them (without the grid); returns the
    ``MeanTracker``."""
    i_test = np.asarray(data.i_split[2])
    with_opt = (mcfg.input_ch_cam > 0
                and (args.task == "test_opt" or args.opt_ch_cam))
    if args.task == "test_opt" and mcfg.input_ch_cam == 0:
        print("WARNING: test_opt without --input_ch_cam > 0 — nothing to "
              "optimize; running plain test")
    cam_embeddings = None
    if with_opt:
        cam_embeddings = {
            int(ti): optimize_camera_embedding(
                state.params_coarse, state.params_fine,
                np.asarray(data.images[ti]), data.poses[ti],
                data.intrinsics[ti], mcfg, test_rcfg, near=data.near,
                far=data.far, n_rand=args.N_rand)
            for ti in i_test}
    mm, res = EI.render_images_with_metrics(
        state.params_coarse, state.params_fine, data, i_test, mcfg,
        test_rcfg, chunk=args.chunk, pixel_center=True,
        cam_embeddings=cam_embeddings, mcfg_fine=setup.mcfg_fine,
        occ_grid=occ_grid)
    result_dir = os.path.join(
        exp_dir(args),
        f"test_images_{args.mode}_{args.N_samples}_{args.N_importance}"
        f"{'with_optimization_' if with_opt else ''}{args.scene_id}")
    EI.write_images_with_metrics(res, mm, result_dir)
    return mm


def run_video(args, data, setup: TrainSetup, mcfg: ModelConfig, test_rcfg,
              state, occ_grid) -> np.ndarray:
    """The ``video`` split's poses (the test views where the scene has
    none) with pixel-centre rays and no camera embedding, into
    ``video/``: ``{i:03d}.png``, ``write_video``'s ``video/{i:03d}.png``,
    and the 16-bit and Turbo depth frames of ``write_depth_video_frames``
    (reference render_video, :283-300).  Returns the rgbs."""
    i_video = (np.asarray(data.i_split[3]) if len(data.i_split) > 3
               else np.asarray(data.i_split[2]))
    savedir = os.path.join(exp_dir(args), "video")
    rgbs, _, depths = EI.render_path(
        state.params_coarse, state.params_fine,
        np.asarray(data.poses)[i_video], data.hwf, data.K, mcfg, test_rcfg,
        near=data.near, far=data.far, chunk=args.chunk, savedir=savedir,
        pixel_center=True, mcfg_fine=setup.mcfg_fine, occ_grid=occ_grid)
    EI.write_video(os.path.join(savedir, "video.mp4"), rgbs, fps=10)
    EI.write_depth_video_frames(savedir, depths, far=data.far)
    return rgbs


def _refuse_unported(args) -> None:
    if args.lpips_weights:
        raise SystemExit("--lpips_weights: LPIPS is not ported yet "
                         "(ROADMAP A14)")
    if args.steps_per_dispatch > 1:
        raise SystemExit(f"--steps_per_dispatch {args.steps_per_dispatch}: "
                         "the port runs one step per loop iteration; only 1 "
                         "is accepted")
    if (args.device != "cpu" and torch.cuda.device_count() > 1
            and not args.no_mesh):
        raise SystemExit(f"{torch.cuda.device_count()} CUDA devices: data "
                         "parallelism is not ported yet (ROADMAP A15); pass "
                         "--no_mesh to run on one")
    if args.task not in TASKS:
        raise SystemExit(f"Unknown task {args.task}")


def run(args):
    """Run ``args.task``; returns the final ``TrainState`` (train), the
    metrics' ``MeanTracker`` (the eval tasks) or the frames (video)."""
    _refuse_unported(args)
    if args.task != "train":
        # eval-time sample-budget override; mutating args keeps rcfg and
        # the result-folder naming consistent with the counts used
        if getattr(args, "eval_N_samples", None):
            args.N_samples = args.eval_N_samples
        if getattr(args, "eval_N_importance", None):
            args.N_importance = args.eval_N_importance
    mcfg, rcfg, setup = build_configs(args)
    data = load_depth_dataset(args)
    if args.task == "train":
        return run_training(args, data, setup, mcfg, rcfg)
    device = resolve_device(args.device)
    state, start, path = init_depth_state(args, setup, data.images.shape[0],
                                          device)
    if start == 0 and not args.no_reload:
        print("WARNING: no checkpoint found — evaluating fresh init")
    occ_cfg, occ_grid = occ_for_eval(args, path, device)
    test_rcfg = eval_render_config(args, rcfg, occ_cfg)
    if args.task == "test_samples_error":
        # the depth variant: valid-depth-masked, the reference's naming
        # (run_nerf_sample_based_depth.py:400-420)
        return EI.test_images_samples(
            state.params_coarse, state.params_fine, data,
            np.asarray(data.i_split[2]), mcfg, test_rcfg,
            os.path.join(exp_dir(args),
                         f"test_predicted_samples_error_{args.N_importance}"),
            chunk=args.chunk, pixel_center=True,
            valid_mask_from_dataset=True,
            metrics_filename="metrics_depth_samples.txt",
            mcfg_fine=setup.mcfg_fine, occ_grid=occ_grid)
    if args.task == "video":
        return run_video(args, data, setup, mcfg, test_rcfg, state, occ_grid)
    return run_test(args, data, setup, mcfg, test_rcfg, state, occ_grid)


def main(argv=None):
    """Parse ``argv``; before anything is read or written, resolve the
    device (raises without CUDA unless ``--device cpu``) and refuse what is
    not ported; then run with the args.json round trip of
    ``cli/config.resolve_args``."""
    args = config_parser().parse_args(argv)
    resolve_device(args.device)
    _refuse_unported(args)
    return run(resolve_args(args))


if __name__ == "__main__":
    main()
