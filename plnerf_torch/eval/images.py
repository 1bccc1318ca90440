"""Full-image rendering, metric evaluation and result writers (port of
``render_image``, ``test_render_config``, ``render_images_with_metrics``,
``test_images_samples``, ``write_images_with_metrics``, ``render_path``,
``write_video`` and ``write_depth_video_frames`` from
``plnerf/eval/images.py``).

A Python loop over fixed-size ray chunks replaces the JAX package's
``lax.map``; chunk ``i`` draws from a generator seeded ``seed + i``.
Images are written with ``data/png.py``, metrics computed on the host
(``eval/metrics.py``), LPIPS (``eval/lpips.py``, ``lpips_fn``) on the
device it was loaded on.  A model trained with the occupancy grid renders
with it: ``occ_grid`` is required whenever ``rcfg.occ`` is set.

Data parallelism (``mesh``, ``parallel/mesh.py``): chunk ``i`` renders on
rank ``i % world`` with its own seed ``seed + i`` and the rows are
all-gathered, so the maps equal the one-device maps bit for bit (a
deliberate difference from the JAX package's sharded renderer, which
folds the mesh axis index into each chip's key).  Every rank renders;
metrics and files are made on rank 0 only.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import time
from typing import Callable, ContextManager, Dict, Optional, Sequence

import numpy as np
import torch

from ..core import rays as raysmod
from ..core import render
from ..core.config import ModelConfig, RenderConfig
from ..core.mlp import NeRF
from ..data.png import write_png
from ..device import make_generator, module_device
from ..parallel import mesh as pmesh
from ..utils.misc import MeanTracker, to8b, to16b
from . import metrics as M
from .turbo import TURBO

# keys returned to the host per pixel
_IMAGE_KEYS = ("rgb_map", "disp_map", "acc_map", "depth_map", "rgb0", "depth0")

# the eval's note where there is no LPIPS weights file, in the JAX
# package's words (plnerf/eval/images.py:329-337)
LPIPS_UNAVAILABLE = ("UNAVAILABLE (no weights file — export one with "
                     "tools/export_lpips_weights.py and set --lpips_weights "
                     "or PLNERF_LPIPS_WEIGHTS)")


def render_chunks(params_c: NeRF, params_f: Optional[NeRF],
                  rays: torch.Tensor, mcfg: ModelConfig, rcfg: RenderConfig,
                  chunk: int, seed: int, keys, cam_embedding=None,
                  mcfg_fine: Optional[ModelConfig] = None,
                  keep_hyp: bool = False, occ_grid=None,
                  mesh: Optional[pmesh.Mesh] = None,
                  join: Callable[[], ContextManager] = contextlib.nullcontext
                  ) -> Dict[str, torch.Tensor]:
    """Render ``rays`` [n, 8|11] chunk by chunk; returns the ``keys``
    maps (and ``pred_hyp`` with ``keep_hyp``) concatenated over chunks, on
    the rays' device.  ``occ_grid``: the trained occupancy grid, required
    when ``rcfg.occ`` is set (a model trained grid-guided is scored under
    the sample distribution it trained with).  ``mesh``: every rank
    passes the same rays, renders chunks ``rank, rank + world, ...`` and
    returns all the maps (the module docstring).  ``join``: a context
    around the join of the chunks' maps without a mesh (the serving
    renderer's ``request.assemble`` span)."""
    if rcfg.occ is not None and occ_grid is None:
        raise ValueError("rcfg.occ is set but no occ_grid was passed: "
                         "occ-trained models must be evaluated with "
                         "grid-guided sampling")
    keys = tuple(keys) + (("pred_hyp",) if keep_hyp else ())
    starts = list(range(0, rays.shape[0], chunk))

    def one(i, n=chunk):
        g = make_generator(seed + i, rays.device)
        ret = render.render_rays(params_c, params_f,
                                 rays[starts[i]:starts[i] + n], g, mcfg,
                                 rcfg, cam_embedding=cam_embedding,
                                 mcfg_fine=mcfg_fine, occ_grid=occ_grid)
        return {k: ret[k] for k in keys if k in ret}

    with torch.no_grad():
        mine = (range(len(starts)) if mesh is None
                else range(mesh.rank, len(starts), mesh.size))
        outs = [one(i) for i in mine]
        if mesh is None:
            with join():
                return {k: torch.cat([o[k] for o in outs], 0)
                        for k in outs[0]}
        # the maps' layout, from a one-ray render where this rank has no
        # chunk
        like = outs[0] if outs else one(0, 1)
        cols = {k: v.reshape(v.shape[0], -1).shape[1] for k, v in like.items()}
        flat = [torch.cat([o[k].reshape(o[k].shape[0], -1).float()
                           for k in cols], 1) for o in outs]
        sizes = [min(chunk, rays.shape[0] - s) for s in starts]
        rows = pmesh.gather_round_robin(flat, sizes, sum(cols.values()), mesh)
    out, at = {}, 0
    for k, c in cols.items():
        v = rows[:, at:at + c]
        out[k] = v.reshape((v.shape[0],) + like[k].shape[1:]).to(like[k].dtype)
        at += c
    return out


def render_image(params_c: NeRF, params_f: Optional[NeRF], c2w, hwf, K,
                 mcfg: ModelConfig, rcfg: RenderConfig, seed: int = 0,
                 near: float = 2.0, far: float = 6.0, chunk: int = 32768,
                 ndc: bool = False, render_factor: int = 0,
                 pixel_center: bool = False, cam_embedding=None,
                 mcfg_fine: Optional[ModelConfig] = None,
                 keep_hyp: bool = False, occ_grid=None,
                 mesh: Optional[pmesh.Mesh] = None) -> Dict[str, np.ndarray]:
    """Render one full image on the models' device; returns numpy maps
    shaped [H, W, ...] (``pred_hyp`` too with ``keep_hyp``, which needs
    ``rcfg.compute_pred_hyp``).  ``render_factor`` downsamples H/W/focal;
    ``pixel_center`` uses the depth-script ray convention; ``occ_grid``
    and ``mesh`` as in ``render_chunks``."""
    H, W, focal = int(hwf[0]), int(hwf[1]), float(hwf[2])
    if render_factor:
        H, W, focal = H // render_factor, W // render_factor, \
            focal / render_factor
        K = np.array([[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]],
                     np.float32)
    dev = module_device(params_c)
    c2w = torch.as_tensor(np.asarray(c2w, np.float32)[:3, :4], device=dev)
    if pixel_center:
        K = np.asarray(K)
        intrinsic = (K if K.ndim == 1 else
                     np.array([K[0, 0], K[1, 1], K[0, 2], K[1, 2]],
                              np.float32))
        rays_o, rays_d = raysmod.get_rays_pixelcenter(H, W, intrinsic, c2w)
    else:
        rays_o, rays_d = raysmod.get_rays(H, W, np.asarray(K), c2w)
    packed, _ = render.make_ray_batch(rays_o, rays_d, near, far,
                                      rcfg.use_viewdirs, ndc, H, W, focal)
    out = render_chunks(params_c, params_f, packed, mcfg, rcfg, chunk, seed,
                        _IMAGE_KEYS, cam_embedding, mcfg_fine, keep_hyp,
                        occ_grid, mesh)
    return {k: v.cpu().numpy().reshape(H, W, *v.shape[1:])
            for k, v in out.items()}


def test_render_config(rcfg: RenderConfig, **overrides) -> RenderConfig:
    """The reference's render_kwargs_test: raw_noise_std=0 but perturb
    deliberately kept True (run_plnerf.py:497-499); ``perturb=False``
    passed here is the ``--eval_det`` variant."""
    kw = dict(raw_noise_std=0.0, perturb=True, retraw=False)
    kw.update(overrides)
    return dataclasses.replace(rcfg, **kw)


def render_images_with_metrics(
    params_c: NeRF, params_f: Optional[NeRF], dataset,
    indices: Sequence[int], mcfg: ModelConfig, rcfg: RenderConfig,
    chunk: int = 32768, near: Optional[float] = None,
    far: Optional[float] = None, ndc: bool = False, seed: int = 0,
    verbose: bool = True, mcfg_fine: Optional[ModelConfig] = None,
    pixel_center: bool = False, cam_embeddings=None, occ_grid=None,
    lpips_fn=None, mesh: Optional[pmesh.Mesh] = None):
    """Render the held-out views ``indices`` of ``dataset`` (a
    ``SceneData``) and aggregate their metrics (reference
    run_plnerf.py:284-363): per image img_loss, PSNR and SSIM of the fine
    pass, img_loss0 and PSNR0 of the coarse, LPIPS of the fine pass with
    ``lpips_fn`` (``eval/lpips.py``; without one, the JAX package's
    ``lpips: UNAVAILABLE`` note), and, where the dataset
    carries depths, the depth RMSE over its valid pixels (averaged over the
    images that have any).  Returns ``(MeanTracker, res)``, ``res`` holding
    the stacked rgbs / target_rgbs / depths (/ far), the coarse rgbs0 /
    depths0 and the target_depths (/ far) / target_valid_depths for the
    writers.

    ``pixel_center``: the depth script's rays, from each view's vector
    intrinsics.  ``cam_embeddings``: {index: embedding} from test-time
    camera optimization (a view without one renders at zeros).  Image ``n``
    renders with the seeds ``seed + n * n_chunks + i`` of its chunks
    ``i``, so no two chunks share a stream.  ``occ_grid`` and ``mesh`` as
    in ``render_chunks``; under a mesh every rank renders, rank 0 scores,
    and the other ranks return an empty tracker and no images."""
    near = dataset.near if near is None else near
    far = dataset.far if far is None else far
    if near is None or far is None:
        raise ValueError("near/far must come from dataset or caller")
    H, W = int(dataset.hwf[0]), int(dataset.hwf[1])
    n_chunks = math.ceil(H * W / chunk)

    mean_metrics = MeanTracker()
    mean_depth_metrics = MeanTracker()
    res = {"rgbs": [], "target_rgbs": [], "depths": [], "target_depths": [],
           "target_valid_depths": [], "rgbs0": [], "depths0": []}
    indices = [int(i) for i in np.asarray(indices)]
    for n, img_idx in enumerate(indices):
        t0 = time.time()
        target = np.asarray(dataset.images[img_idx], np.float32)
        K_i = (dataset.intrinsics[img_idx]
               if pixel_center
               and getattr(dataset, "intrinsics", None) is not None
               else dataset.K)
        out = render_image(params_c, params_f, dataset.poses[img_idx],
                           dataset.hwf, K_i, mcfg, rcfg,
                           seed=seed + n * n_chunks, near=near, far=far,
                           chunk=chunk, ndc=ndc, pixel_center=pixel_center,
                           cam_embedding=(None if cam_embeddings is None
                                          else cam_embeddings.get(img_idx)),
                           mcfg_fine=mcfg_fine, occ_grid=occ_grid, mesh=mesh)
        if not pmesh.is_main(mesh):
            continue
        rgb = np.clip(out["rgb_map"], 0.0, 1.0)
        img_loss = float(np.mean((out["rgb_map"] - target) ** 2))
        psnr = M.mse2psnr(img_loss)
        metrics = {"img_loss": img_loss, "psnr": psnr,
                   "ssim": M.ssim(rgb, target)}
        if lpips_fn is not None:
            metrics["lpips"] = float(lpips_fn(rgb, target))
        if dataset.gt_depths is not None:
            gt_depth = np.asarray(dataset.gt_depths[img_idx])[..., 0]
            valid = np.asarray(dataset.gt_valid_depths[img_idx]).astype(bool)
            if valid.ndim == 3:
                valid = valid[..., 0]
            rmse = M.depth_rmse(out["depth_map"], gt_depth, valid)
            if not np.isnan(rmse):
                mean_depth_metrics.add({"depth_rmse": rmse})
            res["target_depths"].append(gt_depth / far)
            res["target_valid_depths"].append(valid)
        res["rgbs"].append(rgb)
        res["target_rgbs"].append(target)
        res["depths"].append(out["depth_map"] / far)
        if "rgb0" in out:
            img_loss0 = float(np.mean((out["rgb0"] - target) ** 2))
            metrics.update({"img_loss0": img_loss0,
                            "psnr0": M.mse2psnr(img_loss0)})
            res["rgbs0"].append(np.clip(out["rgb0"], 0, 1))
            res["depths0"].append(out["depth0"] / far)
        mean_metrics.add(metrics)
        if verbose:
            print(f"Render image {n + 1}/{len(indices)} "
                  f"PSNR: {psnr:.2f} ({time.time() - t0:.1f}s)")

    all_mean = MeanTracker()
    if not pmesh.is_main(mesh):
        return all_mean, {}
    res = {k: np.stack(v, 0) for k, v in res.items() if v}
    all_mean.add({**mean_metrics.as_dict(), **mean_depth_metrics.as_dict()})
    if lpips_fn is None:
        # the reference reports LPIPS for every eval (run_plnerf.py:340):
        # without weights the row still names the metric
        all_mean.note("lpips", LPIPS_UNAVAILABLE)
    return all_mean, res


def test_images_samples(
    params_c: NeRF, params_f: Optional[NeRF], dataset, indices,
    mcfg: ModelConfig, rcfg: RenderConfig, result_dir: str,
    count: Optional[int] = None, chunk: int = 32768, seed: int = 0,
    verbose: bool = True, pixel_center: bool = False,
    mcfg_fine: Optional[ModelConfig] = None,
    valid_mask_from_dataset: bool = False, ndc: bool = False,
    metrics_filename: str = "metrics_expecteddepth.txt", occ_grid=None,
    mesh: Optional[pmesh.Mesh] = None):
    """The importance-sampling-error eval (reference run_plnerf.py:218-282):
    the mean distance between each termination quantile (``pred_hyp``) and
    the expected depth, over the rays of each view, averaged over views and
    written to ``result_dir/metrics_filename`` (the depth script names it
    metrics_depth_samples.txt).  Returns the ``MeanTracker``.

    ``count`` views are drawn from ``indices`` with
    ``default_rng(seed)``; ``valid_mask_from_dataset`` averages over the
    dataset's valid-depth pixels only (the depth script,
    run_nerf_sample_based_depth.py:404-408).  ``ndc`` renders NDC rays, as
    the reference's render_kwargs do for LLFF scenes; the JAX package
    always renders world-space rays here.  Image ``n`` renders with the
    seeds ``seed + n * n_chunks + i`` of its chunks ``i``; ``occ_grid`` and
    ``mesh`` as in ``render_chunks`` (rank 0 scores and writes)."""
    rcfg = dataclasses.replace(rcfg, compute_pred_hyp=True)
    indices = list(np.asarray(indices))
    if count is not None:
        count = min(count, len(indices))
        indices = list(np.random.default_rng(seed).choice(
            indices, size=count, replace=False))
    n_chunks = math.ceil(int(dataset.hwf[0]) * int(dataset.hwf[1]) / chunk)

    mean_depth_metrics = MeanTracker()
    for n, img_idx in enumerate(indices):
        K_i = (dataset.intrinsics[img_idx]
               if pixel_center
               and getattr(dataset, "intrinsics", None) is not None
               else dataset.K)
        out = render_image(params_c, params_f, dataset.poses[img_idx],
                           dataset.hwf, K_i, mcfg, rcfg,
                           seed=seed + n * n_chunks, near=dataset.near,
                           far=dataset.far, chunk=chunk, ndc=ndc,
                           pixel_center=pixel_center, mcfg_fine=mcfg_fine,
                           keep_hyp=True, occ_grid=occ_grid, mesh=mesh)
        if not pmesh.is_main(mesh):
            continue
        dists = np.abs(out["pred_hyp"] - out["depth_map"][..., None])
        if valid_mask_from_dataset and dataset.gt_valid_depths is not None:
            valid = np.asarray(dataset.gt_valid_depths[img_idx]).astype(bool)
            if valid.ndim == 3:
                valid = valid[..., 0]
            per_ray = np.mean(dists, axis=-1)
            err = float(np.mean(per_ray[valid])) if valid.any() else np.nan
        else:
            err = float(np.mean(dists))
        if not np.isnan(err):
            mean_depth_metrics.add({"importance_sampling_error": err})
        if verbose:
            print(f"Sample-error image {n + 1}/{len(indices)}: {err:.4f}")

    if not pmesh.is_main(mesh):
        return mean_depth_metrics
    os.makedirs(result_dir, exist_ok=True)
    with open(os.path.join(result_dir, metrics_filename), "w") as f:
        mean_depth_metrics.print(f)
    return mean_depth_metrics


def write_images_with_metrics(images: Dict[str, np.ndarray],
                              mean_metrics: MeanTracker,
                              result_dir: str) -> None:
    """Write ``{n}_rgb.png``, ``{n}_gt.png``, 16-bit ``{n}_d.png`` and
    ``metrics.txt`` (reference run_plnerf.py:365-386)."""
    os.makedirs(result_dir, exist_ok=True)
    for n in range(images["rgbs"].shape[0]):
        write_png(os.path.join(result_dir, f"{n}_rgb.png"),
                  to8b(images["rgbs"][n]))
        write_png(os.path.join(result_dir, f"{n}_gt.png"),
                  to8b(images["target_rgbs"][n]))
        write_png(os.path.join(result_dir, f"{n}_d.png"),
                  to16b(images["depths"][n]))
    with open(os.path.join(result_dir, "metrics.txt"), "w") as f:
        mean_metrics.print(f)
    mean_metrics.print()


def render_path(params_c: NeRF, params_f: Optional[NeRF], render_poses, hwf,
                K, mcfg: ModelConfig, rcfg: RenderConfig, near: float,
                far: float, chunk: int = 32768,
                savedir: Optional[str] = None, render_factor: int = 0,
                ndc: bool = False, verbose: bool = True,
                pixel_center: bool = False,
                mcfg_fine: Optional[ModelConfig] = None, occ_grid=None,
                mesh: Optional[pmesh.Mesh] = None):
    """Render a camera path; returns (rgbs [N, H, W, 3], disps [N, H, W],
    depths [N, H, W]) and, with ``savedir``, writes frame ``i`` as
    ``{i:03d}.png`` there (reference run_plnerf.py:178-216; rank 0 under
    ``mesh``).  Frame ``i`` renders with ``seed=i``, the counterpart of
    the JAX package's ``PRNGKey(i)``; the other arguments as in
    ``render_image``."""
    rgbs, disps, depths = [], [], []
    t = time.time()
    for i, c2w in enumerate(np.asarray(render_poses)):
        out = render_image(params_c, params_f, c2w, hwf, K, mcfg, rcfg,
                           seed=i, near=near, far=far, chunk=chunk, ndc=ndc,
                           render_factor=render_factor,
                           pixel_center=pixel_center, mcfg_fine=mcfg_fine,
                           occ_grid=occ_grid, mesh=mesh)
        rgbs.append(out["rgb_map"])
        disps.append(out["disp_map"])
        depths.append(out["depth_map"])
        if verbose:
            print(f"frame {i}: {time.time() - t:.2f}s")
            t = time.time()
        if savedir is not None and pmesh.is_main(mesh):
            os.makedirs(savedir, exist_ok=True)
            write_png(os.path.join(savedir, f"{i:03d}.png"), to8b(rgbs[-1]))
    return np.stack(rgbs, 0), np.stack(disps, 0), np.stack(depths, 0)


def write_video(path: str, frames: np.ndarray, fps: int = 30) -> bool:
    """Write ``frames`` [N, H, W, 3] as ``{stem}/{i:03d}.png`` beside
    ``path`` (its name less the extension) and return False.

    A deliberate difference from the JAX package, which encodes an mp4
    through imageio's ffmpeg backend and falls back to exactly these
    frames, returning False, where that backend is missing
    (``plnerf/eval/images.py:459-473``).  The port encodes no video: it
    depends on neither imageio nor ffmpeg.  PNG frames carry no rate, so
    ``fps``, the rate to encode them at, is printed with their folder."""
    stem = os.path.splitext(path)[0]
    os.makedirs(stem, exist_ok=True)
    for i, fr in enumerate(frames):
        write_png(os.path.join(stem, f"{i:03d}.png"), to8b(fr))
    print(f"wrote {len(frames)} frames to {stem} (no video encoder; "
          f"encode at {fps} fps)")
    return False


def write_depth_video_frames(savedir: str, depths: np.ndarray,
                             far: float) -> None:
    """Per frame ``i``: ``depth_{i:03d}.png``, 16-bit ``depth / far``, and
    ``depthcolor_{i:03d}.png``, its 8-bit value through the Turbo colormap
    (reference render_video, run_nerf_sample_based_depth.py:283-300).  The
    JAX package writes cv2's BGR colormap with ``cv2.imwrite``, so its file
    holds Turbo's RGB, as this one does."""
    os.makedirs(savedir, exist_ok=True)
    for i, d in enumerate(depths):
        write_png(os.path.join(savedir, f"depth_{i:03d}.png"),
                  to16b(d / far))
        write_png(os.path.join(savedir, f"depthcolor_{i:03d}.png"),
                  TURBO[to8b(d / far)])
