"""Test-time camera-embedding optimization (port of
``plnerf/train/camera_opt.py``; reference depth_supervised_exps/
run_nerf_sample_based_depth.py:311-347): with the NeRF frozen, fit one
image's camera embedding by its photometric loss over the whole image, in
a fixed random partition of the pixels into batches of ``2 * n_rand``
rays; one Adam update per epoch on the sum of the batch losses, a
ReduceLROnPlateau (mode max, factor 0.5, patience 3) on the epoch's PSNR,
and the embedding of the best epoch kept.

The JAX package differentiates the epoch's sum in one ``lax.map``; here
each batch's loss is backpropagated on its own and the gradients summed
(peak memory of one batch), then one update is made.  The partition is
the same numpy permutation, and the renders are deterministic (no
jitter, no density noise), so the two follow one trajectory.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ..core import rays as raysmod
from ..core import render
from ..core.config import ModelConfig, RenderConfig
from ..core.mlp import NeRF
from ..device import module_device
from ..utils.misc import img2mse, mse2psnr


def optimize_camera_embedding(
    params_c: NeRF, params_f: Optional[NeRF], image: np.ndarray, pose,
    intrinsic, mcfg: ModelConfig, rcfg: RenderConfig, near: float,
    far: float, n_rand: int = 1024, epochs: int = 100, lr: float = 0.5,
    seed: int = 0, verbose: bool = False,
    history: Optional[List[float]] = None) -> torch.Tensor:
    """Returns the best embedding [input_ch_cam], on the models' device.

    image: [H, W, 3]; pose: [3|4, 4]; intrinsic: (fx, fy, cx, cy) or a
    K matrix.  ``history``, when given, gets each epoch's PSNR (of the
    embedding before that epoch's update).  As in the JAX package, the
    embedding kept is the one made by the update of the best epoch."""
    dev = module_device(params_c)
    H, W = image.shape[:2]
    intrinsic = np.asarray(intrinsic, np.float32)
    if intrinsic.ndim == 2:
        intrinsic = np.array([intrinsic[0, 0], intrinsic[1, 1],
                              intrinsic[0, 2], intrinsic[1, 2]], np.float32)
    c2w = torch.as_tensor(np.asarray(pose, np.float32)[:3, :4], device=dev)
    rays_o, rays_d = raysmod.get_rays_pixelcenter(H, W, intrinsic, c2w)
    viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    packed = raysmod.pack_rays(rays_o.reshape(-1, 3), rays_d.reshape(-1, 3),
                               near, far, viewdirs.reshape(-1, 3))
    target = torch.as_tensor(np.asarray(image, np.float32).reshape(-1, 3),
                             device=dev)

    # the fixed partition into 2 * n_rand batches (the reference's
    # create_random_subsets(range(H * W), 2 * N_rand))
    n = packed.shape[0]
    bs = min(2 * n_rand, n)
    n_batches = n // bs
    perm = torch.as_tensor(
        np.random.default_rng(seed).permutation(n)[:n_batches * bs],
        device=dev)
    rays_b = packed[perm].reshape(n_batches, bs, -1)
    target_b = target[perm].reshape(n_batches, bs, 3)

    rcfg = dataclasses.replace(rcfg, perturb=False, raw_noise_std=0.0,
                               compute_pred_hyp=False)
    emb = torch.zeros(mcfg.input_ch_cam, device=dev, requires_grad=True)
    opt = torch.optim.Adam([emb], lr=float(lr), betas=(0.9, 0.999),
                           eps=1e-8)
    best_emb, max_psnr = emb.detach().clone(), -np.inf
    lr_scale, plateau = float(lr), 0
    for i in range(epochs):
        grad = torch.zeros_like(emb)
        loss = torch.zeros((), device=dev)
        for b in range(n_batches):
            ret = render.render_rays(params_c, params_f, rays_b[b], None,
                                     mcfg, rcfg, cam_embedding=emb)
            batch_loss = img2mse(ret["rgb_map"], target_b[b])
            grad += torch.autograd.grad(batch_loss, [emb])[0]
            loss += batch_loss.detach()
        emb.grad = grad
        for group in opt.param_groups:
            group["lr"] = lr_scale
        opt.step()
        psnr = float(mse2psnr(loss / n_batches))
        if history is not None:
            history.append(psnr)
        if psnr > max_psnr:
            max_psnr, best_emb, plateau = psnr, emb.detach().clone(), 0
            if verbose:
                print(f"  cam-opt step {i}: PSNR {psnr:.2f}")
        else:
            plateau += 1
            if plateau > 3:            # ReduceLROnPlateau(patience=3)
                lr_scale *= 0.5
                plateau = 0
    return best_emb
