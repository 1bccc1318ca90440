"""Full-image rendering (port of ``render_image`` and
``test_render_config`` from ``plnerf/eval/images.py``), single device.

A Python loop over fixed-size ray chunks replaces the JAX package's
``lax.map``; chunk ``i`` draws from a generator seeded ``seed + i``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from ..core import rays as raysmod
from ..core import render
from ..core.config import ModelConfig, RenderConfig
from ..core.mlp import NeRF
from ..device import make_generator, module_device

# keys returned to the host per pixel
_IMAGE_KEYS = ("rgb_map", "disp_map", "acc_map", "depth_map", "rgb0", "depth0")


def render_chunks(params_c: NeRF, params_f: Optional[NeRF],
                  rays: torch.Tensor, mcfg: ModelConfig, rcfg: RenderConfig,
                  chunk: int, seed: int, keys, cam_embedding=None,
                  mcfg_fine: Optional[ModelConfig] = None
                  ) -> Dict[str, torch.Tensor]:
    """Render ``rays`` [n, 8|11] chunk by chunk; returns the ``keys``
    maps concatenated over chunks, on the rays' device."""
    outs = []
    with torch.no_grad():
        for i, start in enumerate(range(0, rays.shape[0], chunk)):
            g = make_generator(seed + i, rays.device)
            ret = render.render_rays(params_c, params_f,
                                     rays[start:start + chunk], g, mcfg,
                                     rcfg, cam_embedding=cam_embedding,
                                     mcfg_fine=mcfg_fine)
            outs.append({k: ret[k] for k in keys if k in ret})
    return {k: torch.cat([o[k] for o in outs], 0) for k in outs[0]}


def render_image(params_c: NeRF, params_f: Optional[NeRF], c2w, hwf, K,
                 mcfg: ModelConfig, rcfg: RenderConfig, seed: int = 0,
                 near: float = 2.0, far: float = 6.0, chunk: int = 32768,
                 ndc: bool = False, render_factor: int = 0,
                 pixel_center: bool = False, cam_embedding=None,
                 mcfg_fine: Optional[ModelConfig] = None
                 ) -> Dict[str, np.ndarray]:
    """Render one full image on the models' device; returns numpy maps
    shaped [H, W, ...].  ``render_factor`` downsamples H/W/focal;
    ``pixel_center`` uses the depth-script ray convention."""
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
                        _IMAGE_KEYS, cam_embedding, mcfg_fine)
    return {k: v.cpu().numpy().reshape(H, W, *v.shape[1:])
            for k, v in out.items()}


def test_render_config(rcfg: RenderConfig, **overrides) -> RenderConfig:
    """The reference's render_kwargs_test: raw_noise_std=0 but perturb
    deliberately kept True (run_plnerf.py:497-499); ``perturb=False``
    passed here is the ``--eval_det`` variant."""
    kw = dict(raw_noise_std=0.0, perturb=True, retraw=False)
    kw.update(overrides)
    return dataclasses.replace(rcfg, **kw)
