"""Serving runtime (port of ``plnerf/serving/runtime.py``).

``ServingRenderer`` holds a trained coarse/fine pair on one device.  It
pads an arbitrary ray count with the last ray up to a multiple of the
chunk size, renders chunk ``i`` with a generator seeded ``seed + i``,
filters the outputs by ``keys`` and cuts them back to the request's
length.  The JAX package's serialized ``jax.export`` artifact has no
counterpart yet: the renderer is built from the models and configs.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..core import rays as raysmod
from ..core import render
from ..core.config import ModelConfig, RenderConfig
from ..core.mlp import NeRF
from ..device import DeviceLike, resolve_device
from ..eval.images import render_chunks

# per-ray outputs a client can consume (*0 = coarse maps, with a fine net)
_OUTPUT_KEYS = ("rgb_map", "disp_map", "acc_map", "depth_map",
                "rgb0", "depth0")


class ServingRenderer:
    def __init__(self, params_c: NeRF, params_f: Optional[NeRF],
                 mcfg: ModelConfig, rcfg: RenderConfig, chunk: int,
                 device: torch.device,
                 mcfg_fine: Optional[ModelConfig] = None):
        self.params_c = params_c.to(device).eval()
        self.params_f = (params_f.to(device).eval()
                         if params_f is not None else None)
        self.mcfg, self.rcfg, self.mcfg_fine = mcfg, rcfg, mcfg_fine
        self.chunk = int(chunk)
        self.device = device
        self.ray_dim = 11 if rcfg.use_viewdirs else 8
        self.output_keys = tuple(
            k for k in _OUTPUT_KEYS
            if params_f is not None or not k.endswith("0"))

    @classmethod
    def from_params(cls, params_c: NeRF, params_f: Optional[NeRF],
                    mcfg: ModelConfig, rcfg: RenderConfig, chunk: int = 32768,
                    device: DeviceLike = None,
                    mcfg_fine: Optional[ModelConfig] = None
                    ) -> "ServingRenderer":
        """Serve ``params_c``/``params_f`` (moved to ``device``; default
        the CUDA device, which must exist) under ``rcfg`` as given — pass
        ``eval.images.test_render_config(rcfg, ...)`` for the eval task's
        semantics."""
        return cls(params_c, params_f, mcfg, rcfg, chunk,
                   resolve_device(device), mcfg_fine)

    def render_rays(self, rays, seed: int = 0,
                    keys: Optional[Sequence[str]] = None
                    ) -> Dict[str, np.ndarray]:
        """rays: [n, ray_dim] packed like ``core.render.make_ray_batch``;
        any n >= 1.  Returns numpy maps of length n."""
        rays = torch.as_tensor(rays, dtype=torch.float32, device=self.device)
        if rays.dim() != 2 or rays.shape[1] != self.ray_dim or \
                rays.shape[0] < 1:
            raise ValueError(
                f"expected rays [n >= 1, {self.ray_dim}], got "
                f"{tuple(rays.shape)}")
        n = rays.shape[0]
        pad = (-n) % self.chunk
        if pad:
            rays = torch.cat([rays, rays[-1:].expand(pad, self.ray_dim)], 0)
        want = self.output_keys if keys is None else \
            [k for k in self.output_keys if k in set(keys)]
        out = render_chunks(self.params_c, self.params_f, rays, self.mcfg,
                            self.rcfg, self.chunk, seed, want,
                            mcfg_fine=self.mcfg_fine)
        return {k: v[:n].cpu().numpy() for k, v in out.items()}

    def render_image(self, c2w, hwf, K, near: float = 2.0, far: float = 6.0,
                     ndc: bool = False, seed: int = 0,
                     keys: Optional[Sequence[str]] = None
                     ) -> Dict[str, np.ndarray]:
        """Render one full image from camera geometry (same packing as
        ``eval.images.render_image``)."""
        H, W, focal = int(hwf[0]), int(hwf[1]), float(hwf[2])
        c2w = torch.as_tensor(np.asarray(c2w, np.float32)[:3, :4],
                              device=self.device)
        rays_o, rays_d = raysmod.get_rays(H, W, np.asarray(K), c2w)
        packed, _ = render.make_ray_batch(rays_o, rays_d, near, far,
                                          self.rcfg.use_viewdirs, ndc, H, W,
                                          focal)
        out = self.render_rays(packed, seed=seed, keys=keys)
        return {k: v.reshape(H, W, *v.shape[1:]) for k, v in out.items()}
