"""Serving runtime (port of ``plnerf/serving/runtime.py``).

``ServingRenderer`` pads an arbitrary ray count with the last ray up to a
multiple of the chunk size, renders chunk ``i`` with a generator seeded
``seed + i``, filters the outputs by ``keys`` and cuts them back to the
request's length.  It serves either a trained coarse/fine pair
(``from_params``) or an artifact written by ``serving.export``
(``load``), which needs no model code: the artifact's programs take the
chunk's random draws as inputs, and the runtime draws them from the
chunk's generator in the order ``core.render.render_rays`` draws them, so
an artifact returns what ``from_params`` returns at the same seed.

``load(..., devices=[...])`` serves one process's requests over several
devices: chunk ``i`` runs on ``devices[i % len(devices)]``, every chunk is
enqueued before any result is fetched, and its draws come from its own
generator seeded ``seed + i`` on its device, so the same rays give the
same maps on one device or several.  The program runs as exported on the
export device; any other device gets its own copy of it, moved there by
``torch.export.passes.move_to_device_pass`` (nothing is traced again from
model code), with ``args`` weights staged on every device.  The
whole-batch module serves only a single device, as in the JAX runtime.

Differences from the JAX runtime: an artifact runs on the device type it
was exported for (an artifact exported for another is refused), and the
whole-batch module takes each chunk's own draws, so it returns the chunk
path's maps (the JAX module splits one key over its chunks).
"""
from __future__ import annotations

import json
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch.export.passes import move_to_device_pass

from ..core import rays as raysmod
from ..core import render
from ..core.config import ModelConfig, RenderConfig
from ..core.mlp import NeRF
from ..device import DeviceLike, make_generator, resolve_device
from ..eval.images import render_chunks
from ..kernels import fused_mlp  # noqa: F401  registers the forward op
from ..utils import profile
from .export import (FORMAT_VERSION, MANIFEST_FILE, MODULE_FILE,
                     MODULE_FUSED_FILE, WEIGHTS_FILE, output_keys,
                     ray_dim)


def _home(ep) -> torch.device:
    """The device an exported program was traced on: its first tensor's
    (a parameter, a constant or the rays)."""
    for node in ep.graph.nodes:
        val = node.meta.get("val")
        if isinstance(val, torch.Tensor):
            return val.device
    raise ValueError("the exported program holds no tensor")


def _draw(g: torch.Generator, d: dict, n: int, device) -> torch.Tensor:
    """One random input of ``export.draw_inputs``, as render_rays draws it."""
    if d["dist"] == "uniform":
        return torch.rand((n, d["cols"]), generator=g, device=device)
    return torch.randn((n, d["cols"]), generator=g, device=device) * \
        d["scale"]


class ServingRenderer:
    def __init__(self, chunk: int, rdim: int, device: torch.device,
                 keys: Sequence[str], use_viewdirs: bool):
        self.chunk = int(chunk)
        self.ray_dim = int(rdim)
        self.device = device
        self.output_keys = tuple(keys)
        self.use_viewdirs = use_viewdirs
        self.manifest: Optional[dict] = None
        self.fused_n_rays: Optional[int] = None
        self._fused = None

    @classmethod
    def from_params(cls, params_c: NeRF, params_f: Optional[NeRF],
                    mcfg: ModelConfig, rcfg: RenderConfig, chunk: int = 32768,
                    device: DeviceLike = None,
                    mcfg_fine: Optional[ModelConfig] = None,
                    occ_grid=None) -> "ServingRenderer":
        """Serve ``params_c``/``params_f`` (moved to ``device``; default
        the CUDA device, which must exist) under ``rcfg`` as given — pass
        ``eval.images.test_render_config(rcfg, ...)`` for the eval task's
        semantics; ``occ_grid``: the trained grid when ``rcfg.occ`` is
        set."""
        dev = resolve_device(device)
        srv = cls(chunk, ray_dim(rcfg), dev,
                  output_keys(params_f is not None, rcfg), rcfg.use_viewdirs)
        srv.params_c = params_c.to(dev).eval()
        srv.params_f = (params_f.to(dev).eval()
                        if params_f is not None else None)
        srv.mcfg, srv.rcfg, srv.mcfg_fine = mcfg, rcfg, mcfg_fine
        srv.occ_grid = occ_grid

        def chunks(rays, seed, want):
            return render_chunks(srv.params_c, srv.params_f, rays, mcfg,
                                 rcfg, srv.chunk, seed, want,
                                 mcfg_fine=mcfg_fine, occ_grid=occ_grid,
                                 join=lambda: profile.span(
                                     "request.assemble", dev))
        srv._chunks = chunks
        return srv

    @classmethod
    def load(cls, artifact_dir: str, device: DeviceLike = None,
             devices: Optional[Sequence[DeviceLike]] = None
             ) -> "ServingRenderer":
        """Serve the artifact in ``artifact_dir`` on ``device`` (default the
        CUDA device, which must exist), of the type it was exported for.
        ``devices``: serve over these devices instead, chunk ``i`` on
        ``devices[i % len(devices)]`` (the module docstring); the maps
        come back on the first."""
        devs = [resolve_device(d) for d in (devices or [device])]
        dev = devs[0]
        with open(os.path.join(artifact_dir, MANIFEST_FILE)) as f:
            manifest = json.load(f)
        if manifest.get("format_version") != FORMAT_VERSION:
            raise ValueError("unsupported artifact format: "
                             f"{manifest.get('format_version')}")
        for d in devs:
            if manifest.get("device") != d.type:
                raise ValueError(
                    f"{artifact_dir} was exported for "
                    f"{manifest.get('device')} and cannot run on {d}: "
                    "export it again there")
        srv = cls(manifest["chunk"], manifest["ray_dim"], dev,
                  manifest["output_keys"], manifest["use_viewdirs"])
        srv.manifest = manifest
        weights = {}
        if manifest.get("weights_mode") == "args":
            for d in dict.fromkeys(devs):
                # staged on each device once; every call reads them there
                weights[d] = tuple(torch.load(
                    os.path.join(artifact_dir, WEIGHTS_FILE), map_location=d,
                    weights_only=True))
                if len(weights[d]) != int(manifest["n_weight_leaves"]):
                    raise ValueError(f"{WEIGHTS_FILE} holds "
                                     f"{len(weights[d])} tensors, the "
                                     "manifest "
                                     f"{manifest['n_weight_leaves']}")

        def program(name, d):
            ep = torch.export.load(os.path.join(artifact_dir, name))
            if d != _home(ep):
                ep = move_to_device_pass(ep, d)
            mod = ep.module()
            if d not in weights:
                return mod
            return lambda rays, **draws: mod(weights[d], rays, **draws)

        calls = {d: program(MODULE_FILE, d) for d in dict.fromkeys(devs)}
        draws = manifest["draw_inputs"]

        def inputs(seeds, n, d):
            """Each chunk's draws from its generator on ``d``, stacked by
            name."""
            per = []
            for s in seeds:
                g = make_generator(s, d)
                per.append({x["name"]: _draw(g, x, n, d) for x in draws})
            return {x["name"]: torch.cat([p[x["name"]] for p in per], 0)
                    for x in draws}

        def chunks(rays, seed, want):
            outs = []
            with torch.no_grad():
                # every chunk enqueued on its device before any is fetched
                for i in range(rays.shape[0] // srv.chunk):
                    d = devs[i % len(devs)]
                    out = calls[d](
                        rays[i * srv.chunk:(i + 1) * srv.chunk].to(d),
                        **inputs([seed + i], srv.chunk, d))
                    outs.append({k: out[k] for k in want})
            with profile.span("request.assemble", dev):
                return {k: torch.cat([o[k].to(dev) for o in outs], 0)
                        for k in want}
        srv._chunks = chunks

        srv.fused_n_rays = manifest.get("fused_n_rays")
        fpath = os.path.join(artifact_dir, MODULE_FUSED_FILE)
        if srv.fused_n_rays and os.path.exists(fpath) and len(devs) == 1:
            fcall = program(MODULE_FUSED_FILE, dev)

            def fused(rays, seed, want):
                n = rays.shape[0] // srv.chunk
                with torch.no_grad():
                    out = fcall(rays, **inputs(
                        range(seed, seed + n), srv.chunk, dev))
                return {k: out[k] for k in want}
            srv._fused = fused
        return srv

    def render_rays(self, rays, seed: int = 0,
                    keys: Optional[Sequence[str]] = None
                    ) -> Dict[str, np.ndarray]:
        """rays: [n, ray_dim] packed like ``core.render.make_ray_batch``;
        any n >= 1.  Returns numpy maps of length n.  A loaded artifact
        with a whole-batch module serves exactly ``fused_n_rays`` padded
        rays in one call of it.  A ``request`` span (``utils/profile``),
        timed on the card until the maps are on the host."""
        with profile.span("request", self.device) as req:
            return self._render(rays, seed, keys, req)

    def _render(self, rays, seed: int, keys: Optional[Sequence[str]],
                req: profile.Span) -> Dict[str, np.ndarray]:
        """``render_rays`` inside the request's span ``req``: its fields
        ``rays`` and ``padded`` (the rays added up to whole chunks), and
        the spans ``request.pad`` and ``request.fetch``."""
        rays = torch.as_tensor(rays, dtype=torch.float32, device=self.device)
        if rays.dim() != 2 or rays.shape[1] != self.ray_dim or \
                rays.shape[0] < 1:
            raise ValueError(
                f"expected rays [n >= 1, {self.ray_dim}], got "
                f"{tuple(rays.shape)}")
        n = rays.shape[0]
        pad = (-n) % self.chunk
        req.fields.update(rays=n, padded=pad)
        if pad:
            with profile.span("request.pad", self.device):
                rays = torch.cat([rays, rays[-1:].expand(pad, self.ray_dim)],
                                 0)
        want = self.output_keys if keys is None else \
            [k for k in self.output_keys if k in set(keys)]
        if self._fused is not None and rays.shape[0] == self.fused_n_rays:
            out = self._fused(rays, seed, want)
        else:
            out = self._chunks(rays, seed, want)
        with profile.span("request.fetch"):
            return {k: v[:n].cpu().numpy() for k, v in out.items()}

    def render_image(self, c2w, hwf, K, near: float = 2.0, far: float = 6.0,
                     ndc: bool = False, seed: int = 0,
                     keys: Optional[Sequence[str]] = None
                     ) -> Dict[str, np.ndarray]:
        """Render one full image from camera geometry (same packing as
        ``eval.images.render_image``); one ``request`` span from its
        camera's rays on, as ``render_rays``."""
        with profile.span("request", self.device) as req:
            H, W, focal = int(hwf[0]), int(hwf[1]), float(hwf[2])
            c2w = torch.as_tensor(np.asarray(c2w, np.float32)[:3, :4],
                                  device=self.device)
            rays_o, rays_d = raysmod.get_rays(H, W, np.asarray(K), c2w)
            packed, _ = render.make_ray_batch(rays_o, rays_d, near, far,
                                              self.use_viewdirs, ndc, H, W,
                                              focal)
            out = self._render(packed, seed, keys, req)
        return {k: v.reshape(H, W, *v.shape[1:]) for k, v in out.items()}
