"""The volumetric renderer (port of ``plnerf/core/render.py``): coarse
pass -> hierarchical importance resampling -> fine pass, forward only.

RNG: one ``torch.Generator`` feeds, in order, the coarse jitter, the
coarse density noise, the resample draws and the fine density noise.  The
``overrides`` dict (``t_rand``, ``noise``, ``u``) injects exact arrays
for any stream, so numpy-made draws drive this renderer and the JAX
package alike.

Not ported yet (raise ``NotImplementedError``): occupancy-grid guided
sampling (``rcfg.occ``) and the depth-supervision quantiles
(``rcfg.compute_pred_hyp``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..device import as_tensor
from . import mlp, quadrature, sampling
from .config import ModelConfig, RenderConfig


def _maybe(overrides: Optional[Dict[str, Any]], name: str, device):
    if overrides is None or overrides.get(name) is None:
        return None
    return as_tensor(overrides[name], device)


def render_rays(
    params_coarse: mlp.NeRF,
    params_fine: Optional[mlp.NeRF],
    ray_batch: torch.Tensor,
    generator: Optional[torch.Generator],
    mcfg: ModelConfig,
    rcfg: RenderConfig,
    cam_embedding: Optional[torch.Tensor] = None,
    overrides: Optional[Dict[str, Any]] = None,
    mcfg_fine: Optional[ModelConfig] = None,
) -> Dict[str, torch.Tensor]:
    """Render a batch of rays.

    ray_batch: [R, 8] (``[o, d, near, far]``) or [R, 11] (+viewdirs).
    Returns rgb_map/disp_map/acc_map/depth_map, the coarse ``*0``
    variants, z_std and sigma0_pos_frac (and raw with ``retraw``).
    """
    if rcfg.occ is not None:
        raise NotImplementedError("occupancy-grid sampling is not ported")
    if rcfg.compute_pred_hyp:
        raise NotImplementedError("compute_pred_hyp is not ported")
    dev = ray_batch.device
    R = ray_batch.shape[0]
    rays_o, rays_d = ray_batch[:, 0:3], ray_batch[:, 3:6]
    near, far = ray_batch[:, 6:7], ray_batch[:, 7:8]
    viewdirs = (ray_batch[:, 8:11]
                if (rcfg.use_viewdirs and ray_batch.shape[-1] > 8) else None)
    m = rcfg.effective_mode
    dtype = torch.bfloat16 if rcfg.mlp_dtype == "bfloat16" else torch.float32

    t_rand = _maybe(overrides, "t_rand", dev)
    if t_rand is None and rcfg.perturb:
        t_rand = torch.rand((R, rcfg.n_samples), generator=generator,
                            device=dev)
    z_vals = sampling.stratified_z_vals(near, far, rcfg.n_samples,
                                        rcfg.lindisp, t_rand)

    def run(model, z, cfg):
        pts = rays_o[:, None, :] + rays_d[:, None, :] * z[..., None]
        raw = mlp.query_network(model, pts, viewdirs, cfg, cam_embedding,
                                dtype=dtype, use_fused=rcfg.use_fused_mlp,
                                fused_fold_heads=rcfg.fused_fold_heads)
        noise = 0.0
        if rcfg.raw_noise_std > 0.0:
            noise = _maybe(overrides, "noise", dev)
            if noise is None:
                noise = torch.randn(raw[..., 3].shape, generator=generator,
                                    device=dev) * rcfg.raw_noise_std
        out = quadrature.raw2outputs(raw, z, near, far, rays_d, m,
                                     rcfg.color_mode, noise, rcfg.white_bkgd,
                                     rcfg.farcolorfix)
        out["raw"] = raw
        return out

    out_c = run(params_coarse, z_vals, mcfg)
    ret: Dict[str, torch.Tensor] = {
        # dead-coarse detector: fraction of raw coarse densities > 0
        "sigma0_pos_frac": (out_c["raw"][..., 3] > 0).float().mean()}

    if rcfg.n_importance <= 0:
        for k_ in ("rgb_map", "disp_map", "acc_map", "depth_map"):
            ret[k_] = out_c[k_]
        if rcfg.retraw:
            ret["raw"] = out_c["raw"]
        return ret

    u = _maybe(overrides, "u", dev)
    if u is None:
        u = sampling.draw_u(generator, R, rcfg.n_importance,
                            det=not rcfg.perturb, device=dev)
    if m == "linear":
        z_samples, _, _, _ = sampling.sample_pdf_reformulation(
            z_vals, out_c["weights"], out_c["tau"], out_c["T"], near, far, u,
            rcfg.zero_tol, rcfg.epsilon)
    else:
        z_mid = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
        z_samples = sampling.sample_pdf(z_mid, out_c["weights"][..., 1:-1], u)
    z_samples = z_samples.detach()                # run_plnerf.py:728
    z_samples = torch.minimum(torch.maximum(z_samples, near), far)
    z_fine = torch.sort(torch.cat([z_vals, z_samples], dim=-1), dim=-1).values

    model_f = params_fine if params_fine is not None else params_coarse
    cfg_f = mcfg if (mcfg_fine is None or params_fine is None) else mcfg_fine
    out_f = run(model_f, z_fine, cfg_f)

    for k_ in ("rgb_map", "disp_map", "acc_map", "depth_map"):
        ret[k_] = out_f[k_]
    ret["rgb0"] = out_c["rgb_map"]
    ret["disp0"] = out_c["disp_map"]
    ret["acc0"] = out_c["acc_map"]
    ret["depth0"] = out_c["depth_map"]
    ret["z_std"] = torch.std(z_samples, dim=-1, correction=0)  # jnp.std
    if rcfg.retraw:
        ret["raw"] = out_f["raw"]
    return ret


def make_ray_batch(rays_o, rays_d, near, far, use_viewdirs: bool,
                   ndc: bool = False, H: int = 0, W: int = 0,
                   focal: float = 0.0):
    """Flatten + pack rays like the reference ``render`` frontend:
    viewdirs from pre-NDC directions, normalised; optional NDC warp."""
    from . import rays as raysmod

    sh = rays_d.shape
    viewdirs = None
    if use_viewdirs:
        viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
        viewdirs = viewdirs.reshape(-1, 3)
    if ndc:
        rays_o, rays_d = raysmod.ndc_rays(H, W, focal, 1.0, rays_o, rays_d)
    rays_o = rays_o.reshape(-1, 3)
    rays_d = rays_d.reshape(-1, 3)
    return raysmod.pack_rays(rays_o, rays_d, near, far, viewdirs), sh[:-1]
