"""The volumetric renderer (port of ``plnerf/core/render.py``): coarse
pass -> hierarchical importance resampling -> fine pass, differentiable
end to end except the importance samples, which are detached as in the
reference.

With ``rcfg.compute_pred_hyp`` it also returns the depth-supervision
quantiles ``pred_hyp``: the analytic inverse CDF of the last pass's
weights at draws ``u``, not detached, so gradients flow through
``sampling.sample_pdf_reformulation`` into tau and T (the depth script's
render_rays, :920-934).

With ``rcfg.occ`` and a grid (``occ_grid``, ``core/occgrid.py``) the
coarse samples are placed by the grid instead of uniformly, from the same
jitter; with ``rcfg.occ`` set it also returns the density observations
the occupancy train step folds into the grid.

RNG: one ``torch.Generator`` feeds, in order, the coarse jitter, the
coarse density noise, the resample draws, the fine density noise and the
``pred_hyp`` draws.  The ``overrides`` dict (``t_rand``, ``noise``, ``u``,
``u_hyp``) injects exact arrays for any stream, so numpy-made draws drive
this renderer and the JAX package alike; ``noise0``, where given, is the
coarse pass's noise (``noise`` then is the fine pass's), as the serving
artifact passes both.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..device import as_tensor
from . import mlp, occgrid, quadrature, sampling
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
    occ_grid: Optional[occgrid.Grid] = None,
) -> Dict[str, torch.Tensor]:
    """Render a batch of rays.

    ray_batch: [R, 8] (``[o, d, near, far]``) or [R, 11] (+viewdirs).
    Returns rgb_map/disp_map/acc_map/depth_map, the coarse ``*0``
    variants, z_std and sigma0_pos_frac (and raw with ``retraw``; with
    ``compute_pred_hyp``: pred_hyp, u, weights, z_vals and, after a fine
    pass, weights0 and z_vals0).

    With ``rcfg.occ`` set: ``occ_z`` (the coarse z values, then the fine
    pass's) and ``occ_sigma`` (their relu'd densities, detached), and,
    when ``occ_grid`` guided the coarse samples, ``occ_ray_frac``.
    Without a grid the coarse samples stay uniform.
    """
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
    guided = rcfg.occ is not None and occ_grid is not None
    if guided:
        z_vals, occ_ray_frac = occgrid.occ_guided_z_vals(
            occ_grid, rays_o, rays_d, near, far, rcfg.n_samples, t_rand,
            rcfg.occ)
    else:
        z_vals = sampling.stratified_z_vals(near, far, rcfg.n_samples,
                                            rcfg.lindisp, t_rand)

    def observe(z, *outs):
        """The density observations for the grid update."""
        if rcfg.occ is None:
            return
        if guided:
            ret["occ_ray_frac"] = occ_ray_frac
        ret["occ_z"] = z
        ret["occ_sigma"] = torch.relu(torch.cat(
            [o["raw"][..., 3] for o in outs], dim=-1)).detach()

    def run(model, z, cfg, noise_key="noise"):
        pts = rays_o[:, None, :] + rays_d[:, None, :] * z[..., None]

        def query(p):
            return mlp.query_network(model, p, viewdirs, cfg, cam_embedding,
                                     dtype=dtype, use_fused=rcfg.use_fused_mlp,
                                     fused_fold_heads=rcfg.fused_fold_heads)

        if rcfg.remat_mlp and torch.is_grad_enabled():
            raw = checkpoint(query, pts, use_reentrant=False)
        else:
            raw = query(pts)
        noise = 0.0
        if rcfg.raw_noise_std > 0.0:
            noise = _maybe(overrides, noise_key, dev)
            if noise is None and noise_key != "noise":
                noise = _maybe(overrides, "noise", dev)
            if noise is None:
                noise = torch.randn(raw[..., 3].shape, generator=generator,
                                    device=dev) * rcfg.raw_noise_std
        out = quadrature.raw2outputs(raw, z, near, far, rays_d, m,
                                     rcfg.color_mode, noise, rcfg.white_bkgd,
                                     rcfg.farcolorfix)
        out["raw"] = raw
        return out

    def resample(out, z, u):
        """Importance-sample new z values (one per column of u) from a
        pass's weights."""
        if m == "linear":
            return sampling.sample_pdf_reformulation(
                z, out["weights"], out["tau"], out["T"], near, far, u,
                rcfg.zero_tol, rcfg.epsilon)[0]
        z_mid = 0.5 * (z[..., 1:] + z[..., :-1])
        return sampling.sample_pdf(z_mid, out["weights"][..., 1:-1], u)

    def pred_hyp(out, z, n):
        """The depth-supervision quantiles of a pass, not detached."""
        uh = _maybe(overrides, "u_hyp", dev)
        if uh is None:
            uh = sampling.draw_u(generator, R, n, not rcfg.perturb,
                                 rcfg.is_joint, device=dev)
        w = out["weights"]
        return {"pred_hyp": resample(out, z, uh), "u": uh,
                "weights": (w[..., 1:] if m == "linear"
                            and rcfg.trim_first_weight else w),
                "z_vals": z}

    out_c = run(params_coarse, z_vals, mcfg, "noise0")
    ret: Dict[str, torch.Tensor] = {
        # dead-coarse detector: fraction of raw coarse densities > 0
        "sigma0_pos_frac": (out_c["raw"][..., 3] > 0).float().mean()}

    if rcfg.n_importance <= 0:
        for k_ in ("rgb_map", "disp_map", "acc_map", "depth_map"):
            ret[k_] = out_c[k_]
        if rcfg.retraw:
            ret["raw"] = out_c["raw"]
        observe(z_vals, out_c)
        if rcfg.compute_pred_hyp:
            ret.update(pred_hyp(out_c, z_vals, rcfg.n_samples))
        return ret

    u = _maybe(overrides, "u", dev)
    if u is None:
        u = sampling.draw_u(generator, R, rcfg.n_importance,
                            det=not rcfg.perturb, device=dev)
    z_samples = resample(out_c, z_vals, u).detach()   # run_plnerf.py:728
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
    observe(torch.cat([z_vals, z_fine], dim=-1), out_c, out_f)
    if rcfg.compute_pred_hyp:
        ret.update(pred_hyp(out_f, z_fine, rcfg.n_importance))
        ret["weights0"] = out_c["weights"]
        ret["z_vals0"] = z_vals
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
