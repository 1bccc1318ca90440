"""The plain reference of PL-NeRF's train step and renderer, in float32
PyTorch with no kernel, no cache and no batching.

It follows PL-NeRF ("Volume rendering with piecewise-linear opacity",
the ``mikacuy/PL-NeRF`` code) and NeRF's MLP (Mildenhall et al., ECCV 2020, arXiv:2003.08934,
section 5 and Fig. 7): an 8 x 256 relu trunk over positions encoded at
10 bands with the encoded input concatenated after layer 4, a density
head, a 256-wide feature layer concatenated with the directions encoded
at 4 bands, one 128-wide relu layer and an rgb head.  The renderer: the
coarse pass at stratified (or occupancy-grid guided) samples, the
piecewise-linear quadrature, the paper's analytic inverse-CDF resampling
of N_importance points, the fine pass on the union; the loss the two
passes' MSE; two Adams (betas 0.9 / 0.999, eps 1e-8) at the exponential
schedule.  The occupancy grid: candidate bins tested against the grid,
stratified inverse-CDF over ``occ + floor`` (in float64), and the
per-voxel max / EMA / threshold / dilation update.

Imports nothing of the program.  ``Precision`` sets how the MLP's
products are computed: float32 with TF32 off (the reference), TF32, or
operands rounded to float8 e4m3 at a per-tensor scale (the controls: the
next precision below float32 and below bfloat16).
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional

import torch
import torch.nn.functional as F

TAU_NEAR, TAU_FAR = 1e-10, 1e10
FP8_MAX = 448.0


class Precision:
    """How the MLP's products run: "fp32", "tf32" or "fp8"."""

    def __init__(self, mode: str = "fp32"):
        if mode not in ("fp32", "tf32", "fp8"):
            raise ValueError(mode)
        self.mode = mode

    @contextlib.contextmanager
    def scope(self):
        b = torch.backends
        old = (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32)
        b.cuda.matmul.allow_tf32 = b.cudnn.allow_tf32 = self.mode == "tf32"
        try:
            yield
        finally:
            b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32 = old

    def operand(self, x: torch.Tensor) -> torch.Tensor:
        if self.mode != "fp8":
            return x
        # per-tensor scale to the format's range, rounded to e4m3; the
        # gradient passes straight through the rounding
        scale = x.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
        q = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
        return x + (q - x.detach())


def embed(x: torch.Tensor, bands: int) -> torch.Tensor:
    """[x, sin(2^0 x), cos(2^0 x), ..., sin(2^(L-1) x), cos(2^(L-1) x)],
    each sin / cos over the 3 coordinates."""
    f = 2.0 ** torch.arange(bands, dtype=x.dtype, device=x.device)
    xb = x[..., None, :] * f[:, None]
    sc = torch.stack([torch.sin(xb), torch.cos(xb)], dim=-2)
    return torch.cat([x, sc.reshape(*x.shape[:-1], 6 * bands)], dim=-1)


def linear(x, w, b, prec: Precision):
    return prec.operand(x) @ prec.operand(w).t() + b


def mlp(p: Dict[str, torch.Tensor], pe: torch.Tensor, ve: torch.Tensor,
        depth: int, skips, prec: Precision) -> torch.Tensor:
    """raw [..., 4] (rgb logits, density) of points ``pe`` [..., in_ch]
    seen from ``ve`` [..., views_ch]."""
    h = pe
    for i in range(depth):
        h = F.relu(linear(h, p[f"pts_linears.{i}.weight"],
                          p[f"pts_linears.{i}.bias"], prec))
        if i in skips:
            h = torch.cat([pe, h], dim=-1)
    alpha = linear(h, p["alpha_linear.weight"], p["alpha_linear.bias"], prec)
    feat = linear(h, p["feature_linear.weight"], p["feature_linear.bias"],
                  prec)
    h = torch.cat([feat, ve.expand(*feat.shape[:-1], ve.shape[-1])], dim=-1)
    h = F.relu(linear(h, p["views_linears.0.weight"],
                      p["views_linears.0.bias"], prec))
    rgb = linear(h, p["rgb_linear.weight"], p["rgb_linear.bias"], prec)
    return torch.cat([rgb, alpha], dim=-1)


def linspace01(n: int, dtype, device) -> torch.Tensor:
    i = torch.arange(n, dtype=dtype, device=device)
    return torch.where(i == n - 1, 1.0, i * (1.0 / (n - 1)))


def stratified(near, far, n: int, t_rand) -> torch.Tensor:
    t = linspace01(n, near.dtype, near.device)
    z = near * (1.0 - t) + far * t
    mids = 0.5 * (z[..., 1:] + z[..., :-1])
    upper = torch.cat([mids, z[..., -1:]], dim=-1)
    lower = torch.cat([z[..., :1], mids], dim=-1)
    return lower + (upper - lower) * t_rand


def sample_pdf(bins, weights, u) -> torch.Tensor:
    """Inverse-CDF over ``weights`` (+1e-5) between ``bins`` edges."""
    weights = weights + 1e-5
    cdf = torch.cumsum(weights / weights.sum(-1, keepdim=True), dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)
    inds = (cdf[..., None, :] <= u[..., :, None]).sum(-1)
    below = (inds - 1).clamp(0, cdf.shape[-1] - 1)
    above = inds.clamp(0, cdf.shape[-1] - 1)
    cb, ca = cdf.gather(-1, below), cdf.gather(-1, above)
    bb, ba = bins.gather(-1, below), bins.gather(-1, above)
    denom = torch.where(ca - cb < 1e-5, torch.ones_like(ca), ca - cb)
    return bb + (u - cb) / denom * (ba - bb)


def voxel_index(grid, pts, g: int):
    rel = (pts - grid["aabb_min"]) / (grid["aabb_max"] - grid["aabb_min"])
    idx = torch.floor(torch.clamp(rel * g, -1.0, float(g))).to(torch.int64)
    inb = ((idx >= 0) & (idx < g)).all(dim=-1)
    idx = idx.clamp(0, g - 1)
    return (idx[..., 0] * g + idx[..., 1]) * g + idx[..., 2], inb


def occ_guided(grid, o, d, near, far, n: int, t_rand, occ: dict):
    """Coarse z values placed by the grid, and the occupied share of the
    candidate bins."""
    m = int(occ["candidates"])
    t = linspace01(m + 1, near.dtype, near.device)
    edges = near * (1.0 - t) + far * t
    mids = 0.5 * (edges[..., 1:] + edges[..., :-1])
    flat, inb = voxel_index(grid, o[:, None] + d[:, None] * mids[..., None],
                            int(occ["res"]))
    occupied = grid["occ"].reshape(-1)[flat] * inb.float()
    u = (torch.arange(n, dtype=near.dtype, device=near.device) + t_rand) / n
    z = sample_pdf(edges.double(), (occupied + occ["floor"]).double(),
                   u.double())
    return z.float(), occupied.mean()


def update_grid(grid, pts, sigma, occ: dict):
    """The grid after one step's density observations: each visited
    voxel's EMA moved toward its largest observation, then threshold and
    a one-voxel dilation."""
    g = int(occ["res"])
    with torch.no_grad():
        flat, inb = voxel_index(grid, pts.reshape(-1, 3), g)
        s = torch.where(inb, sigma.reshape(-1), -torch.inf)
        dens = grid["density"].reshape(-1)
        obs = torch.full_like(dens, -torch.inf).scatter_reduce(
            0, flat, s, "amax")
        blended = occ["decay"] * dens + (1 - occ["decay"]) * obs.clamp_min(0)
        dens = torch.where(obs > -torch.inf, blended, dens).reshape(g, g, g)
        o = (dens > occ["threshold"]).float()
        o = F.max_pool3d(o[None, None], 3, stride=1, padding=1)[0, 0]
    return {**grid, "density": dens, "occ": o}


def linear_weights(sigma, z, near, far, rays_d):
    """Piecewise-linear opacity: weights [R, S+1], tau and T [R, S+2]."""
    z_aug = torch.cat([near, z, far], dim=-1)
    dists = (z_aug[..., 1:] - z_aug[..., :-1]) * rays_d.norm(dim=-1,
                                                             keepdim=True)
    tau = F.relu(torch.cat([torch.full_like(sigma[..., :1], TAU_NEAR), sigma,
                            torch.full_like(sigma[..., :1], TAU_FAR)], -1))
    expr = torch.exp(-0.5 * (tau[..., 1:] + tau[..., :-1]) * dists)
    T = torch.cumprod(torch.cat([torch.ones_like(expr[..., :1]), expr], -1),
                      dim=-1)
    return (1.0 - expr) * T[..., :-1], tau, T


def composite(raw, z, near, far, rays_d):
    """rgb [R, 3] over a white background (midpoint colours) and the
    quadrature's weights, tau, T."""
    rgb = torch.sigmoid(raw[..., :3])
    w, tau, T = linear_weights(raw[..., 3], z, near, far, rays_d)
    rgb_cat = torch.cat([rgb[:, :1], rgb, rgb[:, -1:]], dim=1)
    mid = 0.5 * (rgb_cat[:, 1:] + rgb_cat[:, :-1])
    acc = w.sum(-1, keepdim=True)
    return (w[..., None] * mid).sum(-2) + (1.0 - acc), w, tau, T


def resample(z, w, tau, T, near, far, u, zero_tol: float, eps: float):
    """The paper's analytic inverse CDF of the piecewise-linear density:
    within the bin a draw falls in, the root of the quadratic optical
    depth (increasing or decreasing tau), its left edge where tau is flat
    (|slope| under ``zero_tol``), clamps at ``eps``."""
    bins = torch.cat([near, z, far], dim=-1)
    c = torch.cumsum(w, dim=-1)
    cdf = torch.cat([torch.zeros_like(c[..., :1]), c[..., :-1],
                     torch.ones_like(c[..., :1])], dim=-1)
    inds = (cdf[..., None, :] <= u[..., :, None]).sum(-1)
    below = (inds - 1).clamp(0, cdf.shape[-1] - 1)
    above = inds.clamp(0, cdf.shape[-1] - 1)
    s0, s1 = bins.gather(-1, below), bins.gather(-1, above)
    T0 = T.gather(-1, below)
    t0, t1 = tau.gather(-1, below), tau.gather(-1, above)
    slope = (tau[..., 1:] - tau[..., :-1]).gather(
        -1, below.clamp(0, tau.shape[-1] - 2))
    width = s1 - s0
    ln = -torch.log(torch.clamp_min((1.0 - u) / torch.clamp_min(T0, eps),
                                    eps))

    def root(increasing: bool):
        if increasing:
            disc = t0 ** 2 + 2.0 * (t1 - t0) * ln / torch.clamp_min(width, eps)
            t = width * (-t0 + torch.sqrt(torch.clamp_min(disc, eps))) \
                / torch.clamp_min(t1 - t0, eps)
        else:
            disc = t0 ** 2 - 2.0 * (t0 - t1) * ln / torch.clamp_min(width, eps)
            t = width * (t0 - torch.sqrt(torch.clamp_min(disc, eps))) \
                / torch.clamp_min(t0 - t1, eps)
        return s0 + torch.minimum(torch.clamp_min(t, eps), width)

    out = torch.where(slope.abs() < zero_tol, s0, torch.full_like(s0, -1.0))
    out = torch.where(slope >= zero_tol, root(True), out)
    out = torch.where(slope <= -zero_tol, root(False), out)
    return torch.where(torch.isnan(out), s0, out)


def render(pc, pf, rays: torch.Tensor, t_rand, u, cfg: dict,
           prec: Precision, grid=None) -> Dict[str, torch.Tensor]:
    """rgb (fine) and rgb0 (coarse) of rays [R, 11] (origin, direction,
    near, far, unit view direction) at the draws ``t_rand`` [R, Ns] and
    ``u`` [R, Ni]; with ``grid``, the coarse samples guided by it and the
    density observations for ``update_grid``."""
    o, d, near, far, vd = (rays[:, 0:3], rays[:, 3:6], rays[:, 6:7],
                           rays[:, 7:8], rays[:, 8:11])
    depth, skips = cfg["netdepth"], tuple(cfg.get("skips", (4,)))
    ve = embed(vd, cfg["multires_views"])[:, None, :]
    out = {}
    if grid is not None:
        z, out["occ_ray_frac"] = occ_guided(grid, o, d, near, far,
                                            cfg["N_samples"], t_rand,
                                            cfg["occ"])
    else:
        z = stratified(near, far, cfg["N_samples"], t_rand)

    def run(p, z_):
        pts = o[:, None] + d[:, None] * z_[..., None]
        with prec.scope():
            return mlp(p, embed(pts, cfg["multires"]), ve, depth, skips, prec)

    raw_c = run(pc, z)
    out["rgb0"], w, tau, T = composite(raw_c, z, near, far, d)
    with torch.no_grad():
        zs = resample(z, w.detach(), tau.detach(), T.detach(), near, far, u,
                      cfg["zero_tol"], cfg["epsilon"])
        zs = torch.minimum(torch.maximum(zs, near), far)
        zf = torch.sort(torch.cat([z, zs], dim=-1), dim=-1).values
    raw_f = run(pf, zf)
    out["rgb"], *_ = composite(raw_f, zf, near, far, d)
    out["occ_z"] = torch.cat([z, zf], dim=-1)
    out["occ_sigma"] = F.relu(torch.cat([raw_c[..., 3], raw_f[..., 3]],
                                        -1)).detach()
    return out


def pack_rays(o, d, near: float, far: float) -> torch.Tensor:
    n = o.shape[0]
    vd = d / d.norm(dim=-1, keepdim=True)
    return torch.cat([o, d, torch.full((n, 1), near, device=o.device),
                      torch.full((n, 1), far, device=o.device), vd], -1)


def lrate(cfg: dict, count: int) -> float:
    """The exponential schedule at ``count`` updates made before this
    one: lrate * 0.1 ** (count / (lrate_decay * 1000))."""
    return cfg["lrate"] * 0.1 ** (count / (cfg["lrate_decay"] * 1000))


class Adam:
    """Adam on a dict of leaves (betas 0.9 / 0.999, eps 1e-8), its
    bias corrections at its own update count."""

    def __init__(self, params: Dict[str, torch.Tensor]):
        self.p = params
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor], lr: float) -> None:
        self.t += 1
        bc1, bc2 = 1 - 0.9 ** self.t, 1 - 0.999 ** self.t
        for k, g in grads.items():
            self.m[k].mul_(0.9).add_(g, alpha=0.1)
            self.v[k].mul_(0.999).addcmul_(g, g, value=0.001)
            denom = (self.v[k] / bc2).sqrt_().add_(1e-8)
            self.p[k].sub_(lr * (self.m[k] / bc1) / denom)


def occ_cfg(flags: dict) -> Optional[dict]:
    if not flags.get("occ_grid"):
        return None
    return {"res": flags["occ_res"], "candidates": flags["occ_candidates"],
            "decay": flags["occ_decay"], "threshold": flags["occ_threshold"],
            "floor": flags["occ_floor"]}


def render_cfg(flags: dict) -> dict:
    out = {k: flags[k] for k in ("netdepth", "multires", "multires_views",
                                 "N_samples", "N_importance", "lrate",
                                 "lrate_decay")}
    out["zero_tol"] = flags.get("zero_tol", 1e-4)
    out["epsilon"] = flags.get("epsilon", 1e-3)
    out["skips"] = tuple(flags.get("skips", (4,)))
    out["occ"] = occ_cfg(flags)
    return out

