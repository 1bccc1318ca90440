"""The inputs both sides are handed, made on the device from the seed:
the analytic sphere scene at Blender's geometry, the occupancy grid of
that sphere, the MLP weights, and the seeds of every draw.

The sphere (radius 1 at the origin, density 20, colour (0.8, 0.3, 0.2),
white background) is the program's ``data/synthetic`` test scene, here in
closed form: a ray's optical depth through a homogeneous sphere is the
density times its chord inside the sphere between near and far.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

SPHERE_COLOR = (0.8, 0.3, 0.2)


def sub_seed(seed: int, *tags: int) -> int:
    """A 63-bit seed for one stream of the run, from the run's ``--seed``
    (any non-negative integer, also above 2**32) and small tags."""
    ss = np.random.SeedSequence([int(seed) & (2 ** 128 - 1), *tags])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(int(seed))
    return g


def pose_spherical(theta_deg: float, phi_deg: float,
                   radius: float) -> np.ndarray:
    """Camera-to-world [4, 4] on a sphere, looking at the origin (the
    Blender loaders' convention)."""
    t, p = math.radians(theta_deg), math.radians(phi_deg)
    trans = np.eye(4)
    trans[2, 3] = radius
    rx = np.eye(4)
    rx[1, 1], rx[1, 2], rx[2, 1], rx[2, 2] = (math.cos(p), -math.sin(p),
                                              math.sin(p), math.cos(p))
    ry = np.eye(4)
    ry[0, 0], ry[0, 2], ry[2, 0], ry[2, 2] = (math.cos(t), -math.sin(t),
                                              math.sin(t), math.cos(t))
    flip = np.array([[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0],
                     [0, 0, 0, 1]], np.float64)
    return (flip @ ry @ rx @ trans).astype(np.float32)


def focal_of(scene: dict, size: int) -> float:
    return 0.5 * size / math.tan(0.5 * float(scene["camera_angle_x"]))


def intrinsics(size: int, focal: float) -> np.ndarray:
    return np.array([[focal, 0, 0.5 * size], [0, focal, 0.5 * size],
                     [0, 0, 1]], np.float32)


def pixel_rays(c2w: torch.Tensor, K: torch.Tensor, y: torch.Tensor,
               x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Origins and directions [n, 3] of pixels (row ``y``, column ``x``),
    through pixel corners with OpenGL axes, as the Blender loaders'
    rays."""
    xf, yf = x.float(), y.float()
    dirs = torch.stack([(xf - K[0, 2]) / K[0, 0], -(yf - K[1, 2]) / K[1, 1],
                        -torch.ones_like(xf)], dim=-1)
    rays_d = (dirs[:, None, :] * c2w[None, :3, :3]).sum(-1)
    return c2w[:3, 3].expand(rays_d.shape), rays_d


def sphere_rgb(rays_o: torch.Tensor, rays_d: torch.Tensor, near: float,
               far: float, density: float = 20.0, radius: float = 1.0
               ) -> torch.Tensor:
    """Closed-form render of the homogeneous sphere over a white
    background: alpha = 1 - exp(-density * chord), chord clipped to
    [near, far] along the ray."""
    dd = (rays_d * rays_d).sum(-1)
    od = (rays_o * rays_d).sum(-1)
    oo = (rays_o * rays_o).sum(-1)
    disc = od * od - dd * (oo - radius * radius)
    root = torch.sqrt(torch.clamp_min(disc, 0.0))
    t0 = torch.clamp((-od - root) / dd, near, far)
    t1 = torch.clamp((-od + root) / dd, near, far)
    chord = torch.where(disc > 0, (t1 - t0) * torch.sqrt(dd), 0.0)
    alpha = 1.0 - torch.exp(-density * chord)
    color = torch.tensor(SPHERE_COLOR, device=rays_o.device)
    return alpha[..., None] * color + (1.0 - alpha[..., None])


def train_scene(scene: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """``n_views`` training views of ``size`` x ``size`` on the upper
    hemisphere at ``distance``, seeded: images [N, H, W, 3], poses [N, 4,
    4], K [3, 3], on ``device``."""
    rng = np.random.default_rng(sub_seed(seed, 1))
    n, size = int(scene["n_views"]), int(scene["size"])
    thetas = rng.uniform(-180.0, 180.0, n)
    phis = rng.uniform(-90.0, -5.0, n)
    poses = np.stack([pose_spherical(t, p, float(scene["distance"]))
                      for t, p in zip(thetas, phis)])
    focal = focal_of(scene, size)
    K = torch.tensor(intrinsics(size, focal), device=device)
    poses_t = torch.tensor(poses, device=device)
    j, i = torch.meshgrid(torch.arange(size, device=device),
                          torch.arange(size, device=device), indexing="ij")
    y, x = j.reshape(-1), i.reshape(-1)
    images = torch.empty((n, size, size, 3), device=device)
    for v in range(n):
        o, d = pixel_rays(poses_t[v], K, y, x)
        images[v] = sphere_rgb(o, d, float(scene["near"]),
                               float(scene["far"])).reshape(size, size, 3)
    return {"images": images, "poses": poses_t, "K": K}


def sphere_grid(flags: dict, device) -> Dict[str, torch.Tensor]:
    """The occupancy grid of the sphere over [-occ_bound, occ_bound]^3 at
    ``occ_res``^3 cells: density 20 in the cells whose centre lies in the
    unit sphere, 0 elsewhere; ``occ`` the cells above ``occ_threshold``,
    dilated by one cell (a 3^3 max)."""
    g, b = int(flags["occ_res"]), float(flags["occ_bound"])
    c = (torch.arange(g, device=device, dtype=torch.float32) + 0.5) \
        * (2 * b / g) - b
    r2 = c[:, None, None] ** 2 + c[None, :, None] ** 2 + c[None, None] ** 2
    density = torch.where(r2 < 1.0, 20.0, 0.0)
    occ = (density > float(flags["occ_threshold"])).float()
    occ = F.max_pool3d(occ[None, None], 3, stride=1, padding=1)[0, 0]
    return {"density": density, "occ": occ,
            "aabb_min": torch.full((3,), -b, device=device),
            "aabb_max": torch.full((3,), b, device=device)}


def leaf_shapes(flags: dict, fine: bool) -> List[Tuple[str, Tuple[int, ...]]]:
    """(name, shape) of one network's leaves, ``nn.Linear`` layout
    ([out, in] weights), in the reference NeRF's names."""
    W = int(flags["netwidth_fine" if fine else "netwidth"])
    D = int(flags["netdepth_fine" if fine else "netdepth"])
    in_ch = 3 + 6 * int(flags["multires"])
    vch = 3 + 6 * int(flags["multires_views"])
    skips = tuple(flags.get("skips", (4,)))
    out, fan_in = [], in_ch
    for i in range(D):
        out += [(f"pts_linears.{i}.weight", (W, fan_in)),
                (f"pts_linears.{i}.bias", (W,))]
        fan_in = W + in_ch if i in skips else W
    out += [("feature_linear.weight", (W, W)), ("feature_linear.bias", (W,)),
            ("alpha_linear.weight", (1, W)), ("alpha_linear.bias", (1,)),
            ("views_linears.0.weight", (W // 2, vch + W)),
            ("views_linears.0.bias", (W // 2,)),
            ("rgb_linear.weight", (3, W // 2)), ("rgb_linear.bias", (3,))]
    return out


def make_weights(flags: dict, seed: int, device
                 ) -> Dict[str, Dict[str, torch.Tensor]]:
    """{"coarse", "fine"}: each network's leaves drawn U(-1/sqrt(fan_in),
    1/sqrt(fan_in)) (torch's ``nn.Linear`` default, the program's init),
    in one uniform draw per network on ``device``, in float32."""
    out = {}
    for k, fine in (("coarse", False), ("fine", True)):
        shapes = leaf_shapes(flags, fine)
        n = sum(math.prod(s) for _, s in shapes)
        flat = torch.rand(n, generator=generator(sub_seed(seed, 2, fine),
                                                 device), device=device)
        flat = flat * 2.0 - 1.0
        leaves, at = {}, 0
        fan = {}
        for name, s in shapes:
            layer = name.rsplit(".", 1)[0]
            if name.endswith(".weight"):
                fan[layer] = s[1]
            m = math.prod(s)
            leaves[name] = (flat[at:at + m].reshape(s)
                            / math.sqrt(fan[layer])).contiguous()
            at += m
        out[k] = leaves
    return out
