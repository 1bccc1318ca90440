"""Camera ray generation and NDC projection (port of
``plnerf/core/rays.py``): pinhole rays with OpenGL-style axes and pixel
corners (``get_rays``), the depth-experiments pixel-centre variant,
LLFF's NDC warp and the per-ray row packing."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..device import as_tensor


def get_rays(H: int, W: int, K, c2w, device=None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-image ray grid. Returns (rays_o, rays_d), each [H, W, 3]."""
    device = c2w.device if device is None and isinstance(
        c2w, torch.Tensor) else (device or "cpu")
    K = as_tensor(K, device)
    c2w = as_tensor(c2w, device)
    j, i = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=device),
                          torch.arange(W, dtype=torch.float32, device=device),
                          indexing="ij")
    dirs = torch.stack([(i - K[0, 2]) / K[0, 0], -(j - K[1, 2]) / K[1, 1],
                        -torch.ones_like(i)], dim=-1)
    rays_d = torch.einsum("hwc,rc->hwr", dirs, c2w[:3, :3])
    rays_o = c2w[:3, -1].expand(rays_d.shape)
    return rays_o, rays_d


def get_rays_pixelcenter(H: int, W: int, intrinsic, c2w,
                         coords: Optional[torch.Tensor] = None, device=None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depth-exps convention: intrinsic = (fx, fy, cx, cy), pixel centres.
    coords: optional [N, 2] integer (row, col); then returns [N, 3] rays."""
    device = c2w.device if device is None and isinstance(
        c2w, torch.Tensor) else (device or "cpu")
    intrinsic = as_tensor(intrinsic, device)
    c2w = as_tensor(c2w, device)
    fx, fy, cx, cy = intrinsic[0], intrinsic[1], intrinsic[2], intrinsic[3]
    if coords is None:
        j, i = torch.meshgrid(
            torch.arange(H, dtype=torch.float32, device=device),
            torch.arange(W, dtype=torch.float32, device=device),
            indexing="ij")
    else:
        coords = torch.as_tensor(coords, device=device)
        i = coords[:, 1].float()
        j = coords[:, 0].float()
    dirs = torch.stack([((i + 0.5) - cx) / fx, (H - (j + 0.5) - cy) / fy,
                        -torch.ones_like(i)], dim=-1)
    rays_d = torch.einsum("...c,rc->...r", dirs, c2w[:3, :3])
    rays_o = c2w[:3, -1].expand(rays_d.shape)
    return rays_o, rays_d


def ndc_rays(H: int, W: int, focal: float, near: float, rays_o, rays_d):
    """Project rays into NDC space (LLFF forward-facing scenes)."""
    t = -(near + rays_o[..., 2]) / rays_d[..., 2]
    rays_o = rays_o + t[..., None] * rays_d

    o0 = -1.0 / (W / (2.0 * focal)) * rays_o[..., 0] / rays_o[..., 2]
    o1 = -1.0 / (H / (2.0 * focal)) * rays_o[..., 1] / rays_o[..., 2]
    o2 = 1.0 + 2.0 * near / rays_o[..., 2]
    d0 = -1.0 / (W / (2.0 * focal)) * (
        rays_d[..., 0] / rays_d[..., 2] - rays_o[..., 0] / rays_o[..., 2])
    d1 = -1.0 / (H / (2.0 * focal)) * (
        rays_d[..., 1] / rays_d[..., 2] - rays_o[..., 1] / rays_o[..., 2])
    d2 = -2.0 * near / rays_o[..., 2]
    return (torch.stack([o0, o1, o2], dim=-1),
            torch.stack([d0, d1, d2], dim=-1))


def pack_rays(rays_o, rays_d, near, far, viewdirs=None):
    """Per-ray rows ``[o(3), d(3), near, far, viewdirs(3)?]``."""
    shape = rays_d[..., :1].shape
    n = as_tensor(near, rays_d.device).expand(shape)
    f = as_tensor(far, rays_d.device).expand(shape)
    parts = [rays_o, rays_d, n, f]
    if viewdirs is not None:
        parts.append(viewdirs)
    return torch.cat(parts, dim=-1)
