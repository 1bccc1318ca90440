"""The NeRF MLP as an ``nn.Module`` (port of ``plnerf/core/mlp.py``).

Topology and parameter names follow the reference ``NeRF`` module
(``pts_linears.i``, ``feature_linear``, ``alpha_linear``,
``views_linears.0``, ``rgb_linear``, ``output_linear``): an 8 x 256 relu
MLP over embedded positions with a skip concat of the embedded input after
layer 4, then the viewdirs head or a plain ``output_linear`` head.
Weights are torch's ``[out, in]``; ``checkpoint/convert_jax.py`` carries
the JAX package's ``[in, out]`` params across.

Float32 matmuls are true fp32 (``resolve_device`` keeps TF32 off on the
card), mirroring ``Precision.HIGHEST``.  In bf16 mode hidden activations
are bf16 and the heads fp32, as in the JAX package.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..device import DeviceLike, resolve_device
from . import encoding
from .config import ModelConfig


def _init_linear(layer: nn.Linear, mode: str, gain: str,
                 generator: Optional[torch.Generator]) -> None:
    """'torch_linear': weight and bias U(-1/sqrt(fan_in), +1/sqrt(fan_in));
    'xavier': xavier_uniform with relu/linear gain, zero bias."""
    fan_out, fan_in = layer.weight.shape

    def uniform(t, bound):
        r = torch.rand(t.shape, generator=generator, dtype=t.dtype,
                       device=t.device)
        t.copy_(r * (2.0 * bound) - bound)

    with torch.no_grad():
        if mode == "xavier":
            g = math.sqrt(2.0) if gain == "relu" else 1.0
            uniform(layer.weight, g * math.sqrt(6.0 / (fan_in + fan_out)))
            layer.bias.zero_()
        else:
            bound = 1.0 / math.sqrt(fan_in)
            uniform(layer.weight, bound)
            uniform(layer.bias, bound)


class NeRF(nn.Module):
    """One NeRF MLP.  ``generator`` seeds the init (draws differ from
    ``jax.random``; load JAX params with ``convert_jax.load_jax_params``
    to compare with the JAX package)."""

    def __init__(self, cfg: ModelConfig,
                 generator: Optional[torch.Generator] = None,
                 device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        D, W = cfg.netdepth, cfg.netwidth
        in_ch = cfg.input_ch
        in_views = cfg.input_ch_views + cfg.input_ch_cam

        lin = []
        fan_in = in_ch
        for i in range(D):
            lin.append(nn.Linear(fan_in, W, device=device))
            # skip concat happens after layer i, feeding layer i+1
            fan_in = W + in_ch if i in cfg.skips else W
        self.pts_linears = nn.ModuleList(lin)
        if cfg.use_viewdirs:
            self.feature_linear = nn.Linear(W, W, device=device)
            self.alpha_linear = nn.Linear(W, 1, device=device)
            self.views_linears = nn.ModuleList(
                [nn.Linear(in_views + W, W // 2, device=device)])
            self.rgb_linear = nn.Linear(W // 2, 3, device=device)
        else:
            self.output_linear = nn.Linear(W, cfg.output_ch, device=device)

        if generator is None:
            generator = torch.Generator(device=device)
            generator.manual_seed(0)
        for layer in self.pts_linears:
            _init_linear(layer, cfg.init, "relu", generator)
        if cfg.use_viewdirs:
            _init_linear(self.feature_linear, cfg.init, "linear", generator)
            _init_linear(self.alpha_linear, cfg.init, "linear", generator)
            _init_linear(self.views_linears[0], cfg.init, "relu", generator)
            _init_linear(self.rgb_linear, cfg.init, "linear", generator)
        else:
            _init_linear(self.output_linear, cfg.init, "linear", generator)

        if cfg.sigma_bias_init != 0.0:
            with torch.no_grad():
                if cfg.use_viewdirs:
                    self.alpha_linear.bias += cfg.sigma_bias_init
                else:
                    self.output_linear.bias[3] += cfg.sigma_bias_init

    def forward(self, pts_embed, views_embed=None, dtype=torch.float32):
        return apply_mlp(self, pts_embed, views_embed, self.cfg, dtype)


def _dense(x: torch.Tensor, layer: nn.Linear, dtype,
           out_dtype=torch.float32) -> torch.Tensor:
    """``x @ W.T + b``.  bf16 operands with an fp32 output are multiplied
    in fp32 (exact products, fp32 sums: the JAX package's
    ``preferred_element_type=f32``); a bf16 output rounds the product and
    adds the bias in bf16, as the JAX package's bf16 hidden layers do."""
    w = layer.weight.to(dtype)
    xd = x.to(dtype)
    if out_dtype == torch.float32:
        out = torch.matmul(xd.float(), w.float().t())
    else:
        out = torch.matmul(xd, w.t())
    return out + layer.bias.to(out_dtype)


def apply_mlp(model: NeRF, pts_embed: torch.Tensor,
              views_embed: Optional[torch.Tensor], cfg: ModelConfig,
              dtype=torch.float32) -> torch.Tensor:
    """Forward pass on embedded inputs.

    pts_embed: [..., input_ch]; views_embed: [..., input_ch_views(+cam)]
    (broadcastable to pts_embed's leading shape) or None.  Returns raw
    [..., 4] (rgb logits + density channel).
    """
    act = dtype if dtype == torch.bfloat16 else torch.float32
    h = pts_embed
    for i, layer in enumerate(model.pts_linears):
        h = F.relu(_dense(h, layer, dtype, act))
        if i in cfg.skips:
            h = torch.cat([pts_embed.to(act), h], dim=-1)

    # heads stay fp32: raw sigma/rgb feed the quadrature
    if cfg.use_viewdirs:
        alpha = _dense(h, model.alpha_linear, dtype)
        feature = _dense(h, model.feature_linear, dtype, act)
        ve = views_embed.to(act).expand(
            feature.shape[:-1] + (views_embed.shape[-1],))
        h = torch.cat([feature, ve], dim=-1)
        for layer in model.views_linears:
            h = F.relu(_dense(h, layer, dtype, act))
        rgb = _dense(h, model.rgb_linear, dtype)
        out = torch.cat([rgb, alpha], dim=-1)
    else:
        out = _dense(h, model.output_linear, dtype)
    return softplus10_density(out, cfg)


def softplus10_density(raw: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Depth script's ``softplus(alpha, beta=10)`` on the density channel;
    identity unless ``density_activation == 'softplus10'``."""
    if cfg.density_activation != "softplus10":
        return raw
    dens = F.softplus(10.0 * raw[..., 3:]) / 10.0
    return torch.cat([raw[..., :3], dens], dim=-1)


def embed_views(viewdirs: torch.Tensor, lead: torch.Size, cfg: ModelConfig,
                cam_embedding: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
    """Embedded view directions for points of leading shape ``lead``
    ([R, S]): [R, 1, ch] (broadcast over samples) where every channel is
    per ray, else [R, S, ch]."""
    if cfg.i_embed == -1:
        ve = viewdirs
    else:
        ve = encoding.embed(viewdirs, cfg.multires_views, cfg.pi_bands)
    ve = ve[..., None, :]                                  # [R, 1, ch]
    if cfg.input_ch_cam > 0:
        per_ray = tuple(lead[:-1]) + (1, cfg.input_ch_cam)
        if cam_embedding is None:
            cam = ve.new_zeros(per_ray)
        else:
            cam = cam_embedding.to(ve.dtype)
            if torch.broadcast_shapes(cam.shape, per_ray) == per_ray:
                cam = cam.expand(per_ray)
            else:
                full = tuple(lead) + (cfg.input_ch_cam,)
                cam = cam.expand(full)
                ve = ve.expand(tuple(lead) + (ve.shape[-1],))
        ve = torch.cat([ve, cam], dim=-1)
    return ve


def query_network(model: NeRF, pts: torch.Tensor,
                  viewdirs: Optional[torch.Tensor], cfg: ModelConfig,
                  cam_embedding: Optional[torch.Tensor] = None,
                  dtype=torch.float32, use_fused: bool = False,
                  fused_fold_heads: bool = False) -> torch.Tensor:
    """Embed + forward.  pts: [R, S, 3]; viewdirs: [R, 3] (broadcast over
    samples) or None.  Returns raw [R, S, 4]."""
    if cfg.i_embed == -1:
        pts_embed = pts
    else:
        pts_embed = encoding.embed(pts, cfg.multires, cfg.pi_bands)

    views_embed = None
    if cfg.use_viewdirs:
        if viewdirs is None:
            raise ValueError("use_viewdirs model queried without viewdirs")
        views_embed = embed_views(viewdirs, pts.shape[:-1], cfg,
                                  cam_embedding)

    if use_fused:
        from ..kernels import fused_mlp
        return fused_mlp.apply(model, pts_embed, views_embed, cfg, dtype,
                               fold_heads=fused_fold_heads)
    return apply_mlp(model, pts_embed, views_embed, cfg, dtype)
