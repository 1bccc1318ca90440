"""Stratified and importance samplers (port of ``plnerf/core/sampling.py``).

* ``stratified_z_vals``        — coarse pass sampling
* ``sample_pdf``               — classic NeRF inverse-CDF over mid-bins
* ``sample_pdf_reformulation`` — the paper's analytic inverse-CDF for
  piecewise-linear density, with the two closed-form branches, the
  epsilon clamps, the three-way select and the NaN fallback to the left
  bin edge; ``sample_pdf_reformulation_cdf`` is the CDF it searches.

``searchsorted_right`` keeps the JAX package's comparison count
(``sum(cdf <= u)``), not a binary search: after the ``cdf[..., -1] = 1``
overwrite the CDF need not be monotone at its end, and there the two
disagree.  Gathers clip their indices, as the JAX package does; on CUDA
a gather that gradients flow through (``pred_hyp``) sums its backward in a
fixed order (``OneHotGather``).

Samplers take their uniform draws ``u`` explicitly; ``draw_u`` makes them
from a ``torch.Generator``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def linspace01(n: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """``jnp.linspace(0, 1, n)`` bit for bit: ``iota * (1/(n-1))`` in the
    working dtype with the endpoint set to exactly 1 (torch.linspace
    rounds some interior points differently)."""
    if n == 1:
        return torch.zeros(1, dtype=dtype, device=device)
    t = torch.arange(n, dtype=dtype, device=device) * (1.0 / (n - 1))
    t[-1] = 1.0
    return t


def stratified_z_vals(near: torch.Tensor, far: torch.Tensor, n_samples: int,
                      lindisp: bool = False,
                      t_rand: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Coarse z values: linspace in depth (or disparity), optionally
    jittered within mid-bins by ``t_rand`` [R, S].  near/far: [R, 1]."""
    t_vals = linspace01(n_samples, near.dtype, near.device)
    if not lindisp:
        z_vals = near * (1.0 - t_vals) + far * t_vals
    else:
        z_vals = 1.0 / (1.0 / near * (1.0 - t_vals) + 1.0 / far * t_vals)
    if t_rand is not None:
        mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
        upper = torch.cat([mids, z_vals[..., -1:]], dim=-1)
        lower = torch.cat([z_vals[..., :1], mids], dim=-1)
        z_vals = lower + (upper - lower) * t_rand
    return z_vals


def draw_u(generator: Optional[torch.Generator], n_rays: int, n_samples: int,
           det: bool, joint: bool = False, device=None) -> torch.Tensor:
    """Uniform draws for the importance samplers, [n_rays, n_samples].
    det: linspace(0, 1) for every ray; joint: one random vector shared by
    every ray."""
    if det:
        return linspace01(n_samples, device=device).expand(n_rays, n_samples)
    if joint:
        u = torch.rand(n_samples, generator=generator, device=device)
        return u.expand(n_rays, n_samples)
    return torch.rand((n_rays, n_samples), generator=generator, device=device)


def searchsorted_right(cdf: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """For each u, the number of cdf entries <= u.  cdf: [R, B],
    u: [R, N] -> int64 [R, N]."""
    return (cdf[..., None, :] <= u[..., :, None]).sum(dim=-1)


class OneHotGather(torch.autograd.Function):
    """``torch.gather`` along the last axis whose backward sums each bin's
    cotangents by a one-hot reduction over the gathered axis, in a fixed
    order.  Gather's own backward scatter-adds with atomics on CUDA, so
    two equal backward passes can differ in the last bit wherever several
    draws fall in one bin."""

    @staticmethod
    def forward(ctx, vals: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(idx)
        ctx.bins = vals.shape[-1]
        return torch.gather(vals, -1, idx)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        idx, = ctx.saved_tensors
        hit = idx[..., None] == torch.arange(ctx.bins, device=idx.device)
        return torch.where(hit, g[..., None], 0.0).sum(-2), None


def _gather(vals: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """vals: [R, B], idx: [R, N] -> [R, N], indices clipped to range.  A
    gather that gradients flow through on CUDA runs ``OneHotGather``, so
    the step repeats bit for bit; on the CPU gather's own backward is
    already serial."""
    idx = idx.clamp(0, vals.shape[-1] - 1)
    if vals.is_cuda and vals.requires_grad and torch.is_grad_enabled():
        return OneHotGather.apply(vals, idx)
    return torch.gather(vals, -1, idx)


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, u: torch.Tensor
               ) -> torch.Tensor:
    """Classic inverse-CDF sampling.  bins: [R, B] (z mid-points),
    weights: [R, B-1], u: [R, N] in [0, 1]."""
    weights = weights + 1e-5
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)  # [R, B]

    inds = searchsorted_right(cdf, u)
    below = torch.clamp_min(inds - 1, 0)
    above = torch.clamp_max(inds, cdf.shape[-1] - 1)
    cdf_below = _gather(cdf, below)
    cdf_above = _gather(cdf, above)
    bins_below = _gather(bins, below)
    bins_above = _gather(bins, above)

    denom = cdf_above - cdf_below
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_below) / denom
    return bins_below + t * (bins_above - bins_below)


def _ln_term(T_left, u, epsilon):
    return -torch.log(torch.clamp_min(
        (1.0 - u) / torch.clamp_min(T_left, epsilon), epsilon))


def _clip(t, lo: float, hi: torch.Tensor) -> torch.Tensor:
    # jnp.clip order: min(max(t, lo), hi); NaN propagates
    return torch.minimum(torch.clamp_min(t, lo), hi)


def _pw_linear_sample_increasing(s_left, s_right, T_left, tau_left,
                                 tau_right, u, epsilon):
    """Closed-form root of int tau = -ln((1-u)/T_left), tau increasing."""
    width = s_right - s_left
    discriminant = tau_left ** 2 + (
        2.0 * (tau_right - tau_left) * _ln_term(T_left, u, epsilon)
        / torch.clamp_min(width, epsilon))
    t = (width * (-tau_left + torch.sqrt(torch.clamp_min(discriminant,
                                                          epsilon)))
         / torch.clamp_min(tau_right - tau_left, epsilon))
    return s_left + _clip(t, epsilon, width)


def _pw_linear_sample_decreasing(s_left, s_right, T_left, tau_left,
                                 tau_right, u, epsilon):
    """Decreasing-tau branch."""
    width = s_right - s_left
    discriminant = tau_left ** 2 - (
        2.0 * (tau_left - tau_right) * _ln_term(T_left, u, epsilon)
        / torch.clamp_min(width, epsilon))
    t = (width * (tau_left - torch.sqrt(torch.clamp_min(discriminant,
                                                         epsilon)))
         / torch.clamp_min(tau_left - tau_right, epsilon))
    return s_left + _clip(t, epsilon, width)


def sample_pdf_reformulation(
    bins: torch.Tensor, weights: torch.Tensor, tau: torch.Tensor,
    T: torch.Tensor, near: torch.Tensor, far: torch.Tensor, u: torch.Tensor,
    zero_threshold: float = 1e-4, epsilon: float = 1e-3,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Analytic inverse-CDF for the piecewise-linear density model.

    bins: [R, S] (coarse z, without near/far), weights: [R, S+1],
    tau, T: [R, S+2], near/far: [R, 1], u: [R, N].
    Returns (samples, T_below, tau_below, bin_below), all [R, N].
    """
    bins_aug = torch.cat([near, bins, far], dim=-1)          # [R, S+2]
    # the weights ARE the pdf
    cdf = sample_pdf_reformulation_cdf(bins, weights, near, far)

    inds = searchsorted_right(cdf, u)
    below = torch.clamp_min(inds - 1, 0)
    above = torch.clamp_max(inds, cdf.shape[-1] - 1)

    s_left = _gather(bins_aug, below)
    s_right = _gather(bins_aug, above)
    T_left = _gather(T, below)
    tau_left = _gather(tau, below)
    tau_right = _gather(tau, above)
    tau_diff_g = _gather(tau[..., 1:] - tau[..., :-1], below)

    increasing = _pw_linear_sample_increasing(
        s_left, s_right, T_left, tau_left, tau_right, u, epsilon)
    decreasing = _pw_linear_sample_decreasing(
        s_left, s_right, T_left, tau_left, tau_right, u, epsilon)

    # constant interval -> left edge; then the closed-form branches where
    # the slope is significant (the reference's samples1/2/3 order)
    samples = torch.where(tau_diff_g.abs() < zero_threshold, s_left,
                          torch.full_like(s_left, -1.0))
    samples = torch.where(tau_diff_g >= zero_threshold, increasing, samples)
    samples = torch.where(tau_diff_g <= -zero_threshold, decreasing, samples)
    samples = torch.where(torch.isnan(samples), s_left, samples)
    return samples, T_left, tau_left, s_left


def sample_pdf_reformulation_cdf(bins: torch.Tensor, weights: torch.Tensor,
                                 near: torch.Tensor, far: torch.Tensor
                                 ) -> torch.Tensor:
    """The CDF the reformulated sampler searches, [R, S+2]: 0, the running
    sum of the weights, and a last entry set to 1 (normalised by fiat;
    reference run_nerf_helpers.py:374), built out of place."""
    cdf = torch.cumsum(weights, dim=-1)
    return torch.cat([torch.zeros_like(cdf[..., :1]), cdf[..., :-1],
                      torch.ones_like(cdf[..., :1])], dim=-1)
