"""Depth-supervision losses (port of ``plnerf/train/losses.py``).

* ``space_carving_loss``: the sample-based space-carving loss between
  predicted ray-termination quantiles and depth hypotheses (reference
  depth_supervised_exps/model/run_nerf_helpers.py:52-86), with per-ray or
  joint (per-image) hypothesis selection, an optional validity mask and a
  distance threshold.
* ``get_space_carving_idx``: the best hypothesis per ray (or per image),
  the index the hypothesis-caching path keeps (:19-49).

Under data parallelism (``mesh``) each rank holds its rows of the rays.
The joint mode's minimum over hypotheses of a mean over rays does not
split across shards: the per-hypothesis ray means are averaged over the
ranks inside the forward, through a differentiable all-reduce, before
the ``amin`` / ``argmin``, so every rank picks the hypothesis one device
would.  The per-ray mode is a mean over rays and needs nothing.

The minimum over hypotheses is ``torch.amin``, whose gradient splits
evenly between tied entries as ``jnp.min``'s does (``torch.min`` over a
dimension sends all of it to one).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..parallel import mesh as pmesh


def _distances(pred_depth: torch.Tensor, target: torch.Tensor,
               mask: Optional[torch.Tensor], threshold: float
               ) -> torch.Tensor:
    """|pred - target| (the reference's norm over a singleton trailing
    axis, for any p), masked, and zeroed below ``threshold``."""
    distances = torch.abs(pred_depth[None] - target)
    if mask is not None:
        distances = distances * mask
    if threshold > 0:
        distances = torch.where(distances < threshold,
                                torch.zeros_like(distances), distances)
    return distances


def _ray_mean(distances: torch.Tensor, dims, mesh) -> torch.Tensor:
    """The mean over the ray axes ``dims``: over every rank's rays under
    ``mesh`` (equal shares; differentiable)."""
    m = torch.mean(distances, dim=dims)
    if mesh is None:
        return m
    m = pmesh.all_reduce_sum(m, mesh)
    return m / mesh.size if mesh.size > 1 else m


def space_carving_loss(pred_depth: torch.Tensor,
                       target_hypothesis: torch.Tensor,
                       is_joint: bool = False,
                       mask: Optional[torch.Tensor] = None,
                       norm_p: int = 2, threshold: float = 0.0,
                       mesh: Optional[pmesh.Mesh] = None) -> torch.Tensor:
    """pred_depth: [R, N] quantiles; target_hypothesis: [H, R, 1] or
    [H, R, N]; mask: [R] or None (this rank's rays under ``mesh``).  A
    scalar."""
    target = target_hypothesis.expand(
        target_hypothesis.shape[:-1] + (pred_depth.shape[-1],))
    m = None if mask is None else mask[None, :, None]
    distances = _distances(pred_depth, target, m, threshold)  # [H, R, N]
    if is_joint:
        # one hypothesis per image: mean over rays, min over hypotheses,
        # mean over quantiles
        return torch.mean(torch.amin(_ray_mean(distances, (1,), mesh),
                                     dim=0))
    # each (ray, quantile) picks its best hypothesis
    return torch.mean(torch.mean(torch.amin(distances, dim=0), dim=-1))


def get_space_carving_idx(pred_depth: torch.Tensor,
                          target_hypothesis: torch.Tensor,
                          is_joint: bool = False,
                          mask: Optional[torch.Tensor] = None,
                          norm_p: int = 2, threshold: float = 0.0,
                          mesh: Optional[pmesh.Mesh] = None
                          ) -> torch.Tensor:
    """pred_depth: [H, W, N]; target_hypothesis: [n_hyp, H, W, 1]; mask
    broadcast against [n_hyp, H, W, N] after a leading axis.  int32
    indices [H, W, N] (joint mode broadcasts the one per-image argmin);
    ties go to the first hypothesis.  ``mesh``: each rank holds its rows
    (equal shares of the H axis)."""
    target = target_hypothesis.expand(
        target_hypothesis.shape[:-1] + (pred_depth.shape[-1],))
    m = None if mask is None else mask[None]
    distances = _distances(pred_depth, target, m, threshold)
    if is_joint:
        best = torch.argmin(_ray_mean(distances, (1, 2), mesh), dim=0)  # [N]
        return best.expand(pred_depth.shape).to(torch.int32)
    return torch.argmin(distances, dim=0).to(torch.int32)
