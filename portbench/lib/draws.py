"""The order in which a run draws its random numbers, shared by the
harness and the reference so that both see the same numbers.

A train step draws, from the run's one generator: its image (an index
into the training views), then the rows and the columns of its rays'
pixels (the harness's ``batch``, handed to the program's
``sample_one_image_batch`` as ``draws``); then the renderer draws the
coarse samples' jitter [R, N_samples] and the resampling's uniforms [R,
N_importance] (``render``: ``core/render.render_rays``' order with
``perturb`` on and no density noise).  A served request's chunk ``i``
draws the renderer's two from a generator seeded ``seed + i``.
"""
from __future__ import annotations

from typing import Tuple

import torch


def batch(gen: torch.Generator, n_train: int, H: int, W: int, n_rays: int,
          device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(image index [1], pixel rows [R], pixel columns [R])."""
    ti = torch.randint(0, n_train, (1,), generator=gen, device=device)
    y = torch.randint(0, H, (n_rays,), generator=gen, device=device)
    x = torch.randint(0, W, (n_rays,), generator=gen, device=device)
    return ti, y, x


def render(gen: torch.Generator, n_rays: int, n_samples: int,
           n_importance: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(coarse jitter [R, Ns], resampling uniforms [R, Ni])."""
    t = torch.rand((n_rays, n_samples), generator=gen, device=device)
    u = torch.rand((n_rays, n_importance), generator=gen, device=device)
    return t, u
