"""Train state (port of ``plnerf/train/state.py``): the two networks, their
optimizers and the step count.  The NVS trainers use two optimizers; the
joint (vanilla) trainer keeps one optimizer over both networks in
``opt_fine`` with ``opt_coarse`` None.  The depth-supervision fields stay
None until depth training is ported."""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..core.mlp import NeRF
from .optim import ScheduledAdam


@dataclasses.dataclass
class TrainState:
    step: int
    params_coarse: NeRF
    params_fine: Optional[NeRF]
    opt_coarse: Optional[ScheduledAdam]
    opt_fine: ScheduledAdam
    # depth-supervision extras (not ported yet)
    depth_scales: Optional[torch.Tensor] = None
    depth_shifts: Optional[torch.Tensor] = None
    opt_ss: Optional[ScheduledAdam] = None
    cam_embeddings: Optional[torch.Tensor] = None
    opt_latent: Optional[ScheduledAdam] = None
