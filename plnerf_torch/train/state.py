"""Train state (port of ``plnerf/train/state.py``): the two networks, their
optimizers and the step count.  The NVS trainers use two optimizers; the
joint (vanilla) trainer keeps one optimizer over both networks in
``opt_fine`` with ``opt_coarse`` None.  The depth trainer adds per-image
depth scales and shifts ([n_images, 1] leaf tensors) with their own Adam
(``opt_ss``) and, under ``--opt_ch_cam``, per-image camera embeddings
([n_images, input_ch_cam]) with theirs (``opt_latent``); the NVS trainers
leave those fields None.

``state_dict`` / ``load_state_dict`` carry the state through a checkpoint
(``checkpoint/io.py``) as tensors, ints and floats only: the networks'
parameters, each optimizer's Adam moments and step per parameter, its
update ``count`` (which sets the scheduled rate and which
``torch.optim.Optimizer.state_dict`` does not hold), the depth tensors
and the step count.  A depth tensor loads in place, so the optimizer that
holds it keeps training the same tensor.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..core.mlp import NeRF
from .optim import ScheduledAdam

_MODULES = ("params_coarse", "params_fine")
_TENSORS = ("depth_scales", "depth_shifts", "cam_embeddings")
_OPTIMIZERS = ("opt_coarse", "opt_fine", "opt_ss", "opt_latent")


def _params(opt: ScheduledAdam):
    return [p for group in opt.param_groups for p in group["params"]]


def _optimizer_state(opt: ScheduledAdam) -> dict:
    """{"count": updates made, "state": {parameter index: {"step",
    "exp_avg", "exp_avg_sq"}}} for the parameters Adam has state for."""
    state = {}
    for i, p in enumerate(_params(opt)):
        s = opt.state.get(p)
        if s:
            state[str(i)] = {"step": float(s["step"]),
                             "exp_avg": s["exp_avg"],
                             "exp_avg_sq": s["exp_avg_sq"]}
    return {"count": int(opt.count), "state": state}


def _load_optimizer_state(opt: ScheduledAdam, sd: dict) -> None:
    """Inverse of ``_optimizer_state``; the parameters must already be on
    their device (the moments follow them there, the step stays on the
    CPU as Adam keeps it)."""
    n = len(_params(opt))
    state = {}
    for i, s in sd["state"].items():
        if not 0 <= int(i) < n:
            raise ValueError(f"optimizer state for parameter {i} of {n}")
        state[int(i)] = {"step": torch.tensor(float(s["step"]),
                                              dtype=torch.float32),
                         "exp_avg": s["exp_avg"],
                         "exp_avg_sq": s["exp_avg_sq"]}
    opt.load_state_dict({"state": state,
                         "param_groups": opt.state_dict()["param_groups"]})
    opt.count = int(sd["count"])


@dataclasses.dataclass
class TrainState:
    step: int
    params_coarse: NeRF
    params_fine: Optional[NeRF]
    opt_coarse: Optional[ScheduledAdam]
    opt_fine: ScheduledAdam
    # depth-supervision extras (None for NVS)
    depth_scales: Optional[torch.Tensor] = None
    depth_shifts: Optional[torch.Tensor] = None
    opt_ss: Optional[ScheduledAdam] = None
    cam_embeddings: Optional[torch.Tensor] = None
    opt_latent: Optional[ScheduledAdam] = None

    def state_dict(self) -> dict:
        """Every field that is not None."""
        out = {"step": int(self.step)}
        for name in _MODULES:
            module = getattr(self, name)
            if module is not None:
                out[name] = module.state_dict()
        for name in _TENSORS:
            tensor = getattr(self, name)
            if tensor is not None:
                out[name] = tensor.detach().clone()
        for name in _OPTIMIZERS:
            opt = getattr(self, name)
            if opt is not None:
                out[name] = _optimizer_state(opt)
        return out

    def load_state_dict(self, sd: dict) -> None:
        """Load the fields ``sd`` holds; a field it lacks keeps its value.
        A field ``sd`` holds that this state has no room for raises."""
        unknown = set(sd) - {"step", *_MODULES, *_TENSORS, *_OPTIMIZERS}
        empty = [k for k in sd if k != "step" and getattr(self, k, 0) is None]
        if unknown or empty:
            raise ValueError(f"checkpoint fields {sorted(unknown | set(empty))}"
                             " have no place in this train state")
        for name in _MODULES:
            if name in sd:
                getattr(self, name).load_state_dict(sd[name])
        for name in _TENSORS:
            if name in sd:
                tensor = getattr(self, name)
                if sd[name].shape != tensor.shape:
                    raise ValueError(f"checkpoint {name} of shape "
                                     f"{tuple(sd[name].shape)}, the state "
                                     f"holds {tuple(tensor.shape)}")
                with torch.no_grad():
                    tensor.copy_(sd[name])
        for name in _OPTIMIZERS:
            if name in sd:
                _load_optimizer_state(getattr(self, name), sd[name])
        if "step" in sd:
            self.step = int(sd["step"])
