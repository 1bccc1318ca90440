"""Adam and the learning-rate schedules (port of ``plnerf/train/optim.py``).

The reference trains with two Adams, fine at ``lrate`` and coarse at
``coarse_lrate``, and decays both by 0.1 every ``lrate_decay * 1000``
steps.  Its coarse param group is assigned the decayed *fine* rate, so the
coarse schedule's base is ``lrate`` unless ``fix_coarse_lr_decay`` is set
(``train.step.TrainSetup.coarse_schedule``).  The depth script uses a
staged decay and an elementwise grad clip instead.

A schedule maps the count of updates made *before* this one to a rate:
the first update runs at ``schedule(0)``, as optax's ``scale_by_schedule``
does.
"""
from __future__ import annotations

from typing import Callable, Iterable, List, Optional

import torch

Schedule = Callable[[int], float]


def exp_decay_schedule(base_lr: float, lrate_decay: int,
                       decay_rate: float = 0.1) -> Schedule:
    """lr(count) = base * decay_rate ** (count / (lrate_decay * 1000))."""
    decay_steps = lrate_decay * 1000

    def schedule(count: int) -> float:
        return base_lr * decay_rate ** (count / decay_steps)

    return schedule


def staged_decay_schedule(base_lr: float, start_decay: int, end_decay: int,
                          decay_rate: float = 0.1) -> Schedule:
    """Constant until ``start_decay``, exponential ramp to
    base * decay_rate at ``end_decay``, constant after."""

    def schedule(count: int) -> float:
        p = (count - start_decay) / max(1, end_decay - start_decay)
        return base_lr * decay_rate ** min(max(p, 0.0), 1.0)

    return schedule


class ScheduledAdam(torch.optim.Adam):
    """Adam (betas 0.9 / 0.999, eps 1e-8) whose rate is set from
    ``schedule(count)`` before each update, ``count`` being the updates
    made before it, with an optional elementwise grad clip (the reference's
    ``clip_grad_value_``, optax's ``clip``) applied first.

    On CUDA it is capturable: Adam's step counts live on the device and the
    rate is a device tensor written before each update, so a CUDA graph of
    a window of steps (``train/graph.py``) replays them with each step's
    rate.  It is torch's fused Adam there, one kernel per update with the
    bias corrections computed on the device (the foreach Adam's capturable
    path takes a dozen more launches and a division per tensor a step).
    ``step(rate=...)`` takes that rate from a device tensor (a window's
    staged rates, ``rates``); without one it is
    ``schedule(count)``, written into the same tensor, so both paths do
    the same arithmetic.  On the CPU the rate is a Python float, as
    torch's Adam keeps it there."""

    def __init__(self, params: Iterable[torch.Tensor], schedule: Schedule,
                 grad_clip_value: Optional[float] = None):
        params = list(params)
        capturable = bool(params) and params[0].device.type == "cuda"
        lr = float(schedule(0))
        if capturable:
            lr = torch.full((), lr, dtype=torch.float32,
                            device=params[0].device)
        super().__init__(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                         capturable=capturable, fused=capturable or None)
        # eager steps are meant: torch warns of them once per optimizer
        self._warned_capturable_if_run_uncaptured = True
        self.schedule = schedule
        self.grad_clip_value = grad_clip_value
        self.count = 0

    def rates(self, n: int) -> List[float]:
        """The rates of the next ``n`` updates."""
        return [float(self.schedule(self.count + k)) for k in range(n)]

    @torch.no_grad()
    def step(self, closure=None, rate: Optional[torch.Tensor] = None):
        lr = float(self.schedule(self.count)) if rate is None else rate
        c = self.grad_clip_value
        for group in self.param_groups:
            if isinstance(group["lr"], torch.Tensor):
                (group["lr"].fill_ if rate is None else group["lr"].copy_)(lr)
            else:
                # the CPU: a float64 rate reads back exactly
                group["lr"] = lr if rate is None else float(rate)
            if c is not None:
                for p in group["params"]:
                    if p.grad is not None:
                        p.grad.clamp_(-c, c)
        loss = super().step(closure)
        self.count += 1
        return loss


def make_adam(params: Iterable[torch.Tensor], schedule: Schedule,
              grad_clip_value: Optional[float] = None) -> ScheduledAdam:
    return ScheduledAdam(params, schedule, grad_clip_value)
