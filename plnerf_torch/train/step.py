"""The NVS training step (port of ``plnerf/train/step.py``): render
(coarse -> importance resample -> fine), photometric loss on both passes,
backward, Adam update(s).

Two flavours, both built by ``make_train_step``: two optimizers (fine Adam
+ coarse Adam, run_plnerf) and one joint optimizer over both networks
(run_nerf_vanilla).  The step updates the state's networks and optimizers
in place and returns the same state, its step count advanced.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from ..core import render
from ..core.config import ModelConfig, RenderConfig
from ..core.mlp import NeRF
from ..device import DeviceLike, make_generator, resolve_device
from ..utils.misc import img2mse, mse2psnr
from . import optim
from .state import TrainState

Metrics = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class TrainSetup:
    """Everything static about NVS training."""
    mcfg: ModelConfig = ModelConfig()
    # distinct fine-network dims (--netdepth_fine/--netwidth_fine); None =
    # same as coarse (all shipped recipes)
    mcfg_fine: Optional[ModelConfig] = None
    rcfg: RenderConfig = RenderConfig()
    lrate: float = 5e-4
    coarse_lrate: float = 5e-4
    lrate_decay: int = 250               # in 1000-step units
    fix_coarse_lr_decay: bool = False    # see optim's coarse-rate note
    joint_optimizer: bool = False        # vanilla script
    grad_clip_value: Optional[float] = None
    # staged decay (depth script) instead of exponential when set:
    start_decay_lrate: Optional[int] = None
    end_decay_lrate: Optional[int] = None
    # forward + backward over this many equal ray chunks, grads averaged
    # before one update (the mean of equal-chunk means is the full mean)
    accum_chunks: int = 1

    def fine_schedule(self) -> optim.Schedule:
        if self.start_decay_lrate is not None:
            return optim.staged_decay_schedule(
                self.lrate, self.start_decay_lrate, self.end_decay_lrate)
        return optim.exp_decay_schedule(self.lrate, self.lrate_decay)

    def coarse_schedule(self) -> optim.Schedule:
        base = self.coarse_lrate if self.fix_coarse_lr_decay else self.lrate
        return optim.exp_decay_schedule(base, self.lrate_decay)

    def make_optimizers(self, params_c: NeRF, params_f: Optional[NeRF]
                        ) -> Tuple[optim.ScheduledAdam,
                                   Optional[optim.ScheduledAdam]]:
        """(fine or joint optimizer, coarse optimizer or None)."""
        if self.joint_optimizer or params_f is None:
            both = list(params_c.parameters()) + (
                list(params_f.parameters()) if params_f is not None else [])
            return optim.make_adam(both, self.fine_schedule(),
                                   self.grad_clip_value), None
        return (optim.make_adam(params_f.parameters(), self.fine_schedule(),
                                self.grad_clip_value),
                optim.make_adam(params_c.parameters(), self.coarse_schedule(),
                                self.grad_clip_value))


def init_state(generator: Optional[torch.Generator], setup: TrainSetup,
               device: DeviceLike = None) -> TrainState:
    """Fresh networks (seeded from ``generator``, which lives on
    ``device``) and optimizers.  Runs on the CUDA device unless the CPU is
    asked for."""
    device = resolve_device(device)
    if generator is None:
        generator = make_generator(0, device)
    elif generator.device.type != device.type:
        raise ValueError(f"generator on {generator.device}, state on "
                         f"{device}")
    params_c = NeRF(setup.mcfg, generator, device)
    params_f = (NeRF(setup.mcfg_fine or setup.mcfg, generator, device)
                if setup.rcfg.n_importance > 0 else None)
    opt_f, opt_c = setup.make_optimizers(params_c, params_f)
    return TrainState(step=0, params_coarse=params_c, params_fine=params_f,
                      opt_coarse=opt_c, opt_fine=opt_f)


def _render_loss(params_c: NeRF, params_f: Optional[NeRF], batch,
                 generator: Optional[torch.Generator], setup: TrainSetup,
                 overrides=None) -> Tuple[torch.Tensor, Metrics]:
    """Forward + loss.  batch: dict(rays [R, 8|11], target [R, 3]);
    ``overrides`` injects the renderer's draws (``render_rays``)."""
    ret = render.render_rays(params_c, params_f, batch["rays"], generator,
                             setup.mcfg, setup.rcfg, overrides=overrides,
                             mcfg_fine=setup.mcfg_fine)
    img_loss = img2mse(ret["rgb_map"], batch["target"])
    loss = img_loss
    metrics = {"img_loss": img_loss.detach(),
               "psnr": mse2psnr(img_loss.detach()),
               "sigma0_pos_frac": ret["sigma0_pos_frac"].detach()}
    if "rgb0" in ret:
        img_loss0 = img2mse(ret["rgb0"], batch["target"])
        loss = loss + img_loss0
        metrics["img_loss0"] = img_loss0.detach()
        metrics["psnr0"] = mse2psnr(img_loss0.detach())
    metrics["loss"] = loss.detach()
    return loss, metrics


def _value_and_grad_accum(setup: TrainSetup, params, batch, generator,
                          loss_of: Callable) -> Metrics:
    """Backpropagate ``loss_of(batch, generator)`` into the ``.grad`` of
    ``params`` (those the loss reaches), over ``setup.accum_chunks`` equal
    ray chunks when it is > 1 (peak activation memory of one chunk): chunk
    grads and metrics are summed and scaled by 1 / n, the mean of
    equal-chunk means.  Returns the metrics."""
    n = setup.accum_chunks
    if n <= 1:
        loss, metrics = loss_of(batch, generator)
        loss.backward()
        return metrics
    r = batch["rays"].shape[0]
    if r % n:
        raise ValueError(f"{r} rays do not split into {n} equal chunks")
    acc: Optional[Metrics] = None
    for i in range(n):
        chunk = {k: v[i * (r // n):(i + 1) * (r // n)]
                 for k, v in batch.items()}
        loss, metrics = loss_of(chunk, generator)
        loss.backward()
        acc = metrics if acc is None else {k: acc[k] + metrics[k]
                                           for k in acc}
    inv = 1.0 / n
    with torch.no_grad():
        for q in params:
            if q.grad is not None:
                q.grad.mul_(inv)
    return {k: m * inv for k, m in acc.items()}


def build_one_step(setup: TrainSetup):
    """The single optimization step (state, batch, generator) ->
    (state, metrics)."""

    def step_fn(state: TrainState, batch, generator=None):
        pc, pf = state.params_coarse, state.params_fine

        def loss_of(b, g):
            return _render_loss(pc, pf, b, g, setup)

        params = list(pc.parameters()) + (
            list(pf.parameters()) if pf is not None else [])
        opts = [o for o in (state.opt_fine, state.opt_coarse)
                if o is not None]
        for o in opts:
            o.zero_grad(set_to_none=True)
        metrics = _value_and_grad_accum(setup, params, batch, generator,
                                        loss_of)
        for o in opts:
            o.step()
        state.step += 1
        return state, metrics

    return step_fn


def make_train_step(setup: TrainSetup):
    """The NVS train step: (state, batch, generator) -> (state, metrics).

    batch["rays"]: [R, 8|11]; batch["target"]: [R, 3].
    """
    return build_one_step(setup)
