"""The training steps (port of ``plnerf/train/step.py``): render (coarse
-> importance resample -> fine), photometric loss on both passes,
backward, Adam update(s).

Three flavours: two optimizers (fine Adam + coarse Adam, run_plnerf) and
one joint optimizer over both networks (run_nerf_vanilla), both built by
``make_train_step``; and the depth-supervised step
(``make_depth_train_step``, run_nerf_sample_based_depth): one joint Adam
with an elementwise grad clip, the space-carving loss, per-image depth
scale / shift trained by their own Adam and, optionally, per-image camera
embeddings by a third.  A step updates the state's tensors and optimizers
in place and returns the same state, its step count advanced.

``make_occ_train_step`` is the NVS step with occupancy-grid guided coarse
samples (``core/occgrid.py``): it also folds the step's own density
evaluations into the grid and returns the new grid.  The depth step takes
a grid the same way (``depth_grads``' batch key ``occ_grid``; the driver
applies ``apply_occ_update``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from ..core import occgrid, render
from ..core.config import ModelConfig, RenderConfig
from ..core.mlp import NeRF
from ..device import DeviceLike, make_generator, resolve_device
from ..utils.misc import img2mse, mse2psnr
from . import losses, optim
from .state import TrainState

Metrics = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class TrainSetup:
    """Everything static about training."""
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
    # depth supervision:
    space_carving_weight: float = 0.0
    warm_start_nerf: int = 0
    is_joint: bool = False
    norm_p: int = 2
    space_carving_threshold: float = 0.0
    scaleshift_lr: float = 1e-6
    freeze_ss: int = 400000
    # per-image camera embeddings trained at ch_cam_lr (--opt_ch_cam); they
    # start at zeros, the eval-time default for an unseen view
    opt_ch_cam: bool = False
    ch_cam_lr: float = 1e-4
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
               device: DeviceLike = None, n_images: int = 0) -> TrainState:
    """Fresh networks (seeded from ``generator``, which lives on
    ``device``) and optimizers.  Runs on the CUDA device unless the CPU is
    asked for.  With space carving or ``n_images`` > 0, also per-image
    depth scales of 1 and shifts of 0 with their Adam; with
    ``opt_ch_cam`` (and camera channels) zero camera embeddings with
    theirs."""
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
    state = TrainState(step=0, params_coarse=params_c, params_fine=params_f,
                       opt_coarse=opt_c, opt_fine=opt_f)
    n = max(n_images, 1)
    if setup.space_carving_weight > 0 or n_images > 0:
        state.depth_scales = torch.ones((n, 1), device=device,
                                        requires_grad=True)
        state.depth_shifts = torch.zeros((n, 1), device=device,
                                         requires_grad=True)
        state.opt_ss = optim.make_adam(
            [state.depth_scales, state.depth_shifts],
            lambda _: setup.scaleshift_lr)
    if setup.opt_ch_cam and setup.mcfg.input_ch_cam > 0:
        state.cam_embeddings = torch.zeros((n, setup.mcfg.input_ch_cam),
                                           device=device, requires_grad=True)
        state.opt_latent = optim.make_adam([state.cam_embeddings],
                                           lambda _: setup.ch_cam_lr)
    return state


def _render_loss(params_c: NeRF, params_f: Optional[NeRF], batch,
                 generator: Optional[torch.Generator], setup: TrainSetup,
                 overrides=None, scale=None, shift=None, sc_weight=None,
                 cam_emb=None) -> Tuple[torch.Tensor, Metrics]:
    """Forward + loss.  batch: dict(rays [R, 8|11], target [R, 3], and for
    space carving target_h [H, R, 1] and sc_mask [R]; with an occupancy
    grid, occ_grid, and the metrics then carry the density observations
    ``_occ_z`` / ``_occ_sigma`` for ``apply_occ_update`` and
    ``occ_ray_frac``); ``overrides``
    injects the renderer's draws (``render_rays``).  With space carving
    the hypotheses are ``target_h * scale + shift`` and the term's weight
    is ``sc_weight`` (the setup's unless given; 0 keeps the term in the
    graph with zero gradients).  ``cam_emb``: this image's camera
    embedding [input_ch_cam] or None."""
    ret = render.render_rays(params_c, params_f, batch["rays"], generator,
                             setup.mcfg, setup.rcfg, cam_embedding=cam_emb,
                             overrides=overrides, mcfg_fine=setup.mcfg_fine,
                             occ_grid=batch.get("occ_grid"))
    img_loss = img2mse(ret["rgb_map"], batch["target"])
    loss = img_loss
    metrics = {"img_loss": img_loss.detach(),
               "psnr": mse2psnr(img_loss.detach()),
               "sigma0_pos_frac": ret["sigma0_pos_frac"].detach()}
    if "occ_z" in ret:
        metrics["_occ_z"] = ret["occ_z"].detach()
        metrics["_occ_sigma"] = ret["occ_sigma"]
        if "occ_ray_frac" in ret:
            metrics["occ_ray_frac"] = ret["occ_ray_frac"].detach()
    if setup.space_carving_weight > 0.0:
        target_h = batch["target_h"]
        if scale is not None:
            target_h = target_h * scale + shift
        sc = losses.space_carving_loss(
            ret["pred_hyp"], target_h, is_joint=setup.is_joint,
            mask=batch.get("sc_mask"), norm_p=setup.norm_p,
            threshold=setup.space_carving_threshold)
        w = setup.space_carving_weight if sc_weight is None else sc_weight
        loss = loss + w * sc
        metrics["space_carving_loss"] = sc.detach()
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
    equal-chunk means.  The occupancy grid's density observations
    (``_occ_*``) are concatenated back into ray order instead.  Returns the
    metrics."""
    n = setup.accum_chunks
    if n <= 1:
        loss, metrics = loss_of(batch, generator)
        loss.backward()
        return metrics
    r = batch["rays"].shape[0]
    if r % n:
        raise ValueError(f"{r} rays do not split into {n} equal chunks")
    acc: Optional[Metrics] = None
    occ: Dict[str, list] = {}
    for i in range(n):
        lo, hi = i * (r // n), (i + 1) * (r // n)
        chunk = {k: v if k == "occ_grid" else v[lo:hi]
                 for k, v in batch.items()}
        loss, metrics = loss_of(chunk, generator)
        loss.backward()
        for k in [k for k in metrics if k.startswith("_occ")]:
            occ.setdefault(k, []).append(metrics.pop(k))
        acc = metrics if acc is None else {k: acc[k] + metrics[k]
                                           for k in acc}
    inv = 1.0 / n
    with torch.no_grad():
        for q in params:
            if q.grad is not None:
                q.grad.mul_(inv)
    return {**{k: m * inv for k, m in acc.items()},
            **{k: torch.cat(v, 0) for k, v in occ.items()}}


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


def _trains_embeddings(setup: TrainSetup) -> bool:
    return setup.opt_ch_cam and setup.mcfg.input_ch_cam > 0


def depth_grads(setup: TrainSetup, state: TrainState, batch,
                generator: Optional[torch.Generator] = None,
                overrides=None) -> Metrics:
    """Forward and backward of the depth loss: every tensor the depth step
    trains gets its ``.grad`` (before any clip), the per-image ones dense
    with zeros off ``img_idx``.  Returns the metrics.

    The space-carving term stays in the graph during the warm start, at
    weight 0, and a per-image tensor the loss does not reach gets a zero
    grad: optax updates every leaf at every step, so stale Adam moments
    move the other images' rows and a skipped update would part the two
    trajectories."""
    img = int(batch["img_idx"])
    train_emb = _trains_embeddings(setup)
    for o in (state.opt_fine, state.opt_ss, state.opt_latent):
        if o is not None:
            o.zero_grad(set_to_none=True)
    # the reference's iteration i is step + 1: `i > warm_start` is
    # `step >= warm_start`
    sc_weight = (setup.space_carving_weight
                 if state.step >= setup.warm_start_nerf else 0.0)
    loss, metrics = _render_loss(
        state.params_coarse, state.params_fine, batch, generator, setup,
        overrides=overrides, scale=state.depth_scales[img],
        shift=state.depth_shifts[img], sc_weight=sc_weight,
        cam_emb=state.cam_embeddings[img] if train_emb else None)
    loss.backward()
    for q in (state.depth_scales, state.depth_shifts) + (
            (state.cam_embeddings,) if train_emb else ()):
        if q.grad is None:
            q.grad = torch.zeros_like(q)
    return metrics


def make_depth_train_step(setup: TrainSetup):
    """The depth-supervised step (reference run_nerf_sample_based_depth.py:
    1102-1161): (state, batch, generator, overrides) -> (state, metrics).

    batch: rays [R, 8|11], target [R, 3], target_h [H, R, 1] (the image's
    depth hypotheses), sc_mask [R], img_idx (the image).  The joint Adam
    steps both networks; the scale / shift Adam steps every step, but the
    values it moves are put back once ``step + 1 >= freeze_ss`` (the
    reference steps it while ``i < freeze_ss``), so its moments advance
    while the values hold; the camera-embedding Adam steps every step.
    The state must come from ``init_state(..., n_images)`` with the same
    setup."""

    def step_fn(state: TrainState, batch, generator=None, overrides=None):
        metrics = depth_grads(setup, state, batch, generator, overrides)
        state.opt_fine.step()
        frozen = state.step + 1 >= setup.freeze_ss
        held = ([q.detach().clone() for q in (state.depth_scales,
                                               state.depth_shifts)]
                if frozen else None)
        state.opt_ss.step()
        if frozen:
            with torch.no_grad():
                state.depth_scales.copy_(held[0])
                state.depth_shifts.copy_(held[1])
        if _trains_embeddings(setup):
            state.opt_latent.step()
        state.step += 1
        return state, metrics

    return step_fn


def apply_occ_update(setup: TrainSetup, occ_grid: occgrid.Grid, batch,
                     metrics: Metrics) -> Tuple[occgrid.Grid, Metrics]:
    """Pop the forward pass's density observations (``_occ_z``,
    ``_occ_sigma``) out of ``metrics`` and fold them into the grid's EMA;
    returns ``(grid, metrics)``.  ``occ_ray_frac`` stays in the metrics:
    the mean occupied fraction of candidate bins along this batch's rays,
    read by the sampler before the update."""
    z = metrics.pop("_occ_z")
    sigma = metrics.pop("_occ_sigma")
    rays = batch["rays"]
    pts = rays[:, None, 0:3] + rays[:, None, 3:6] * z[..., None]
    return occgrid.update_grid(occ_grid, pts, sigma, setup.rcfg.occ), metrics


def make_occ_train_step(setup: TrainSetup):
    """The occupancy-grid train step: (state, grid, batch, generator) ->
    (state, grid, metrics).  The optimization of ``make_train_step`` with
    the coarse samples placed by the grid, then the grid updated from the
    step's own density evaluations.  Needs ``setup.rcfg.occ``."""
    if setup.rcfg.occ is None:
        raise ValueError("make_occ_train_step needs setup.rcfg.occ")
    one_step = build_one_step(setup)

    def step_fn(state: TrainState, occ_grid: occgrid.Grid, batch,
                generator=None):
        state, metrics = one_step(state, dict(batch, occ_grid=occ_grid),
                                  generator)
        occ_grid, metrics = apply_occ_update(setup, occ_grid, batch, metrics)
        return state, occ_grid, metrics

    return step_fn
