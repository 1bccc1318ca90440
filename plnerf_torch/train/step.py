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

``make_multi_train_step`` fuses ``n_inner`` steps of any of them into one
window: on CUDA one replay of a CUDA graph (``train/graph.py``), on the
CPU the same body run eagerly.  Each step may take ``StepInputs``, what
the host knows of it as device tensors (its optimizers' rates and its
step count, staged per window), so a replay gives every step its own;
without them a step reads the schedules and ``state.step``.  The depth
step's warm start and scale / shift freeze read the step count on the
device either way.

Data parallelism (``mesh``, ``parallel/mesh.py``): every rank is handed
the same global batch, drawn from the same seed at the global ray count,
and trains on its own rows of it (``shard_batch``).  Of the two designs
for the renderer's random draws this is the one that draws the global
noise on every rank and slices it (``render.shared_draws``): a rank's
jitter, density noise and importance draws are its rows of what one
device would draw for the whole batch, so the step does not depend on the
world size (with ``perturb`` off and no noise it draws nothing at all).
After the backward one flat all-reduce averages every gradient and the
step's scalar metrics over the ranks (``all_reduce_mean``; each rank's
loss is the mean over its equal share of rays, so the mean of the ranks'
gradients is the global batch's); the optimizers then step identically
on every rank, the depth recipe's +-0.1 clip and the scale / shift and
camera-embedding Adams included.  The space-carving loss's minimum over
hypotheses of a mean over rays reduces its ray sums inside the forward,
and the occupancy grid's per-voxel observations are max-reduced before
the blend, so the grid stays the one a single device would compute.  One
rank reproduces the run without a mesh bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from ..core import occgrid, render
from ..core.config import ModelConfig, RenderConfig
from ..core.mlp import NeRF
from ..device import DeviceLike, make_generator, resolve_device
from ..parallel import mesh as pmesh
from ..utils import profile
from ..utils.misc import img2mse, mse2psnr
from . import losses, optim
from .state import TrainState

Metrics = Dict[str, torch.Tensor]


@dataclasses.dataclass
class StepInputs:
    """What the host knows of one step, as device tensors (a row of a
    window's staged ``graph.Feed``, so that a replayed window gives each
    step its own): ``rates``, one 0-dim rate per optimizer in
    ``TrainState.optimizers()`` order, and ``step``, the step count before
    the update.  A step without them takes the rates from the schedules
    and the count from ``state.step``."""
    rates: Sequence[torch.Tensor]
    step: torch.Tensor

    @staticmethod
    def of(feed, k: int) -> "StepInputs":
        """Step ``k`` of ``feed``."""
        return StepInputs(list(feed.rates[:, k]), feed.row("step")[k])


def _update(state: TrainState, opts, inputs: Optional[StepInputs]) -> None:
    """Step each optimizer of ``opts`` at its rate of ``inputs``."""
    order = state.optimizers()
    for o in opts:
        o.step(rate=None if inputs is None
               else inputs.rates[order.index(o)])


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
                 cam_emb=None, mesh=None) -> Tuple[torch.Tensor, Metrics]:
    """Forward + loss.  batch: dict(rays [R, 8|11], target [R, 3], and for
    space carving target_h [H, R, 1] and sc_mask [R]; with an occupancy
    grid, occ_grid, and the metrics then carry the density observations
    ``_occ_z`` / ``_occ_sigma`` for ``apply_occ_update`` and
    ``occ_ray_frac``); ``overrides``
    injects the renderer's draws (``render_rays``).  With space carving
    the hypotheses are ``target_h * scale + shift`` and the term's weight
    is ``sc_weight`` (the setup's unless given; 0 keeps the term in the
    graph with zero gradients).  ``cam_emb``: this image's camera
    embedding [input_ch_cam] or None; ``mesh``: the ranks whose rays the
    joint space-carving term reduces over."""
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
            threshold=setup.space_carving_threshold, mesh=mesh)
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
                          loss_of: Callable, draws=None) -> Metrics:
    """Backpropagate ``loss_of(batch, generator)`` (``loss_of(batch,
    generator, draws)`` with ``draws``) into the ``.grad`` of ``params``
    (those the loss reaches), over ``setup.accum_chunks`` equal ray chunks
    when it is > 1 (peak activation memory of one chunk): chunk grads and
    metrics are summed and scaled by 1 / n, the mean of equal-chunk means;
    ``draws`` (the renderer's, ``render.shared_draws``) are cut into the
    same chunks.  The occupancy grid's density observations (``_occ_*``)
    are concatenated back into ray order instead.  Returns the metrics."""
    def value(b, d):
        return loss_of(b, generator) if d is None else loss_of(b, generator,
                                                               d)

    n = setup.accum_chunks
    if n <= 1:
        loss, metrics = value(batch, draws)
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
        loss, metrics = value(chunk, None if draws is None else
                              {k: v[lo:hi] for k, v in draws.items()})
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


def _local(setup: TrainSetup, batch, generator, mesh):
    """``(batch, draws)``: this rank's rows of the global batch and of the
    renderer's draws for it (``render.shared_draws``); without a mesh the
    batch as it is, and the renderer draws for itself."""
    if mesh is None:
        return batch, None
    n = batch["rays"].shape[0]
    draws = render.shared_draws(generator, setup.rcfg, n,
                                pmesh.row_range(n, mesh),
                                batch["rays"].device)
    return pmesh.shard_batch(batch, mesh), draws


# metrics recomputed from their reduced inputs, not averaged
_DERIVED = {"psnr": "img_loss", "psnr0": "img_loss0"}


def _all_reduce(mesh, tensors, metrics: Metrics) -> Metrics:
    """The ranks' mean of the ``.grad`` of ``tensors`` (in place) and of
    the scalar metrics, in one flat all-reduce; the PSNRs recomputed from
    the mean MSEs, the ``_occ_*`` observations left as they are."""
    if mesh is None:
        return metrics
    grads = [q.grad for q in tensors if q.grad is not None]
    keys = [k for k in metrics
            if not k.startswith("_") and k not in _DERIVED]
    reduced = pmesh.all_reduce_mean(grads + [metrics[k] for k in keys], mesh)
    with torch.no_grad():
        for g, r in zip(grads, reduced):
            g.copy_(r)
    out = dict(metrics, **dict(zip(keys, reduced[len(grads):])))
    for k, src in _DERIVED.items():
        if k in out:
            out[k] = mse2psnr(out[src])
    return out


def _step_local(setup: TrainSetup, mesh, state: TrainState, batch,
                generator, draws, inputs: Optional[StepInputs] = None):
    """The optimization step on this rank's ``batch`` (and ``draws``):
    grads, their reduction over the mesh, the updates (at ``inputs``'
    rates)."""
    pc, pf = state.params_coarse, state.params_fine

    def loss_of(b, g, d=None):
        return _render_loss(pc, pf, b, g, setup, overrides=d)

    params = list(pc.parameters()) + (
        list(pf.parameters()) if pf is not None else [])
    opts = [o for o in (state.opt_fine, state.opt_coarse) if o is not None]
    for o in opts:
        o.zero_grad(set_to_none=True)
    metrics = _value_and_grad_accum(setup, params, batch, generator, loss_of,
                                    draws)
    metrics = _all_reduce(mesh, params, metrics)
    _update(state, opts, inputs)
    state.step += 1
    return state, metrics


def build_one_step(setup: TrainSetup, mesh: Optional[pmesh.Mesh] = None):
    """The single optimization step (state, batch, generator, inputs) ->
    (state, metrics); with ``mesh``, on this rank's rows of the global
    batch (the module docstring); ``inputs``: ``StepInputs`` or None."""

    def step_fn(state: TrainState, batch, generator=None, inputs=None):
        batch, draws = _local(setup, batch, generator, mesh)
        return _step_local(setup, mesh, state, batch, generator, draws,
                           inputs)

    return step_fn


def make_train_step(setup: TrainSetup, mesh: Optional[pmesh.Mesh] = None):
    """The NVS train step: (state, batch, generator, inputs=None) ->
    (state, metrics).

    batch["rays"]: [R, 8|11]; batch["target"]: [R, 3] (the global batch
    under ``mesh``).
    """
    return build_one_step(setup, mesh)


def _trains_embeddings(setup: TrainSetup) -> bool:
    return setup.opt_ch_cam and setup.mcfg.input_ch_cam > 0


def _depth_tensors(setup: TrainSetup, state: TrainState) -> list:
    """Every tensor the depth step trains."""
    out = list(state.params_coarse.parameters()) + (
        list(state.params_fine.parameters())
        if state.params_fine is not None else [])
    return out + [state.depth_scales, state.depth_shifts] + (
        [state.cam_embeddings] if _trains_embeddings(setup) else [])


def image_index(img, device) -> torch.Tensor:
    """An image index (an int or a tensor of one element) as a
    1-element int64 tensor on ``device``: an index the host never
    reads."""
    if not isinstance(img, torch.Tensor):
        return torch.full((1,), int(img), dtype=torch.int64, device=device)
    return img.reshape(1).to(device=device, dtype=torch.int64)


def depth_grads(setup: TrainSetup, state: TrainState, batch,
                generator: Optional[torch.Generator] = None,
                overrides=None, mesh=None,
                step: Optional[torch.Tensor] = None) -> Metrics:
    """Forward and backward of the depth loss: every tensor the depth step
    trains gets its ``.grad`` (before any clip), the per-image ones dense
    with zeros off ``img_idx``.  Returns the metrics.

    The space-carving term stays in the graph during the warm start, at
    weight 0, and a per-image tensor the loss does not reach gets a zero
    grad: optax updates every leaf at every step, so stale Adam moments
    move the other images' rows and a skipped update would part the two
    trajectories.  ``mesh``: ``batch`` is this rank's rows, the joint
    space-carving term reduces over the ranks and the grads are not yet
    reduced.  ``batch["img_idx"]``: an int or a 1-element device tensor;
    ``step``: the step count as a device tensor (``StepInputs.step``),
    else ``state.step``."""
    img = image_index(batch["img_idx"], state.depth_scales.device)
    train_emb = _trains_embeddings(setup)
    for o in (state.opt_fine, state.opt_ss, state.opt_latent):
        if o is not None:
            o.zero_grad(set_to_none=True)
    # the reference's iteration i is step + 1: `i > warm_start` is
    # `step >= warm_start`; on the device, so that each step of a
    # replayed window reads its own
    sc_weight = torch.where(_device_step(state, step)
                            >= setup.warm_start_nerf,
                            setup.space_carving_weight, 0.0)
    loss, metrics = _render_loss(
        state.params_coarse, state.params_fine, batch, generator, setup,
        overrides=overrides, scale=state.depth_scales.index_select(0, img),
        shift=state.depth_shifts.index_select(0, img), sc_weight=sc_weight,
        cam_emb=(state.cam_embeddings.index_select(0, img)[0] if train_emb
                 else None), mesh=mesh)
    loss.backward()
    for q in (state.depth_scales, state.depth_shifts) + (
            (state.cam_embeddings,) if train_emb else ()):
        if q.grad is None:
            q.grad = torch.zeros_like(q)
    return metrics


def _device_step(state: TrainState, step: Optional[torch.Tensor]
                 ) -> torch.Tensor:
    """The step count before the update on the state's device."""
    if step is not None:
        return step
    return torch.full((), state.step, dtype=torch.int64,
                      device=state.depth_scales.device)


def make_depth_train_step(setup: TrainSetup,
                          mesh: Optional[pmesh.Mesh] = None):
    """The depth-supervised step (reference run_nerf_sample_based_depth.py:
    1102-1161): (state, batch, generator, overrides, inputs) -> (state,
    metrics).

    batch: rays [R, 8|11], target [R, 3], target_h [H, R, 1] (the image's
    depth hypotheses), sc_mask [R], img_idx (the image).  The joint Adam
    steps both networks; the scale / shift Adam steps every step, but the
    values it moves are put back once ``step + 1 >= freeze_ss`` (the
    reference steps it while ``i < freeze_ss``), so its moments advance
    while the values hold; the camera-embedding Adam steps every step.
    The freeze and the warm start read the step count on the device
    (``inputs.step``, else ``state.step``), so a window that crosses them
    is one program.  The state must come from ``init_state(...,
    n_images)`` with the same setup.  ``mesh``: the global batch, as
    ``make_train_step`` takes it (``overrides`` then are not taken)."""

    def step_fn(state: TrainState, batch, generator=None, overrides=None,
                inputs: Optional[StepInputs] = None):
        if mesh is not None:
            if overrides is not None:
                raise ValueError("overrides with a mesh")
            batch, overrides = _local(setup, batch, generator, mesh)
        step = _device_step(state, None if inputs is None else inputs.step)
        metrics = depth_grads(setup, state, batch, generator, overrides,
                              mesh, step)
        metrics = _all_reduce(mesh, _depth_tensors(setup, state), metrics)
        _update(state, [state.opt_fine], inputs)
        frozen = step + 1 >= setup.freeze_ss
        ss = (state.depth_scales, state.depth_shifts)
        held = [q.detach().clone() for q in ss]
        _update(state, [state.opt_ss], inputs)
        with torch.no_grad():
            for q, h in zip(ss, held):
                q.copy_(torch.where(frozen, h, q))
        if _trains_embeddings(setup):
            _update(state, [state.opt_latent], inputs)
        state.step += 1
        return state, metrics

    return step_fn


def apply_occ_update(setup: TrainSetup, occ_grid: occgrid.Grid, batch,
                     metrics: Metrics, mesh: Optional[pmesh.Mesh] = None
                     ) -> Tuple[occgrid.Grid, Metrics]:
    """Pop the forward pass's density observations (``_occ_z``,
    ``_occ_sigma``) out of ``metrics`` and fold them into the grid's EMA;
    returns ``(grid, metrics)``.  ``occ_ray_frac`` stays in the metrics:
    the mean occupied fraction of candidate bins along this batch's rays,
    read by the sampler before the update.  ``mesh``: ``batch`` is this
    rank's rows (whose observations the metrics hold); the observations
    are max-reduced over the ranks (``occgrid.update_grid``)."""
    z = metrics.pop("_occ_z")
    sigma = metrics.pop("_occ_sigma")
    rays = batch["rays"]
    pts = rays[:, None, 0:3] + rays[:, None, 3:6] * z[..., None]
    return occgrid.update_grid(occ_grid, pts, sigma, setup.rcfg.occ,
                               mesh), metrics


def make_occ_train_step(setup: TrainSetup,
                        mesh: Optional[pmesh.Mesh] = None):
    """The occupancy-grid train step: (state, grid, batch, generator,
    inputs=None) -> (state, grid, metrics).  The optimization of ``make_train_step`` with
    the coarse samples placed by the grid, then the grid updated from the
    step's own density evaluations.  Needs ``setup.rcfg.occ``; ``mesh``
    as in ``make_train_step``."""
    if setup.rcfg.occ is None:
        raise ValueError("make_occ_train_step needs setup.rcfg.occ")

    def step_fn(state: TrainState, occ_grid: occgrid.Grid, batch,
                generator=None, inputs: Optional[StepInputs] = None):
        batch, draws = _local(setup, batch, generator, mesh)
        state, metrics = _step_local(setup, mesh, state,
                                     dict(batch, occ_grid=occ_grid),
                                     generator, draws, inputs)
        occ_grid, metrics = apply_occ_update(setup, occ_grid, batch, metrics,
                                             mesh)
        return state, occ_grid, metrics

    return step_fn


def window_counters(state: TrainState) -> list:
    """The host integers a window of steps advances: the state's step
    and each optimizer's update count (``graph.Graphs``' counters)."""
    return [(state, "step")] + [(o, "count") for o in state.optimizers()]


def stage_window(feed, state: TrainState, n: int, **ints) -> None:
    """Fill ``feed`` (``graph.Feed``) for the next ``n`` steps of
    ``state``: each optimizer's rates, the step counts and ``ints`` (the
    feed's other rows, one value per step).  A ``window.stage`` span."""
    with profile.span("window.stage"):
        feed.fill([o.rates(n) for o in state.optimizers()],
                  step=range(state.step, state.step + n), **ints)


def _one_step(setup: TrainSetup, mesh, depth: bool) -> Callable:
    """One step of the flavour as (state, grid, batch, generator,
    inputs) -> (state, grid, metrics); the grid None without
    ``setup.rcfg.occ``."""
    if depth:
        step = make_depth_train_step(setup, mesh)

        def one(state, grid, batch, generator, inputs):
            if setup.rcfg.occ is None:
                state, metrics = step(state, batch, generator, inputs=inputs)
                return state, grid, metrics
            state, metrics = step(state, dict(batch, occ_grid=grid),
                                  generator, inputs=inputs)
            grid, metrics = apply_occ_update(
                setup, grid, pmesh.shard_batch(batch, mesh), metrics, mesh)
            return state, grid, metrics

        return one
    if setup.rcfg.occ is not None:
        return make_occ_train_step(setup, mesh)
    step = make_train_step(setup, mesh)

    def one(state, grid, batch, generator, inputs):
        state, metrics = step(state, batch, generator, inputs)
        return state, grid, metrics

    return one


class MultiTrainStep:
    """``n_inner`` optimization steps as one window (``make_multi_train_step``):
    ``window`` is its body, which the drivers run with their own batches
    through ``graph.Graphs``."""

    def __init__(self, setup: TrainSetup, n_inner: int,
                 mesh: Optional[pmesh.Mesh] = None, depth: bool = False):
        if n_inner < 1:
            raise ValueError(f"n_inner {n_inner} < 1")
        self.setup, self.n_inner, self.mesh = setup, n_inner, mesh
        self.one = _one_step(setup, mesh, depth)

    def window(self, state: TrainState, n: int, batch_of: Callable,
               generator: Optional[torch.Generator] = None, feed=None,
               occ_grid: Optional[occgrid.Grid] = None) -> Metrics:
        """The window body: ``n`` steps, step ``k`` on ``batch_of(k)``
        with row ``k`` of ``feed`` (``StepInputs.of``; None: the
        schedules and ``state.step``), the grid handed from step to step
        and the last one written into ``occ_grid`` in place.  Returns the
        last step's metrics."""
        grid = occ_grid
        for k in range(n):
            inputs = None if feed is None else StepInputs.of(feed, k)
            state, grid, metrics = self.one(state, grid, batch_of(k),
                                            generator, inputs)
        if occ_grid is not None:
            with torch.no_grad():
                for key, v in grid.items():
                    if v is not occ_grid[key]:
                        occ_grid[key].copy_(v)
        return metrics

def make_multi_train_step(setup: TrainSetup, n_inner: int,
                          mesh: Optional[pmesh.Mesh] = None,
                          depth: bool = False) -> MultiTrainStep:
    """Fuse ``n_inner`` optimization steps into one device program (port
    of the JAX package's ``make_multi_train_step``, which scans them with
    ``lax.scan``): on CUDA one replay of a CUDA graph per window
    (``train/graph.py``), on the CPU the same body run eagerly.

    The step is the NVS step of ``make_train_step`` (two Adams, or the
    joint one), the grid's of ``make_occ_train_step`` with
    ``setup.rcfg.occ``, or with ``depth`` the depth step of
    ``make_depth_train_step`` (the grid folded by ``apply_occ_update``
    after each step).  Its body is bit-equal to ``n_inner`` single steps,
    the draws included: the rates and the step count come from the
    host's schedules, staged per window.  ``mesh``: each step's
    collectives run inside the window, and a graph captures them with it
    (NCCL); every rank runs the same windows."""
    return MultiTrainStep(setup, n_inner, mesh, depth)
