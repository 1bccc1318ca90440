"""Training traffic: a closed loop of the NVS driver's dispatch windows.

The loop is the one ``cli/run_plnerf.run_training`` runs for a
``no_batching`` recipe at ``--steps_per_dispatch N`` and the driver's
defaults: each window of N steps of 1024 rays is ``MultiTrainStep.window``
(from ``make_multi_train_step``) run through ``graph.Graphs``, its
batches drawn on the device by ``batching.sample_one_image_batch`` from
one image of the scene per step.  The variant's first window runs
eagerly on the capture stream with its per-step values from the host,
its second is captured and replayed, every later one replayed, those
two with their values staged in a ``graph.Feed`` (``stage_window``).
After each window the host reads what the driver reads (``Loop.after``):
with the grid, past the advisory's grace step, ``occ_ray_frac``; every
``--i_print`` steps all the window's metrics.  Nothing else holds the
host back: it runs ahead of the card as far as those reads let it.

The state starts at step ``start_step`` (past ``constant_init``, the
precrop and the grid's warm-up): the linear quadrature, whole images,
and, with the grid, grid-guided samples, the grid updated every step.
Its weights are the seed's (``lib/scene.make_weights``), its Adam fresh;
its update count, which sets the rate, is ``start_step - 1``.

``correct``: the first window's first three steps, recorded as they run
(each step's loss, Adam's first moment after step one, the parameters
after step three, the colours step one rendered), and the second window,
the graph's first replay (its last step's loss, the parameters' change
over it), against the reference following the same two windows from the
same weights, grid, scene and generator state.

Traffic parameters (``traffic/<mix>.json``): ``steps_per_dispatch``,
``start_step``, ``checked_steps``, ``warm_windows`` (windows run before
the timed window, the capture's included), ``trace_s`` (the traced
slice's length, in whole windows).
"""
from __future__ import annotations

import dataclasses
import math
import time
from types import SimpleNamespace

import torch

from ..lib import draws
from ..lib import scene as S
from ..lib.trace import Session
from ..reference import check, nerf


class Recorder:
    """Wraps a window's step (``MultiTrainStep.one``) to keep what the
    first ``n`` steps leave: each step's loss, Adam's first moments after
    the first step and the parameters after the ``n``-th."""

    def __init__(self, state, n: int):
        self.state, self.n = state, n
        self.loss = []
        self.moment1 = self.params = None

    def _named(self):
        st = self.state
        return [(f"{net}.{k}", p, opt) for net, mod, opt in (
            ("coarse", st.params_coarse, st.opt_coarse),
            ("fine", st.params_fine, st.opt_fine))
            for k, p in mod.named_parameters()]

    def wrap(self, one):
        def step(*a):
            out = one(*a)
            k = len(self.loss)
            if k < self.n:
                self.loss.append(out[2]["loss"].detach().clone())
                if k == 0:
                    # no moment: the optimizer did not step
                    self.moment1 = {
                        n: opt.state[p].get("exp_avg", torch.zeros_like(p))
                        .detach().clone() for n, p, opt in self._named()}
                if k == self.n - 1:
                    self.params = {n: p.detach().clone()
                                   for n, p, _ in self._named()}
            return out
        return step

    def readings(self) -> dict:
        return {"loss": [float(x) for x in self.loss],
                "moment1": self.moment1, "params": self.params}


class Loop:
    """The driver's loop (``run_plnerf.run_training``) from the state's
    step on: ``window`` runs the next window as the driver runs it,
    ``after`` makes the host reads the driver makes after it."""

    def __init__(self, args, setup, rcfg, occ_cfg, state, grid, g, batch_of,
                 n_inner: int, start: int, dev):
        from plnerf_torch.cli import run_plnerf
        from plnerf_torch.train import graph
        from plnerf_torch.train.step import (make_multi_train_step,
                                             window_counters)

        self.drv, self.graph = run_plnerf, graph
        self.args, self.state, self.g, self.batch_of = args, state, g, batch_of
        self.n_inner, self.i = n_inner, start - 1
        self.ci = start < args.constant_init and rcfg.mode == "linear"
        self.precrop = start < args.precrop_iters

        def make(occ):
            return make_multi_train_step(dataclasses.replace(
                setup, rcfg=dataclasses.replace(
                    rcfg, constant_init=self.ci, occ=occ)), n_inner)
        self.make = make
        self.multi, self.grid = make(occ_cfg), grid
        # a fresh grid warms up for --occ_warmup steps from step 0
        self.warm_end = args.occ_warmup
        self.occ_warned = self.dead_warned = False
        self.feed = graph.Feed(n_inner, dev, len(state.optimizers()))
        self.graphs = graph.Graphs(dev, n_inner, window_counters(state), [g])
        self.t0, self.since_print = time.time(), 0

    @property
    def key(self):
        return (self.ci, self.grid is not None, self.precrop)

    def window(self):
        """The next window; returns its last step's metrics and its kind
        (``graph.Graphs.schedule``)."""
        from plnerf_torch.train.step import stage_window

        n, key, multi, grid = self.n_inner, self.key, self.multi, self.grid
        kind = self.graphs.schedule(key, n)
        staged = kind in self.graph.STAGED
        if staged:
            stage_window(self.feed, self.state, n)
        feed = self.feed if staged else None

        def body(k):
            return multi.window(self.state, k, self.batch_of, self.g, feed,
                                grid)
        self.graphs.prepare(key, body, n)
        with torch.profiler.record_function("portbench.window"):
            metrics = self.graphs.run(key, body, n)
        self.i += n
        self.since_print += n
        return metrics, kind

    def after(self, metrics) -> None:
        """The driver's reads of the window's metrics: ``occ_ray_frac``
        past the grace step until the advisory fires (its auto-fallback
        drops the grid, as the driver's default does), and every metric
        where a multiple of ``--i_print`` falls in the window (the
        driver's logger's file is left out)."""
        drv, args, i, n = self.drv, self.args, self.i, self.n_inner
        if (self.grid is not None and not self.occ_warned
                and i > self.warm_end + drv.OCC_ADVISORY_GRACE):
            frac_m = {"occ_ray_frac": float(metrics["occ_ray_frac"])}
            self.occ_warned = drv._occ_advisory(
                frac_m, i, self.warm_end, self.occ_warned,
                auto_fallback=not args.occ_keep_degenerate)
            if self.occ_warned and not args.occ_keep_degenerate:
                self.multi, self.grid = self.make(None), None
        if drv.fires(i, n, args.i_print):
            m = {k: float(v) for k, v in metrics.items()}   # host sync
            m["steps_per_sec"] = self.since_print / max(
                time.time() - self.t0, 1e-9)
            self.t0, self.since_print = time.time(), 0
            print(f"[TRAIN] Iter: {i} Loss: {m['loss']:.5f} "
                  f"PSNR: {m['psnr']:.2f} ({m['steps_per_sec']:.1f} it/s)")
            self.dead_warned = drv._dead_coarse_advisory(
                m, i, self.dead_warned, args.mode)

    def step(self):
        metrics, kind = self.window()
        self.after(metrics)
        return metrics, kind


def build(ctx):
    """The program's train objects for the cell, set up as the driver
    sets them up; returns a namespace of them."""
    marks = [time.perf_counter()]
    from plnerf_torch.cli import run_plnerf
    from plnerf_torch.device import make_generator
    from plnerf_torch.train import batching
    from plnerf_torch.train.step import init_state

    marks.append(time.perf_counter())
    dev, tr = ctx.device, ctx.traffic
    args = ctx.program_args()
    n_inner = int(tr["steps_per_dispatch"])
    start = int(tr["start_step"])
    _, rcfg, setup = run_plnerf.build_configs(args)
    occ_cfg = run_plnerf.occ_cfg_from_args(args)

    sync(dev)
    marks.append(time.perf_counter())
    sc = S.train_scene(ctx.scene, ctx.seed, dev)
    sync(dev)
    marks.append(time.perf_counter())
    weights = S.make_weights(ctx.flags, ctx.seed, dev)
    state = init_state(make_generator(S.sub_seed(ctx.seed, 3), dev), setup,
                       dev)
    state.params_coarse.load_state_dict(weights["coarse"])
    state.params_fine.load_state_dict(weights["fine"])
    state.step = start - 1
    for o in state.optimizers():
        o.count = start - 1
    grid = S.sphere_grid(ctx.flags, dev) if occ_cfg is not None else None
    prog_grid = (None if grid is None
                 else {k: v.clone() for k, v in grid.items()})
    g = S.generator(S.sub_seed(ctx.seed, 4), dev)
    images, poses, K = sc["images"], sc["poses"], sc["K"]
    n_train, H, W = images.shape[0], images.shape[1], images.shape[2]
    i_train = torch.arange(n_train, device=dev)
    R = int(args.N_rand)
    near, far = float(ctx.scene["near"]), float(ctx.scene["far"])
    precrop = start < args.precrop_iters

    def batch_of(k):
        ti, y, x = draws.batch(g, n_train, H, W, R, dev)
        rays, target, _ = batching.sample_one_image_batch(
            images, poses, K, i_train, g, R, near, far, rcfg.use_viewdirs,
            precrop, args.precrop_frac, draws=(ti, y, x))
        return {"rays": rays, "target": target}

    loop = Loop(args, setup, rcfg, occ_cfg, state, prog_grid, g, batch_of,
                n_inner, start, dev)
    sync(dev)
    marks.append(time.perf_counter())
    print("[build] " + ", ".join(
        f"{k} {b - a:.3f} s" for k, a, b in zip(
            ("imports", "configs and CUDA", "scene", "state"), marks,
            marks[1:])), flush=True)
    return SimpleNamespace(loop=loop, state=state, weights=weights,
                           grid=grid, prog_grid=prog_grid, g=g, scene=sc,
                           n_inner=n_inner, start=start, R=R)


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def checked_windows(ctx, b) -> dict:
    """Run the first two windows, each followed by the driver's host
    reads: the first (eager) with its first ``checked_steps`` recorded and
    the colours its first step rendered (both passes, as
    ``core/render.render_rays`` returned them); the second (on CUDA the
    capture, run as the graph's first replay) with its last step's loss
    and the parameters before and after it.  Returns the generator's
    state before them and the readings."""
    from plnerf_torch.core import render

    n = int(ctx.traffic["checked_steps"])
    gen_state = b.g.get_state().clone()
    rec = Recorder(b.state, n)
    multi, render_rays = b.loop.multi, render.render_rays
    one = multi.one
    rgb1 = []

    def first_render(*a, **kw):
        ret = render_rays(*a, **kw)
        if not rgb1:
            rgb1.append(torch.cat([ret["rgb_map"], ret["rgb0"]]).detach()
                        .clone())
        return ret
    multi.one, render.render_rays = rec.wrap(one), first_render
    try:
        b.loop.step()
    finally:
        multi.one, render.render_rays = one, render_rays

    def params():
        return {k: p.detach().clone() for k, p, _ in rec._named()}
    before = params()
    metrics, kind = b.loop.step()
    replay = {"kind": kind, "loss": float(metrics["loss"]),
              "before": before, "after": params()}
    return {"gen_state": gen_state,
            "prog": dict(rec.readings(), rgb1=rgb1[0], replay=replay)}


def follow(ctx, b, gen_state, prec: str = "fp32") -> dict:
    """The reference's two windows from the cell's inputs
    (``check.follow_train``), keeping the parameters after the checked
    steps and after each window."""
    n = int(ctx.traffic["checked_steps"])
    return check.follow_train(b.weights, b.grid, b.scene, gen_state,
                              ctx.ref_flags, b.start - 1, 2 * b.n_inner,
                              nerf.Precision(prec),
                              keep=(n, b.n_inner, 2 * b.n_inner))


def reference_gaps(ctx, b, first: dict, ref=None) -> dict:
    """The program's readings against the reference's
    (``check.train_gaps``)."""
    ref = ref or follow(ctx, b, first["gen_state"])
    p0 = {f"{net}.{k}": v for net in b.weights
          for k, v in b.weights[net].items()}
    return check.train_gaps(first["prog"], ref, p0,
                            int(ctx.traffic["checked_steps"]), b.n_inner)


def occ_share(grid) -> float:
    return float(grid["occ"].mean()) if grid is not None else math.nan


def run(ctx) -> dict:
    dev, tr = ctx.device, ctx.traffic
    t = [time.perf_counter()]
    b = build(ctx)
    loop = b.loop
    sync(dev)
    t.append(time.perf_counter())
    occ0 = occ_share(b.prog_grid)
    first = checked_windows(ctx, b)
    t.append(time.perf_counter())
    for _ in range(int(tr["warm_windows"]) - 1):
        loop.step()
    sync(dev)
    t.append(time.perf_counter())
    setup_s = t[-1] - ctx.t_start
    print(f"[setup] imports {t[0] - ctx.t_start:.3f} s, build {t[1] - t[0]:.3f}"
          f" s, first window and capture {t[2] - t[1]:.3f} s (second window "
          f"{first['prog']['replay']['kind']}), warm windows "
          f"{t[3] - t[2]:.3f} s", flush=True)

    # the timed window: the host clock around each window's call, the
    # driver's reads after it
    host, metrics = [], None
    t0 = time.perf_counter()
    deadline = t0 + ctx.seconds
    while time.perf_counter() < deadline:
        h0 = time.perf_counter()
        metrics, _ = loop.window()
        host.append(time.perf_counter() - h0)
        loop.after(metrics)
    sync(dev)
    wall = time.perf_counter() - t0
    steps = len(host) * b.n_inner

    summary, traced = None, 0
    if ctx.trace:
        per = wall / max(len(host), 1)
        traced = max(2, min(64, round(float(tr["trace_s"]) / per)))
        with Session(dev) as s:
            for _ in range(traced):
                loop.step()
        summary = s.summary
    loss = float(metrics["loss"]) if metrics is not None else math.nan
    ray_frac = (float(metrics["occ_ray_frac"])
                if metrics is not None and "occ_ray_frac" in metrics
                else math.nan)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    occ1 = occ_share(b.prog_grid)
    kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    print(f"[train] {steps} steps in {wall:.3f} s, loss {loss:.5f}, grid "
          f"occupied {occ0:.4f} -> {occ1:.4f}, occ_ray_frac {ray_frac:.4f}, "
          f"advisory {'fired' if loop.occ_warned else 'silent'}, graphs "
          f"{loop.graphs.captures} captures {loop.graphs.replays} replays",
          flush=True)
    # the program's state goes before the reference runs
    b.state = b.loop = b.prog_grid = loop = metrics = None
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    gaps = reference_gaps(ctx, b, first)
    R = b.R
    return {"e2e": {"train_rays_per_s": steps * R / wall,
                    "setup_s": setup_s},
            "obs": {"kind": "train", "flags": ctx.flags, "steps": steps,
                    "rays_per_step": R, "wall_s": wall,
                    "host_s": sum(host), "traced_steps": traced * b.n_inner,
                    "trace": summary},
            "checks": gaps, "attempted": steps,
            "failed": 0 if math.isfinite(loss) else steps,
            "memory_peak_bytes": int(peak), "device_kind": kind,
            "trace": summary}
