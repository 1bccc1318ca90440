"""PL-NeRF driver (port of ``plnerf/cli/run_plnerf.py``, the reference
``run_plnerf.py`` CLI):

    python -m plnerf_torch.cli.run_plnerf \\
        --config configs/blender_linear.txt \\
        --task train|test|test_fixed_dist|test_samples_error|video|\\
               export_serving \\
        [--render_only] [--device cpu] ...

* ``train``: two-Adam NVS training with the constant-quadrature warm-up,
  the precrop, both ray-batching policies (one image per step, or the
  shuffled ray pool; NDC rays for LLFF scenes), periodic checkpoints, val
  renders and test sets.
* ``test``: held-out views, PSNR / SSIM -> pngs and metrics.txt.
* ``test_fixed_dist``: the held-out views of ``--eval_data_dir`` /
  ``--eval_scene_id`` (a blender_fixeddist scene) at the four distances of
  ``FIXED_DIST_NEAR``, one ``test_images_dist{d}_{scene_id}`` folder each.
* ``test_samples_error``: the importance-sampling error of the held-out
  views, ``test_samples_error_{N_importance}/metrics_expecteddepth.txt``.
* ``video`` and ``--render_only`` (whatever the task): the camera path
  (``render_poses``, or the test views with ``--render_test``) at
  ``--render_factor``, frames in ``renderonly_{path|test}_{step:06d}``;
  ``--i_video`` renders it inside a training run.  The frames are PNGs
  (``eval/images.write_video``): the port encodes no mp4.
* ``export_serving``: the checkpoint under evaluation as a serving
  artifact (``serving/export.py``) in ``--serve_out`` (default
  ``<expname>/serving``), under the test task's render config;
  ``--serve_weights baked|args``, ``--serve_image HxW`` (a whole-batch
  module), ``--serve_platforms`` (only the run's device).  Needs no
  dataset.

``--occ_grid`` (``configs/blender_linear_occ.txt``): the coarse samples
are placed by an occupancy grid (``core/occgrid.py``) that the train step
updates from its own density evaluations.  A fresh grid warms up for
``--occ_warmup`` steps of uniform sampling from wherever training
(re)starts; a grid restored from the ``{step:06d}.occ`` sidecar of the
checkpoint it resumes from engages at once.  The sidecar is written with
every checkpoint, and every eval task renders with the grid of the
checkpoint it evaluates (a missing sidecar raises unless
``--occ_eval_fresh_grid``).  Past ``OCC_ADVISORY_GRACE`` guided steps a
mean occupied candidate-bin fraction above ``OCC_DEGENERATE_RAY_FRAC``
prints an advisory and drops the grid for the rest of the run (no more
sidecars), unless ``--occ_keep_degenerate``.

Datasets: llff, blender, blender2, blender_fixeddist, DTU, DTU2
(``cli/datasets.py``).  Runs on the CUDA device unless ``--device cpu`` is
given, and raises where there is none.  ``--ft_path`` may name a
checkpoint of the port, of the JAX package or a reference ``.tar``
(``checkpoint/io.py``).  Not ported yet, each refused with ``SystemExit``
naming its ROADMAP item: ``--profile`` (A17), ``--lpips_weights`` (A14).

Differences from the JAX driver:

* ``--use_kernel`` (for ``--use_pallas``): AUTO turns the fused CUDA MLP
  kernels on, with folded heads, whenever the device is CUDA, for training
  and for eval, in fp32 and bf16: on the H100 they beat the unfused
  library MLP in both passes (PERF.md).  The JAX driver turns its Pallas
  kernel on only for TPU bf16 training and strips it at eval.  On the CPU
  AUTO means off; ``--use_kernel`` there runs the kernels' plain versions.
* One step per loop iteration: ``--steps_per_dispatch`` (the JAX
  driver's scan of N steps in one program, whose only other effect is to
  round the cadences to windows of N) is parsed for config parity and
  refused above 1.  Cadences fire on the iterations where the JAX driver's
  fire at N = 1.
* ``test_samples_error`` renders NDC rays for LLFF scenes, as the
  reference's render_kwargs do; the JAX driver renders world-space rays
  there between NDC bounds (0, 1).
* Randomness comes from one ``torch.Generator`` seeded ``--seed``.  A
  resumed run reseeds it from ``--seed``, as the JAX driver draws from a
  fresh ``PRNGKey(seed)`` (run_plnerf.py:438): it does not continue the
  interrupted run's stream.
* An eval task's occupancy grid is the sidecar of the checkpoint it
  loaded: with ``--no_reload`` (the fresh init) a fresh grid, where the
  JAX driver reads the latest checkpoint's sidecar.
* The serving artifact runs the fused forward kernel under --use_kernel
  AUTO on CUDA (as an operator inside the exported program); the JAX
  driver strips Pallas from an export.  The artifact runs on the device
  it was exported on only.
* The degenerate-guidance guard reads ``occ_ray_frac`` (a host sync) only
  on the steps where it can fire, past the grace window; the JAX driver
  reads it after every dispatch window.  The decisions are the same.
"""
from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from ..checkpoint import io as ckio
from ..core import occgrid as og
from ..core.config import ModelConfig, RenderConfig
from ..device import make_generator, resolve_device
from ..eval import images as EI
from ..eval import metrics as Mx
from ..train import batching
from ..train.step import (TrainSetup, init_state, make_occ_train_step,
                          make_train_step)
from ..utils.logging import MetricsLogger
from .datasets import DatasetBundle, load_dataset
from .config import config_parser, resolve_args


def _resolve_kernel(args, device: torch.device) -> bool:
    """--use_kernel tri-state: True / False honour the explicit flag; None
    (AUTO, the default) is on exactly when the device is CUDA."""
    explicit = getattr(args, "use_kernel", None)
    if explicit is not None:
        return bool(explicit)
    return device.type == "cuda"


def build_configs(args, vanilla: bool = False):
    device = resolve_device(getattr(args, "device", None))
    mcfg = ModelConfig(
        netdepth=args.netdepth, netwidth=args.netwidth,
        use_viewdirs=args.use_viewdirs, multires=args.multires,
        multires_views=args.multires_views, i_embed=args.i_embed,
        sigma_bias_init=getattr(args, "sigma_bias_init", 0.0),
    )
    mcfg_fine = None
    if (args.netdepth_fine != args.netdepth
            or args.netwidth_fine != args.netwidth):
        mcfg_fine = dataclasses.replace(mcfg, netdepth=args.netdepth_fine,
                                        netwidth=args.netwidth_fine)
    kernel = _resolve_kernel(args, device)
    rcfg = RenderConfig(
        n_samples=args.N_samples, n_importance=args.N_importance,
        mode=args.mode,
        color_mode=args.color_mode, lindisp=args.lindisp,
        perturb=args.perturb > 0.0, use_viewdirs=args.use_viewdirs,
        white_bkgd=args.white_bkgd, raw_noise_std=args.raw_noise_std,
        farcolorfix=getattr(args, "farcolorfix", False),
        zero_tol=args.zero_tol, epsilon=args.epsilon,
        mlp_dtype=getattr(args, "mlp_dtype", "float32"),
        # the folded-head schedule is the kernel being on
        use_fused_mlp=kernel, fused_fold_heads=kernel,
        remat_mlp=getattr(args, "remat", False),
    )
    setup = TrainSetup(
        mcfg=mcfg, mcfg_fine=mcfg_fine, rcfg=rcfg, lrate=args.lrate,
        coarse_lrate=args.coarse_lrate, lrate_decay=args.lrate_decay,
        joint_optimizer=vanilla,
        accum_chunks=max(1, getattr(args, "grad_accum", 1)),
    )
    return mcfg, rcfg, setup


def exp_dir(args) -> str:
    return os.path.join(args.ckpt_dir, args.expname)


def restore_or_init(args, setup: TrainSetup, device: torch.device):
    """Returns ``(state, start, path)``: a fresh state seeded ``--seed``,
    restored from ``--ft_path`` or, unless ``--no_reload``, the
    experiment's latest checkpoint when there is one; ``path`` is the file
    restored (its sidecars sit beside it), None for the fresh state."""
    state = init_state(make_generator(args.seed, device), setup, device)
    path = args.ft_path
    if not path and not args.no_reload:
        path = ckio.latest_checkpoint(exp_dir(args))
    if path and os.path.exists(path):
        ckio.restore_checkpoint(path, state, device)
        print(f"Resumed from {path} at step {state.step}")
        return state, state.step, path
    return state, 0, None


def occ_cfg_from_args(args):
    """The ``OccGridConfig`` of the --occ_* flags, or None without
    --occ_grid."""
    if not getattr(args, "occ_grid", False):
        return None
    return og.OccGridConfig(
        resolution=args.occ_res, candidates=args.occ_candidates,
        decay=args.occ_decay, threshold=args.occ_threshold,
        floor=args.occ_floor, warmup=args.occ_warmup)


def load_occ_grid(args, occ_cfg, ckpt_path, device):
    """``(grid, missing)``: the ``.occ`` sidecar grid of the checkpoint
    ``ckpt_path``, else a fresh grid over ``--occ_bound``; ``missing`` is
    the sidecar's path when ``ckpt_path`` has none (None without a
    checkpoint)."""
    b = float(args.occ_bound)
    grid = og.init_grid([-b, -b, -b], [b, b, b], occ_cfg, device)
    if ckpt_path is None:
        return grid, None
    gp = ckio.aux_path(ckpt_path, "occ")
    if not os.path.exists(gp):
        return grid, gp
    return ckio.restore_aux(gp, grid, device), None


def occ_for_eval(args, ckpt_path, device):
    """``(occ_cfg, grid)`` for an eval task (both None without
    --occ_grid): the sidecar grid beside ``ckpt_path``, the checkpoint
    under evaluation.  A model trained grid-guided is scored under the
    sample distribution it trained with, so a checkpoint without a sidecar
    raises ``FileNotFoundError`` unless --occ_eval_fresh_grid; the fresh
    init (no checkpoint) gets a fresh grid."""
    occ_cfg = occ_cfg_from_args(args)
    if occ_cfg is None:
        return None, None
    grid, missing = load_occ_grid(args, occ_cfg, ckpt_path, device)
    if missing and getattr(args, "occ_eval_fresh_grid", False):
        print("WARNING: --occ_grid eval but no sidecar grid at", missing,
              "— using a fresh (uniform) grid (--occ_eval_fresh_grid)")
    elif missing:
        raise FileNotFoundError(
            f"--occ_grid eval: no sidecar grid at {missing}. The model "
            "under evaluation was loaded from a checkpoint without a "
            "trained occupancy grid; evaluating it grid-guided with a fresh "
            "all-occupied grid would mis-score it. Pass "
            "--occ_eval_fresh_grid to do that deliberately, or drop "
            "--occ_grid to evaluate with uniform sampling.")
    return occ_cfg, grid


def occ_train_grid(args, occ_cfg, ckpt_path, start, device):
    """``(grid, warm_end)`` for a training run: the sidecar grid of the
    checkpoint it resumes from engages once past the absolute warm-up
    step; a fresh grid warms up for --occ_warmup steps from ``start``."""
    grid, missing = load_occ_grid(args, occ_cfg, ckpt_path, device)
    if missing:
        print(f"WARNING: resuming --occ_grid run but no sidecar grid at "
              f"{missing} — starting a fresh grid with a new "
              f"{args.occ_warmup}-step warmup")
    restored = ckpt_path is not None and missing is None
    return grid, args.occ_warmup + (0 if restored else start)


# ---------------------------------------------------------------------------
# train
# ---------------------------------------------------------------------------

# Dead-coarse advisory: sigma0_pos_frac reads exactly 0.0 when every raw
# coarse density is negative, so relu kills every density gradient and the
# coarse geometry can never recover (the JAX package's "dead-coarse
# anatomy", BASELINE.md).  Healthy coarse nets read ~0.15 in-volume.  The
# grace window clears init transients and the constant_init warm window.
DEAD_COARSE_POS_FRAC = 1e-3
DEAD_COARSE_GRACE = 3000


# Degenerate-guidance guard: a mean occupied fraction of candidate bins
# along the training rays above this means the grid cannot skip enough
# empty space (slab-like or forward-facing geometry crosses most rays), and
# the reduced sample count trains worse than uniform sampling at the full
# count (the JAX package's occ A/B, BASELINE.md: -1.7 dB on its slab
# fixture; healthy object-centric scenes read ~0.10 there).
OCC_DEGENERATE_RAY_FRAC = 0.35
# Guided steps before the guard arms: a fresh grid starts all-occupied and
# an empty visited voxel carves in ~7 observations, so every scene reads
# "degenerate" while the EMA converges.
OCC_ADVISORY_GRACE = 2048


def _occ_advisory(m: dict, step: int, warm_end: int, warned: bool,
                  auto_fallback: bool = False) -> bool:
    """Print a one-time advisory when guided sampling is degenerate past
    the grace window; returns whether it has fired.  ``auto_fallback``
    says that the caller drops the grid."""
    frac = m.get("occ_ray_frac")
    if (warned or frac is None or frac <= OCC_DEGENERATE_RAY_FRAC
            or step <= warm_end + OCC_ADVISORY_GRACE):
        return warned
    print("=" * 72)
    print(f"WARNING: occupancy-grid guidance is DEGENERATE at iter {step}: "
          f"{frac:.0%} of candidate bins along training rays are occupied "
          f"(> {OCC_DEGENERATE_RAY_FRAC:.0%}; healthy object-centric scenes "
          "measure ~10%).")
    print("The grid cannot skip enough empty space on this scene, so "
          "--occ_grid only spreads the reduced sample count thinner.")
    if auto_fallback:
        print("AUTO-FALLBACK: grid guidance is now DISABLED for the rest of "
              "this run: training continues with uniform stratified "
              "sampling at the configured --N_samples, no further .occ "
              "sidecars are written, and eval tasks on the resulting "
              "checkpoints must run without --occ_grid. Pass "
              "--occ_keep_degenerate to keep guidance.")
    else:
        print("Re-run without --occ_grid (or with the full uniform "
              "--N_samples) unless depth supervision is active, which "
              "closes the gap.")
    print("=" * 72)
    return True


def _dead_coarse_advisory(m: dict, step: int, warned: bool,
                          mode: str) -> bool:
    """Print a loud one-time advisory when the coarse density head has
    gone fully negative (the dead-relu trap)."""
    frac = m.get("sigma0_pos_frac")
    if (warned or frac is None or frac >= DEAD_COARSE_POS_FRAC
            or step <= DEAD_COARSE_GRACE):
        return warned
    print("=" * 72)
    print(f"WARNING: the COARSE density head is dead at iter {step}: "
          f"{frac:.1%} of its raw densities are positive, so relu zeroes "
          "every density gradient and the coarse geometry cannot recover.")
    if mode == "constant":
        print("In constant mode this is the paper's zero-gradient trap: "
              "the coarse has NO live gradient, importance sampling "
              "degrades to quasi-uniform, and fine-level quality can "
              "suffer badly.")
    else:
        print("In linear mode color gradients survive through the forced "
              "far-boundary interval (the coarse renders a billboard "
              "pinned at far), but every importance sample collapses "
              "into that final interval: hierarchical sampling is "
              "contributing nothing.")
    print("Mitigations: RESTART with --raw_noise_std 1e0 (the reference's "
          "own llff recipe) or with a different --seed; resuming a dead "
          "run does not save it.  In linear mode, never set "
          "--constant_init 0: the constant warm-up protects the coarse.")
    print("=" * 72)
    return True


def run_training(args, bundle: DatasetBundle, setup: TrainSetup,
                 mcfg: ModelConfig, rcfg: RenderConfig):
    """The train loop; returns the final ``TrainState``."""
    device = resolve_device(args.device)
    data = bundle.data
    state, start, ckpt_path = restore_or_init(args, setup, device)
    logger = MetricsLogger(exp_dir(args))

    use_batching = not args.no_batching
    n_rand = args.N_rand
    n_iters = args.num_iterations
    g = make_generator(args.seed, device)
    near, far = bundle.near, bundle.far
    occ_cfg = occ_cfg_from_args(args)
    occ_state, occ_warm_end = None, 0
    if occ_cfg is not None:
        occ_state, occ_warm_end = occ_train_grid(args, occ_cfg, ckpt_path,
                                                 start, device)

    def make_step(const_init: bool, occ_on: bool):
        s = dataclasses.replace(setup, rcfg=dataclasses.replace(
            rcfg, constant_init=const_init, occ=occ_cfg if occ_on else None))
        return make_occ_train_step(s) if occ_on else make_train_step(s)

    # one step function per quadrature phase (constant_init on / off) and,
    # with the grid, per grid phase (warm-up / guided)
    steps = {(ci, oc): make_step(ci, oc) for ci in (True, False)
             for oc in ((False, True) if occ_cfg is not None else (False,))}

    ev_chunk = training_eval_chunk(args, 0)   # no_batching: no pool
    if use_batching:
        t_pool = time.time()
        pool = torch.as_tensor(batching.build_ray_pool(
            np.asarray(data.images, np.float32), np.asarray(data.poses),
            data.K, bundle.i_train, seed=args.seed, ndc=bundle.ndc,
            focal=float(data.hwf[2])), device=device)
        if pool.shape[0] < n_rand:
            raise ValueError(f"the ray pool holds {pool.shape[0]} rays, "
                             f"fewer than --N_rand {n_rand}")
        print(f"[pool] built {pool.shape[0]:,} rays in "
              f"{time.time() - t_pool:.1f} s")
        ev_chunk = training_eval_chunk(args, pool.numel() * 4)
        i_batch = 0
    else:
        # on the device once, before the loop
        images = torch.as_tensor(np.asarray(data.images, np.float32),
                                 device=device)
        poses = torch.as_tensor(np.asarray(data.poses, np.float32)[:, :3, :4],
                                device=device)
        K = torch.as_tensor(np.asarray(data.K, np.float32), device=device)
        i_train = torch.as_tensor(np.asarray(bundle.i_train), device=device)

    t0 = time.time()
    steps_since_print = 0
    dead_warned = occ_warned = False
    for i in range(start + 1, n_iters + 1):
        # the phases of step i, as the reference picks them
        occ_on = occ_cfg is not None and i > occ_warm_end
        step_fn = steps[(i < args.constant_init and rcfg.mode == "linear",
                         occ_on)]
        if use_batching:
            rays, target = batching.pool_batch(
                pool, i_batch, n_rand, near, far, rcfg.use_viewdirs)
            i_batch += n_rand
        else:
            rays, target, _ = batching.sample_one_image_batch(
                images, poses, K, i_train, g, n_rand, near, far,
                rcfg.use_viewdirs, i < args.precrop_iters, args.precrop_frac,
                ndc=bundle.ndc, focal=float(data.hwf[2]))
        batch = {"rays": rays, "target": target}
        if occ_on:
            state, occ_state, metrics = step_fn(state, occ_state, batch, g)
        else:
            state, metrics = step_fn(state, batch, g)
        if use_batching and pool.shape[0] - i_batch < n_rand:
            # every full batch of the epoch is consumed before the
            # reshuffle (run_plnerf.py:1244-1248 of the reference)
            pool = pool[torch.randperm(pool.shape[0], generator=g,
                                       device=device)]
            i_batch = 0
        steps_since_print += 1

        if (occ_on and not occ_warned
                and i > occ_warm_end + OCC_ADVISORY_GRACE):
            frac_m = {"occ_ray_frac": float(metrics["occ_ray_frac"])}
            occ_warned = _occ_advisory(
                frac_m, i, occ_warm_end, occ_warned,
                auto_fallback=not args.occ_keep_degenerate)
            if occ_warned:
                # the acting signal, logged at the step it fired
                logger.scalars(i, {**frac_m, "occ_auto_fallback": float(
                    not args.occ_keep_degenerate)}, prefix="train/")
                if not args.occ_keep_degenerate:
                    # uniform steps from here on, no grid updates or
                    # sidecars; later eval tasks see no grid
                    occ_cfg = occ_state = None

        if i % args.i_print == 0:
            m = {k: float(v) for k, v in metrics.items()}   # host sync
            m["steps_per_sec"] = steps_since_print / max(
                time.time() - t0, 1e-9)
            t0 = time.time()
            steps_since_print = 0
            logger.scalars(i, m, prefix="train/")
            print(f"[TRAIN] Iter: {i} Loss: {m['loss']:.5f} "
                  f"PSNR: {m['psnr']:.2f} ({m['steps_per_sec']:.1f} it/s)")
            dead_warned = _dead_coarse_advisory(m, i, dead_warned,
                                                args.mode)
            if args.debug:
                bad = [k for k, v in m.items() if not np.isfinite(v)]
                if bad:
                    raise FloatingPointError(
                        f"[Numerical Fail] non-finite metrics at iter {i}: "
                        f"{bad} (reference DEBUG scan, run_plnerf.py:754)")

        if i % args.i_weights == 0:
            save_checkpoint(args, state, occ_state)

        if i % args.i_img == 0 and len(bundle.i_val) > 0:
            vi = int(bundle.i_val[(i // args.i_img) % len(bundle.i_val)])
            out = _oom_retry(lambda c: EI.render_image(
                state.params_coarse, state.params_fine, data.poses[vi],
                data.hwf, data.K, mcfg,
                EI.test_render_config(rcfg, occ=occ_cfg), near=near,
                far=far, chunk=c, ndc=bundle.ndc, mcfg_fine=setup.mcfg_fine,
                occ_grid=occ_state), ev_chunk)
            val_mse = float(np.mean(
                (out["rgb_map"] - np.asarray(data.images[vi])) ** 2))
            logger.scalars(i, {"mse": val_mse, "psnr": Mx.mse2psnr(val_mse)},
                           prefix="val/")
            logger.image(i, "val/rgb", np.clip(out["rgb_map"], 0, 1))

        if i % args.i_testset == 0 and i < n_iters:
            _oom_retry(lambda c: run_test(
                args, bundle, mcfg, rcfg, state=state, suffix=f"_{i:06d}",
                setup=setup, chunk=c, occ=(occ_cfg, occ_state)), ev_chunk)

        if i % args.i_video == 0 and i < n_iters:
            _oom_retry(lambda c: run_video(
                args, bundle, mcfg, rcfg, setup, state=state, step=i,
                chunk=c, occ=(occ_cfg, occ_state)), ev_chunk)

    save_checkpoint(args, state, occ_state)
    logger.close()
    print("Training complete.")
    return state


def save_checkpoint(args, state, occ_state=None) -> str:
    """The state's checkpoint and, with a grid, its ``.occ`` sidecar."""
    path = ckio.save_checkpoint(exp_dir(args), state.step, state.state_dict())
    if occ_state is not None:
        ckio.save_aux(path, "occ", occ_state)
    print("Saved checkpoint at", path)
    return path


# ---------------------------------------------------------------------------
# eval
# ---------------------------------------------------------------------------

def training_eval_chunk(args, pool_bytes: int) -> int:
    """Ray chunk for in-training eval renders (i_img / i_testset).  These
    share device memory with the resident ray pool and the train state; an
    explicit --eval_chunk always wins, otherwise the default chunk is
    shrunk to 8192 once the pool passes 1 GB (the post-training eval task
    never shrinks: no pool is resident there)."""
    ev = getattr(args, "eval_chunk", None)
    if ev:
        return ev
    if pool_bytes > 1e9 and args.chunk > 8192:
        print(f"[eval] shrinking in-training eval chunk {args.chunk} -> "
              f"8192 (ray pool holds {pool_bytes / 1e9:.1f} GB of device "
              "memory; override with --eval_chunk)")
        return 8192
    return args.chunk


def _oom_retry(render_fn, chunk: int, min_chunk: int = 1024):
    """Run ``render_fn(chunk)``, halving the chunk while the device runs
    out of memory, down to ``min_chunk``."""
    while True:
        try:
            return render_fn(chunk)
        except torch.cuda.OutOfMemoryError:
            if chunk <= min_chunk:
                raise
        # outside the handler, so the failed attempt's tensors are freed
        chunk = max(min_chunk, chunk // 2)
        torch.cuda.empty_cache()
        print(f"[eval] out of device memory: retrying at chunk {chunk}")


def eval_render_config(args, rcfg: RenderConfig,
                       occ_cfg=None) -> RenderConfig:
    """Eval-task RenderConfig: the reference quirk (perturb forced back to
    True at test, run_plnerf.py:497-499, ``test_render_config``), then
    --eval_det, which must come after it; ``occ_cfg`` the grid's.  The
    kernel setting is kept."""
    ov = {"perturb": False} if getattr(args, "eval_det", False) else {}
    return EI.test_render_config(rcfg, occ=occ_cfg, **ov)


def _state_for_eval(args, setup):
    """``(state, occ_cfg, grid)``: the checkpoint under evaluation and its
    grid (``occ_for_eval``)."""
    device = resolve_device(args.device)
    state, start, path = restore_or_init(args, setup, device)
    if start == 0 and not args.no_reload:
        print("WARNING: no checkpoint found — evaluating fresh init")
    return (state,) + occ_for_eval(args, path, device)


def run_test(args, bundle, mcfg, rcfg, state=None, suffix: str = "",
             setup=None, chunk=None, occ=(None, None)):
    """Render and score the test split; writes the images and metrics.txt
    and returns the ``MeanTracker``.  Without ``state``, the checkpoint
    under evaluation and its grid; with it, ``occ`` is (occ_cfg, grid)."""
    if state is None:
        state, *occ = _state_for_eval(args, setup)
    occ_cfg, occ_grid = occ
    mean_metrics, res = EI.render_images_with_metrics(
        state.params_coarse, state.params_fine, bundle.data, bundle.i_test,
        mcfg, eval_render_config(args, rcfg, occ_cfg),
        chunk=chunk or args.chunk, near=bundle.near, far=bundle.far,
        ndc=bundle.ndc, mcfg_fine=setup.mcfg_fine if setup else None,
        occ_grid=occ_grid)
    result_dir = os.path.join(
        exp_dir(args),
        f"test_images_{args.mode}_{args.N_samples}_{args.N_importance}"
        f"{args.scene_id}{suffix}",
    )
    EI.write_images_with_metrics(res, mean_metrics, result_dir)
    return mean_metrics


# the reference's multi-distance sweep: dist -> near plane
FIXED_DIST_NEAR = {0.25: 1e-4, 0.5: 0.5, 0.75: 1.0, 1.0: 2.0}


def run_test_fixed_dist(args, mcfg, rcfg, setup):
    """Score the checkpoint on the held-out views of the blender_fixeddist
    scene ``--eval_data_dir`` / ``--eval_scene_id`` at each distance of
    ``FIXED_DIST_NEAR``, with its near plane; returns {dist:
    MeanTracker}."""
    import copy

    state, occ_cfg, occ_grid = _state_for_eval(args, setup)
    out = {}
    for test_dist, near in FIXED_DIST_NEAR.items():
        eval_args = copy.copy(args)
        eval_args.dataset = "blender_fixeddist"
        eval_args.data_dir = args.eval_data_dir
        eval_args.scene_id = args.eval_scene_id
        eval_args.test_dist = test_dist
        eval_args.set_near_plane = near
        bundle = load_dataset(eval_args)
        mean_metrics, res = EI.render_images_with_metrics(
            state.params_coarse, state.params_fine, bundle.data,
            bundle.i_test, mcfg, eval_render_config(args, rcfg, occ_cfg),
            chunk=args.chunk, near=near, far=bundle.far,
            mcfg_fine=setup.mcfg_fine, occ_grid=occ_grid)
        EI.write_images_with_metrics(res, mean_metrics, os.path.join(
            exp_dir(args), f"test_images_dist{test_dist}_{args.scene_id}"))
        print(f"[fixed_dist {test_dist}] psnr="
              f"{mean_metrics.get('psnr'):.3f}")
        out[test_dist] = mean_metrics
    return out


def run_test_samples_error(args, bundle, mcfg, rcfg, setup):
    """The importance-sampling error of the held-out views, written to
    ``test_samples_error_{N_importance}/metrics_expecteddepth.txt``;
    returns the ``MeanTracker``."""
    state, occ_cfg, occ_grid = _state_for_eval(args, setup)
    return EI.test_images_samples(
        state.params_coarse, state.params_fine, bundle.data, bundle.i_test,
        mcfg, eval_render_config(args, rcfg, occ_cfg),
        os.path.join(exp_dir(args),
                     f"test_samples_error_{args.N_importance}"),
        chunk=args.chunk, mcfg_fine=setup.mcfg_fine, ndc=bundle.ndc,
        occ_grid=occ_grid)


def run_video(args, bundle, mcfg, rcfg, setup, state=None, step=None,
              chunk=None, occ=(None, None)):
    """Render the camera path (``render_poses``; with --render_test the
    test views) into ``renderonly_{path|test}_{step:06d}``: the frames
    ``{i:03d}.png`` and ``write_video``'s ``video/{i:03d}.png``.  Returns
    the rgbs [N, H, W, 3].  Without ``state``, the checkpoint under
    evaluation, its step and its grid; with it, ``step`` and ``occ`` =
    (occ_cfg, grid)."""
    if state is None:
        state, *occ = _state_for_eval(args, setup)
        step = state.step
    occ_cfg, occ_grid = occ
    data = bundle.data
    poses = (np.asarray(data.poses)[bundle.i_test] if args.render_test
             else np.asarray(data.render_poses))
    savedir = os.path.join(exp_dir(args), "renderonly_{}_{:06d}".format(
        "test" if args.render_test else "path", step))
    rgbs, _, _ = EI.render_path(
        state.params_coarse, state.params_fine, poses, data.hwf, data.K,
        mcfg, eval_render_config(args, rcfg, occ_cfg), near=bundle.near,
        far=bundle.far, chunk=chunk or args.chunk, savedir=savedir,
        render_factor=args.render_factor, ndc=bundle.ndc,
        mcfg_fine=setup.mcfg_fine, occ_grid=occ_grid)
    EI.write_video(os.path.join(savedir, "video.mp4"), rgbs, fps=30)
    print("Done rendering", savedir)
    return rgbs


# ---------------------------------------------------------------------------

def run_export_serving(args, mcfg, rcfg, setup):
    """--task export_serving: export the checkpoint under evaluation (and
    its grid) into a serving artifact (``serving/export.py``) on the run's
    device, under the eval task's render config (``eval_render_config``:
    the perturb quirk, --eval_det, --eval_N_*).  ``--serve_platforms``
    may name only that device (``_refuse_unported``).  Returns the
    manifest."""
    from ..serving import export as sexport

    platforms = args.serve_platforms.split(",") if args.serve_platforms \
        else None
    state, occ_cfg, occ_grid = _state_for_eval(args, setup)
    out_dir = args.serve_out or os.path.join(exp_dir(args), "serving")
    fused_n = None
    if args.serve_image:
        h, w = (int(x) for x in args.serve_image.lower().split("x"))
        fused_n = h * w
    manifest = sexport.export_renderer(
        state.params_coarse, state.params_fine, mcfg,
        eval_render_config(args, rcfg, occ_cfg), out_dir, chunk=args.chunk,
        mcfg_fine=setup.mcfg_fine, occ_grid=occ_grid, platforms=platforms,
        fused_n_rays=fused_n, weights_mode=args.serve_weights,
        provenance={"expname": args.expname, "step": int(state.step),
                    "mode": args.mode, "N_samples": args.N_samples,
                    "N_importance": args.N_importance,
                    # the geometry a client needs to build rays as the
                    # model was trained (the artifact takes packed rays)
                    "dataset": args.dataset,
                    "ndc": bool(args.dataset == "llff"
                                and not getattr(args, "no_ndc", False)),
                    "set_near_plane": getattr(args, "set_near_plane",
                                              None)})
    print(f"Exported serving artifact to {out_dir} "
          f"(platforms={manifest['platforms']}, chunk={manifest['chunk']}, "
          f"outputs={manifest['output_keys']})")
    return manifest


# ---------------------------------------------------------------------------

TASKS = ("train", "test", "test_fixed_dist", "test_samples_error", "video",
         "export_serving")


def _refuse_unported(args) -> None:
    """Refuse, before anything is read or written, what is not ported and
    what cannot run: an export for a device other than the run's."""
    if args.task == "export_serving" and args.serve_platforms:
        dev = resolve_device(args.device).type
        if any(p != dev for p in args.serve_platforms.split(",")):
            raise SystemExit(
                f"--serve_platforms {args.serve_platforms}: the artifact "
                f"runs only on the device it is exported on ({dev}); pass "
                "--device to choose it")
    if args.profile:
        raise SystemExit("--profile: not ported yet (ROADMAP A17; "
                         "plnerf_torch.tools.profile_step profiles a step)")
    if args.lpips_weights:
        raise SystemExit("--lpips_weights: LPIPS is not ported yet "
                         "(ROADMAP A14)")
    if args.steps_per_dispatch > 1:
        raise SystemExit(f"--steps_per_dispatch {args.steps_per_dispatch}: "
                         "the port runs one step per loop iteration; only 1 "
                         "is accepted")
    if args.task not in TASKS:
        raise SystemExit(f"Unknown task {args.task}")


def run(args, vanilla: bool = False):
    """Run ``args.task``; returns the final ``TrainState`` (train), the
    metrics' ``MeanTracker`` (test, test_samples_error), {dist:
    MeanTracker} (test_fixed_dist), the frames (video, --render_only) or
    the artifact's manifest (export_serving)."""
    _refuse_unported(args)
    if args.task != "train":
        # eval-time sample-budget override; mutating args keeps rcfg and
        # the test_images_<mode>_<Ns>_<Ni> result-dir naming consistent
        if getattr(args, "eval_N_samples", None):
            args.N_samples = args.eval_N_samples
        if getattr(args, "eval_N_importance", None):
            args.N_importance = args.eval_N_importance
    mcfg, rcfg, setup = build_configs(args, vanilla=vanilla)
    if args.task == "test_fixed_dist":
        return run_test_fixed_dist(args, mcfg, rcfg, setup)
    if args.task == "export_serving":
        return run_export_serving(args, mcfg, rcfg, setup)
    bundle = load_dataset(args)
    if args.render_only or args.task == "video":
        return run_video(args, bundle, mcfg, rcfg, setup)
    if args.task == "train":
        return run_training(args, bundle, setup, mcfg, rcfg)
    if args.task == "test_samples_error":
        return run_test_samples_error(args, bundle, mcfg, rcfg, setup)
    return run_test(args, bundle, mcfg, rcfg, setup=setup)


def main(argv=None, vanilla: bool = False):
    """Parse ``argv``; before anything is read or written, resolve the
    device (raises without CUDA unless ``--device cpu``) and refuse what is
    not ported; then run (which checks the args.json-merged flags again)."""
    args = config_parser().parse_args(argv)
    resolve_device(args.device)
    _refuse_unported(args)
    args = resolve_args(args)
    if vanilla:
        args.constant_init = 0  # vanilla has no warmup
    return run(args, vanilla=vanilla)


if __name__ == "__main__":
    main()
