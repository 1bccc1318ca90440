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
(``checkpoint/io.py``).  The eval tasks score LPIPS with
``--lpips_weights`` (else ``$PLNERF_LPIPS_WEIGHTS``, else
``weights/lpips_alex.npz``; without a file metrics.txt notes it as
UNAVAILABLE).  ``--profile N`` traces at least N training steps with
``torch.profiler`` into ``<expname>/profile/`` and prints the top device
ops: it starts at the first window that begins past the third step and
stops at the end of the window that holds the N-th traced step.  Each
window is a ``window`` span of the trace (``train/graph.WINDOW_SPAN``,
from its launch), its staging a ``window.stage`` span.  Each ``[TRAIN]``
line also gives, since the previous one, the host ms per step of staging
and launching the windows, the card's idle share and the host span with
the most of its idle time (``train/graph.window_report``).

Data parallelism (``parallel/mesh.py``):

    torchrun --nproc_per_node N -m plnerf_torch.cli.run_plnerf --config ...

runs one process per card: every rank draws the same global batch of
``--N_rand`` rays (which must divide by N) and trains on its rows, the
gradients averaged by one all-reduce per step; eval renders, the density
grid and videos split their chunks over the ranks.  Rank 0 writes the
checkpoints, ``metrics.jsonl``, val renders, test sets, videos and the
profile, and prints; every rank reads a checkpoint to resume.

Differences from the JAX driver:

* ``--use_kernel`` (for ``--use_pallas``): AUTO turns the fused CUDA MLP
  kernels on, with folded heads, whenever the device is CUDA, for training
  and for eval, in fp32 and bf16: on the H100 they beat the unfused
  library MLP in both passes (PERF.md).  The JAX driver turns its Pallas
  kernel on only for TPU bf16 training and strips it at eval.  On the CPU
  AUTO means off; ``--use_kernel`` there runs the kernels' plain versions.
* ``--steps_per_dispatch N``: as the JAX driver fuses N sample-and-step
  iterations into one device program (``lax.scan``), the port runs every
  full window of N steps on CUDA as one replay of a CUDA graph
  (``train/graph.py``), one graph per phase (``constant_init``, the
  precrop, the grid's warm-up), captured at its second full window (the
  first runs eagerly on the capture stream and builds what the capture
  needs).  A variant that comes back after another was captured (the
  uniform phase, when the occupancy advisory drops the grid) is captured
  anew.  A shorter window runs the same body eagerly, as every window
  does on the CPU, where N changes nothing but the cadences.  Under
  ``torchrun`` each rank captures and replays the same windows, the
  all-reduce inside them, as the JAX driver's sharded window holds its
  psum.  No step of a window
  reads anything back from the device: a window that captures or replays
  reads the host's per-step values (the rates, the step count, the pool
  offsets) from device buffers staged before it, an eager one takes them
  from the host as N = 1 does.  The window is cut as the JAX driver cuts
  it: never across a phase boundary, and in pool mode at the end of the
  epoch's full batches, the reshuffle (in place) between windows.  The
  cadences (``i_print``, ``i_weights``, ``i_img``, ``i_testset``,
  ``i_video``) fire at the last step of a window that holds a multiple
  of their period, and the logged metrics are that step's.  A window draws from the generator in the
  order of N single steps (a graph replays its draws from the
  generator's state), so N changes no number; the JAX driver's fused
  windows draw from keys split per window.  ``--remat`` is captured too:
  its recomputation keeps no RNG state, since the MLP draws nothing.
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
* The degenerate-guidance guard reads ``occ_ray_frac`` (a host sync) at
  the end of a window only where it can fire, past the grace window; the
  JAX driver reads it after every window.  The decisions are the same.
* The JAX driver takes every device by itself (``get_mesh``); the port
  spreads over several only under ``torchrun``, and on a machine with
  several cards without it prints one line naming ``torchrun``.
  ``--no_mesh`` under a launch of more than one process is refused.
* The fused kernels stay on under data parallelism: each rank runs them
  on its own rows.  The JAX driver turns AUTO Pallas off under a mesh,
  since GSPMD cannot partition a Mosaic call.
* Eval renders under data parallelism equal the one-device renders bit for
  bit (chunk ``i`` keeps its seed on whichever rank renders it); the JAX
  driver's sharded renders fold the mesh axis index into each chip's key.
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
from ..eval.lpips import load_lpips
from ..parallel import mesh as pmesh
from ..train import batching, graph
from ..train.step import (TrainSetup, init_state, make_multi_train_step,
                          stage_window, window_counters)
from ..utils import profile as uprofile
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


def restore_or_init(args, setup: TrainSetup, device: torch.device,
                    mesh=None):
    """Returns ``(state, start, path)``: a fresh state seeded ``--seed``,
    restored from ``--ft_path`` or, unless ``--no_reload``, the
    experiment's latest checkpoint when there is one; ``path`` is the file
    restored (its sidecars sit beside it), None for the fresh state.
    Every rank of ``mesh`` reads the checkpoint, then takes rank 0's
    parameters."""
    state = init_state(make_generator(args.seed, device), setup, device)
    path = args.ft_path
    if not path and not args.no_reload:
        path = ckio.latest_checkpoint(exp_dir(args))
    start = 0
    if path and os.path.exists(path):
        ckio.restore_checkpoint(path, state, device)
        print(f"Resumed from {path} at step {state.step}")
        start = state.step
    else:
        path = None
    pmesh.replicate(state_tensors(state), mesh)
    return state, start, path


def state_tensors(state) -> list:
    """The parameters of both networks and the per-image tensors."""
    out = list(state.params_coarse.parameters())
    if state.params_fine is not None:
        out += list(state.params_fine.parameters())
    return out + [t for t in (state.depth_scales, state.depth_shifts,
                              state.cam_embeddings) if t is not None]


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


def phase_boundaries(*steps: int) -> list:
    """The sorted positive steps at which a new training phase starts;
    0 marks a phase the run does not have."""
    return sorted({b for b in steps if b > 0})


def window_end(i0: int, n: int, boundaries, last: int,
               full_batches=None) -> int:
    """The last step of the dispatch window that starts at step ``i0``:
    ``n`` steps, cut before the next phase boundary, at ``last`` and,
    with a ray pool, after the ``full_batches`` batches left in its epoch
    (the JAX driver's cuts, run_plnerf.py:560-569)."""
    nb = next((b for b in boundaries if b > i0), last + 1)
    end = min(i0 + n - 1, nb - 1, last)
    if full_batches is not None:
        end = min(end, i0 + full_batches - 1)
    return end


def fires(i: int, n_this: int, period: int) -> bool:
    """A multiple of ``period`` falls in the window of ``n_this`` steps
    that ends at step ``i`` (JAX run_plnerf.py:627-629)."""
    return i // period > (i - n_this) // period


def run_training(args, bundle: DatasetBundle, setup: TrainSetup,
                 mcfg: ModelConfig, rcfg: RenderConfig, mesh=None):
    """The train loop; returns the final ``TrainState``.  ``mesh``: this
    rank's place in a data-parallel run (the module docstring)."""
    device = resolve_device(args.device)
    main = pmesh.is_main(mesh)
    data = bundle.data
    state, start, ckpt_path = restore_or_init(args, setup, device, mesh)
    logger = MetricsLogger(exp_dir(args), enabled=main)

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

    n_inner = max(1, args.steps_per_dispatch)

    def make_step(const_init: bool, occ_on: bool):
        s = dataclasses.replace(setup, rcfg=dataclasses.replace(
            rcfg, constant_init=const_init, occ=occ_cfg if occ_on else None))
        return make_multi_train_step(s, n_inner, mesh)

    # one window body per quadrature phase (constant_init on / off) and,
    # with the grid, per grid phase (warm-up / guided)
    steps = {(ci, oc): make_step(ci, oc) for ci in (True, False)
             for oc in ((False, True) if occ_cfg is not None else (False,))}
    # a full window is one CUDA graph per (phase, precrop), sharing one
    # memory pool; under data parallelism with its collectives inside
    feed = graph.Feed(n_inner, device, len(state.optimizers()))
    graphs = graph.Graphs(device, n_inner, window_counters(state), [g])

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
    else:
        # on the device once, before the loop
        images = torch.as_tensor(np.asarray(data.images, np.float32),
                                 device=device)
        poses = torch.as_tensor(np.asarray(data.poses, np.float32)[:, :3, :4],
                                device=device)
        K = torch.as_tensor(np.asarray(data.K, np.float32), device=device)
        i_train = torch.as_tensor(np.asarray(bundle.i_train), device=device)

    i_batch = 0   # the pool's next row

    def batch_of(k):
        """Step ``k`` of the window on the device: the pool's rows at the
        window's ``offsets[k]``, or a one-image batch drawn from ``g``."""
        if use_batching:
            rays, target = batching.pool_batch(
                pool, offsets[k], n_rand, near, far, rcfg.use_viewdirs)
        else:
            rays, target, _ = batching.sample_one_image_batch(
                images, poses, K, i_train, g, n_rand, near, far,
                rcfg.use_viewdirs, precrop, args.precrop_frac,
                ndc=bundle.ndc, focal=float(data.hwf[2]))
        return {"rays": rays, "target": target}

    # windows never straddle a phase boundary, so every step trains in the
    # phase the reference would use (JAX run_plnerf.py:548-556)
    boundaries = phase_boundaries(
        args.constant_init if rcfg.mode == "linear" else 0,
        0 if use_batching else args.precrop_iters,
        occ_warm_end + 1 if occ_cfg is not None else 0)
    t0 = time.time()
    steps_since_print = 0
    # the recorder's roots after this one go into the next [TRAIN] line
    since = uprofile.mark()
    dead_warned = occ_warned = False
    profile_n = args.profile if main else 0
    prof = prof_first = None
    i0 = start + 1
    while i0 <= n_iters:
        # the pool tail: a window ends where the epoch's full batches end
        # (JAX :562-569), so the reshuffle falls between windows
        i = window_end(i0, n_inner, boundaries, n_iters,
                       (pool.shape[0] - i_batch) // n_rand
                       if use_batching else None)
        n_this = i - i0 + 1
        # the phases of the window's steps, as the reference picks them
        ci = i0 < args.constant_init and rcfg.mode == "linear"
        occ_on = occ_cfg is not None and i0 > occ_warm_end
        precrop = not use_batching and i0 < args.precrop_iters
        # the window reads nothing back from the device, its batches made
        # there; one that captures or replays reads the host's per-step
        # values (rates, step counts, pool offsets) from the staged feed,
        # any other from the host
        key = (ci, occ_on, precrop)
        staged = graphs.schedule(key, n_this) in graph.STAGED
        offsets = range(i_batch, i_batch + n_this * n_rand, n_rand)
        if staged:
            stage_window(feed, state, n_this, **(
                {"offset": offsets} if use_batching else {}))
            offsets = feed.row("offset")
        if use_batching:
            i_batch += n_this * n_rand
        multi, grid = steps[(ci, occ_on)], occ_state if occ_on else None

        def body(n):
            return multi.window(state, n, batch_of, g,
                                feed if staged else None, grid)

        # a capture runs nothing, and is kept out of the trace's window
        graphs.prepare(key, body, n_this)
        if profile_n and prof_first is None and i0 > start + 3:
            # from the fourth step: the first ones build and warm up
            prof, prof_first = uprofile.start_trace(device), i0
        metrics = graphs.run(key, body, n_this)
        if use_batching and pool.shape[0] - i_batch < n_rand:
            # every full batch of the epoch is consumed before the
            # reshuffle (run_plnerf.py:1244-1248 of the reference), in
            # place: the graphs read the pool where it is
            pool.copy_(pool[torch.randperm(pool.shape[0], generator=g,
                                           device=device)])
            i_batch = 0
        i0 = i + 1
        steps_since_print += n_this
        if prof is not None and i >= prof_first + profile_n - 1:
            _stop_profile(args, prof, prof_first, device, i + 1 - prof_first)
            prof = None

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

        if fires(i, n_this, args.i_print):
            m = {k: float(v) for k, v in metrics.items()}   # host sync
            wall = max(time.time() - t0, 1e-9)
            m["steps_per_sec"] = steps_since_print / wall
            t0 = time.time()
            steps_since_print = 0
            logger.scalars(i, m, prefix="train/")
            windows, since = uprofile.records(since), uprofile.mark()
            print(f"[TRAIN] Iter: {i} Loss: {m['loss']:.5f} "
                  f"PSNR: {m['psnr']:.2f} ({m['steps_per_sec']:.1f} it/s) "
                  + graph.window_report(windows, wall))
            dead_warned = _dead_coarse_advisory(m, i, dead_warned,
                                                args.mode)
            if args.debug:
                bad = [k for k, v in m.items() if not np.isfinite(v)]
                if bad:
                    raise FloatingPointError(
                        f"[Numerical Fail] non-finite metrics at iter {i}: "
                        f"{bad} (reference DEBUG scan, run_plnerf.py:754)")

        if fires(i, n_this, args.i_weights) and main:
            save_checkpoint(args, state, occ_state)

        if fires(i, n_this, args.i_img) and len(bundle.i_val) > 0:
            vi = int(bundle.i_val[(i // args.i_img) % len(bundle.i_val)])
            out = _oom_retry(lambda c: EI.render_image(
                state.params_coarse, state.params_fine, data.poses[vi],
                data.hwf, data.K, mcfg,
                EI.test_render_config(rcfg, occ=occ_cfg), near=near,
                far=far, chunk=c, ndc=bundle.ndc, mcfg_fine=setup.mcfg_fine,
                occ_grid=occ_state, mesh=mesh), ev_chunk)
            val_mse = float(np.mean(
                (out["rgb_map"] - np.asarray(data.images[vi])) ** 2))
            logger.scalars(i, {"mse": val_mse, "psnr": Mx.mse2psnr(val_mse)},
                           prefix="val/")
            logger.image(i, "val/rgb", np.clip(out["rgb_map"], 0, 1))

        if fires(i, n_this, args.i_testset) and i < n_iters:
            _oom_retry(lambda c: run_test(
                args, bundle, mcfg, rcfg, state=state, suffix=f"_{i:06d}",
                setup=setup, chunk=c, occ=(occ_cfg, occ_state),
                mesh=mesh), ev_chunk)

        if fires(i, n_this, args.i_video) and i < n_iters:
            _oom_retry(lambda c: run_video(
                args, bundle, mcfg, rcfg, setup, state=state, step=i,
                chunk=c, occ=(occ_cfg, occ_state), mesh=mesh), ev_chunk)

    if prof is not None:   # the run ended inside the profiled window
        _stop_profile(args, prof, prof_first, device, n_iters + 1 - prof_first)
    if graphs.capture:
        print(f"[graphs] {len(graphs.programs)} variants, "
              f"{graphs.captures} captures ({graphs.capture_s:.2f} s), "
              f"{graphs.replays} replays")
    if main:
        save_checkpoint(args, state, occ_state)
    # the checkpoint is whole before any rank goes on
    pmesh.barrier(mesh)
    logger.close()
    print("Training complete.")
    return state


def _stop_profile(args, prof, first: int, device, steps: int) -> dict:
    """End the --profile window of ``steps`` steps from step ``first``:
    the Chrome trace ``<expname>/profile/trace_{first:06d}.json`` and a
    table of the top device ops (the host's on the CPU)."""
    out = uprofile.stop_trace(prof, os.path.join(
        exp_dir(args), "profile", f"trace_{first:06d}.json"), device, steps)
    print(f"Wrote profiler trace of steps {first}-{first + steps - 1} to",
          out["trace"])
    for what in ("top_device_ops", "top_host_ops"):
        print(f"[profile] {what} (ms per step):")
        for name, ms in out[what]:
            print(f"  {ms:10.3f}  {name}")
    gaps = out["device_gaps"]
    print(f"[profile] device idle {gaps['idle_ms']:.1f} ms in "
          f"{gaps['gaps']} gaps over a {gaps['span_ms']:.1f} ms span")
    return out


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


def _state_for_eval(args, setup, mesh=None):
    """``(state, occ_cfg, grid)``: the checkpoint under evaluation and its
    grid (``occ_for_eval``)."""
    device = resolve_device(args.device)
    state, start, path = restore_or_init(args, setup, device, mesh)
    if start == 0 and not args.no_reload:
        print("WARNING: no checkpoint found — evaluating fresh init")
    return (state,) + occ_for_eval(args, path, device)


def _lpips(args, mesh=None):
    """The LPIPS metric on the run's device (rank 0 only), or None."""
    if not pmesh.is_main(mesh):
        return None
    return load_lpips(getattr(args, "lpips_weights", None),
                      resolve_device(args.device))


def run_test(args, bundle, mcfg, rcfg, state=None, suffix: str = "",
             setup=None, chunk=None, occ=(None, None), mesh=None):
    """Render and score the test split; writes the images and metrics.txt
    (rank 0) and returns the ``MeanTracker``.  Without ``state``, the
    checkpoint under evaluation and its grid; with it, ``occ`` is
    (occ_cfg, grid)."""
    if state is None:
        state, *occ = _state_for_eval(args, setup, mesh)
    occ_cfg, occ_grid = occ
    mean_metrics, res = EI.render_images_with_metrics(
        state.params_coarse, state.params_fine, bundle.data, bundle.i_test,
        mcfg, eval_render_config(args, rcfg, occ_cfg),
        chunk=chunk or args.chunk, near=bundle.near, far=bundle.far,
        ndc=bundle.ndc, mcfg_fine=setup.mcfg_fine if setup else None,
        occ_grid=occ_grid, lpips_fn=_lpips(args, mesh), mesh=mesh)
    if not pmesh.is_main(mesh):
        return mean_metrics
    result_dir = os.path.join(
        exp_dir(args),
        f"test_images_{args.mode}_{args.N_samples}_{args.N_importance}"
        f"{args.scene_id}{suffix}",
    )
    EI.write_images_with_metrics(res, mean_metrics, result_dir)
    return mean_metrics


# the reference's multi-distance sweep: dist -> near plane
FIXED_DIST_NEAR = {0.25: 1e-4, 0.5: 0.5, 0.75: 1.0, 1.0: 2.0}


def run_test_fixed_dist(args, mcfg, rcfg, setup, mesh=None):
    """Score the checkpoint on the held-out views of the blender_fixeddist
    scene ``--eval_data_dir`` / ``--eval_scene_id`` at each distance of
    ``FIXED_DIST_NEAR``, with its near plane; returns {dist:
    MeanTracker}."""
    import copy

    state, occ_cfg, occ_grid = _state_for_eval(args, setup, mesh)
    lp = _lpips(args, mesh)
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
            mcfg_fine=setup.mcfg_fine, occ_grid=occ_grid, lpips_fn=lp,
            mesh=mesh)
        out[test_dist] = mean_metrics
        if not pmesh.is_main(mesh):
            continue
        EI.write_images_with_metrics(res, mean_metrics, os.path.join(
            exp_dir(args), f"test_images_dist{test_dist}_{args.scene_id}"))
        print(f"[fixed_dist {test_dist}] psnr="
              f"{mean_metrics.get('psnr'):.3f}")
    return out


def run_test_samples_error(args, bundle, mcfg, rcfg, setup, mesh=None):
    """The importance-sampling error of the held-out views, written to
    ``test_samples_error_{N_importance}/metrics_expecteddepth.txt``;
    returns the ``MeanTracker``."""
    state, occ_cfg, occ_grid = _state_for_eval(args, setup, mesh)
    return EI.test_images_samples(
        state.params_coarse, state.params_fine, bundle.data, bundle.i_test,
        mcfg, eval_render_config(args, rcfg, occ_cfg),
        os.path.join(exp_dir(args),
                     f"test_samples_error_{args.N_importance}"),
        chunk=args.chunk, mcfg_fine=setup.mcfg_fine, ndc=bundle.ndc,
        occ_grid=occ_grid, mesh=mesh)


def run_video(args, bundle, mcfg, rcfg, setup, state=None, step=None,
              chunk=None, occ=(None, None), mesh=None):
    """Render the camera path (``render_poses``; with --render_test the
    test views) into ``renderonly_{path|test}_{step:06d}``: the frames
    ``{i:03d}.png`` and ``write_video``'s ``video/{i:03d}.png``.  Returns
    the rgbs [N, H, W, 3].  Without ``state``, the checkpoint under
    evaluation, its step and its grid; with it, ``step`` and ``occ`` =
    (occ_cfg, grid)."""
    if state is None:
        state, *occ = _state_for_eval(args, setup, mesh)
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
        mcfg_fine=setup.mcfg_fine, occ_grid=occ_grid, mesh=mesh)
    if pmesh.is_main(mesh):
        EI.write_video(os.path.join(savedir, "video.mp4"), rgbs, fps=30)
    print("Done rendering", savedir)
    return rgbs


# ---------------------------------------------------------------------------

def run_export_serving(args, mcfg, rcfg, setup, mesh=None):
    """--task export_serving: export the checkpoint under evaluation (and
    its grid) into a serving artifact (``serving/export.py``) on the run's
    device, under the eval task's render config (``eval_render_config``:
    the perturb quirk, --eval_det, --eval_N_*).  ``--serve_platforms``
    may name only that device (``_refuse_unported``).  Returns the
    manifest; under a mesh rank 0 exports, the others return None."""
    if not pmesh.is_main(mesh):
        return None
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
    what cannot run: an export for a device other than the run's, a batch
    that does not split over the ranks of a ``torchrun`` launch."""
    if args.task == "export_serving" and args.serve_platforms:
        dev = resolve_device(args.device).type
        if any(p != dev for p in args.serve_platforms.split(",")):
            raise SystemExit(
                f"--serve_platforms {args.serve_platforms}: the artifact "
                f"runs only on the device it is exported on ({dev}); pass "
                "--device to choose it")
    if args.task == "train" and not args.no_mesh:
        pmesh.refuse_unsplit(args.N_rand)
    if args.task not in TASKS:
        raise SystemExit(f"Unknown task {args.task}")


def run(args, vanilla: bool = False, mesh=None):
    """Run ``args.task``; returns the final ``TrainState`` (train), the
    metrics' ``MeanTracker`` (test, test_samples_error), {dist:
    MeanTracker} (test_fixed_dist), the frames (video, --render_only) or
    the artifact's manifest (export_serving).  ``mesh``: this rank's
    place under ``torchrun`` (``main`` makes it)."""
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
        return run_test_fixed_dist(args, mcfg, rcfg, setup, mesh)
    if args.task == "export_serving":
        return run_export_serving(args, mcfg, rcfg, setup, mesh)
    bundle = load_dataset(args)
    if args.render_only or args.task == "video":
        return run_video(args, bundle, mcfg, rcfg, setup, mesh=mesh)
    if args.task == "train":
        return run_training(args, bundle, setup, mcfg, rcfg, mesh)
    if args.task == "test_samples_error":
        return run_test_samples_error(args, bundle, mcfg, rcfg, setup, mesh)
    return run_test(args, bundle, mcfg, rcfg, setup=setup, mesh=mesh)


def join_mesh(args):
    """This process's ``Mesh`` under ``torchrun``, else None
    (``parallel/mesh.get_mesh``)."""
    return pmesh.get_mesh(args.no_mesh, args.device or "cuda")


def main(argv=None, vanilla: bool = False):
    """Parse ``argv``; before anything is read or written, resolve the
    device (raises without CUDA unless ``--device cpu``) and refuse what is
    not ported; join the process group under ``torchrun``; then run (which
    checks the args.json-merged flags again), printing from rank 0."""
    args = config_parser().parse_args(argv)
    resolve_device(args.device)
    _refuse_unported(args)
    mesh = join_mesh(args)
    args = resolve_args(args, write=pmesh.is_main(mesh))
    args.expname = pmesh.broadcast_object(args.expname, mesh)
    if vanilla:
        args.constant_init = 0  # vanilla has no warmup
    with pmesh.main_stdout(mesh):
        return run(args, vanilla=vanilla, mesh=mesh)


if __name__ == "__main__":
    main()
