"""Config/flag system (own copy of ``plnerf/cli/config.py``):
configargparse-compatible parsing without the dependency, plus the
args.json round-trip.

Reference: ``config_parser()`` (run_plnerf.py:761-916) with configargparse's
``--config file.txt`` layering (flags in the file are defaults; explicit CLI
flags win), ``args.json`` dumped at train start (:928-931) and re-loaded at
test/video time with a fixed set of CLI overrides kept (:933-975).

Every flag name and default of the JAX package is kept, so each
``configs/*.txt`` parses to the same values.  The port differs in two
flags: ``--use_kernel`` (the fused CUDA MLP, a tri-state) replaces
``--use_pallas``, and ``--device`` picks ``cpu`` or ``cuda`` (unset: the
CUDA device, raising where there is none).  ``--steps_per_dispatch N``
runs windows of N train steps in which the host never waits on the
device, cut as the JAX driver cuts its scans (``cli/run_plnerf.py``).
"""
from __future__ import annotations

import argparse
import json
import os
import shlex
import sys
from typing import Optional, Sequence


def str2bool(v) -> bool:
    """argparse-safe bool: plain ``type=bool`` treats 'False' as True."""
    if isinstance(v, bool):
        return v
    if str(v).lower() in ("true", "1", "yes", "y"):
        return True
    if str(v).lower() in ("false", "0", "no", "n", ""):
        return False
    raise argparse.ArgumentTypeError(f"expected a boolean, got {v!r}")


def read_config_file(path: str) -> dict:
    """Parse a configargparse-style txt: ``key = value`` per line, ``#``
    comments; bare ``key`` lines mean True."""
    out = {}
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            if "=" in line:
                k, v = line.split("=", 1)
                out[k.strip()] = v.strip()
            else:
                out[line] = "True"
    return out


class ConfigArgumentParser(argparse.ArgumentParser):
    """argparse with configargparse's file-layering behavior for the subset
    the reference uses: a ``--config`` txt whose entries act as defaults."""

    def parse_args(self, args: Optional[Sequence[str]] = None,  # type: ignore[override]
                   namespace=None):
        argv = list(sys.argv[1:] if args is None else args)
        # find --config without consuming other flags
        pre = argparse.ArgumentParser(add_help=False)
        pre.add_argument("--config", type=str, default=None)
        known, _ = pre.parse_known_args(argv)
        if known.config:
            file_vals = read_config_file(known.config)
            defaults = {}
            for action in self._actions:
                if action.dest in file_vals:
                    raw = file_vals[action.dest]
                    if isinstance(action, (argparse._StoreTrueAction,
                                           argparse._StoreFalseAction,
                                           argparse.BooleanOptionalAction)):
                        defaults[action.dest] = raw.lower() in (
                            "true", "1", "yes")
                    elif action.nargs not in (None, "?"):
                        # multi-value flags: split first, then apply type
                        vals = shlex.split(raw)
                        if action.type is not None:
                            vals = [action.type(v) for v in vals]
                        defaults[action.dest] = vals
                    elif action.type is not None:
                        defaults[action.dest] = action.type(raw)
                    else:
                        defaults[action.dest] = raw
            unknown = set(file_vals) - {a.dest for a in self._actions}
            if unknown:
                raise SystemExit(
                    f"unknown keys in config file {known.config}: "
                    f"{sorted(unknown)}"
                )
            self.set_defaults(**defaults)
        ns = super().parse_args(argv, namespace)
        return ns


def add_base_flags(parser: ConfigArgumentParser) -> None:
    """The shared NVS flag surface (reference run_plnerf.py:766-916)."""
    a = parser.add_argument
    a("--task", default="train", type=str,
      help='train | test | test_fixed_dist | test_samples_error | video')
    a("--config", type=str, default=None, help="config file path")
    a("--expname", type=str, default=None)
    a("--ckpt_dir", type=str, default="")
    a("--scene_id", type=str, default="lego")
    a("--data_dir", type=str, default="../nerf_synthetic")
    a("--dataset", type=str, default="blender")
    # training
    a("--netdepth", type=int, default=8)
    a("--netwidth", type=int, default=256)
    a("--netdepth_fine", type=int, default=8)
    a("--netwidth_fine", type=int, default=256)
    a("--N_rand", type=int, default=32 * 32 * 4)
    a("--lrate", type=float, default=5e-4)
    a("--coarse_lrate", type=float, default=5e-4)
    a("--lrate_decay", type=int, default=250)
    a("--chunk", type=int, default=1024 * 32)
    a("--eval_chunk", type=int, default=None,
      help="ray chunk for IN-TRAINING eval renders (i_img/i_testset/"
           "i_video); default: --chunk, auto-shrunk to 8192 when a "
           ">1 GB use_batching ray pool is resident (memory headroom — "
           "see cli.run_plnerf.training_eval_chunk)")
    a("--netchunk", type=int, default=1024 * 64)
    a("--no_batching", action="store_true")
    a("--no_reload", action="store_true")
    a("--ft_path", type=str, default=None)
    # rendering
    a("--N_samples", type=int, default=64)
    a("--N_importance", type=int, default=128)
    a("--perturb", type=float, default=1.0)
    a("--use_viewdirs", action="store_true")
    a("--i_embed", type=int, default=0)
    a("--multires", type=int, default=10)
    a("--multires_views", type=int, default=4)
    a("--raw_noise_std", type=float, default=0.0)
    a("--render_only", action="store_true")
    a("--render_test", action="store_true")
    a("--render_factor", type=int, default=0)
    a("--precrop_iters", type=int, default=0)
    a("--precrop_frac", type=float, default=0.5)
    # dataset
    a("--testskip", type=int, default=1)
    a("--white_bkgd", action="store_true")
    a("--half_res", action="store_true")
    a("--factor", type=int, default=8)
    a("--no_ndc", action="store_true")
    a("--lindisp", action="store_true")
    a("--spherify", action="store_true")
    a("--llffhold", type=int, default=8)
    # logging / saving
    a("--num_iterations", type=int, default=500000)
    a("--i_print", type=int, default=100)
    a("--i_img", type=int, default=600000)
    a("--i_weights", type=int, default=100000)
    a("--i_testset", type=int, default=500000)
    a("--i_video", type=int, default=500000)
    # PWL
    a("--mode", type=str, default="constant")
    a("--color_mode", type=str, default="midpoint")
    # accepted for reference-config compatibility; the reference
    # itself never reads it either (only appears in signatures,
    # run_nerf_helpers.py:364,448)
    a("--quad_solution_v2", default=True, type=str2bool)
    # constant-mode far-plane color fix in compositing (quadrature.py).
    # The reference surfaces the flag only in its extract-mesh driver
    # (nerf_extract_mesh.py:730, passed into render kwargs at :251); in
    # the training drivers it is an internal default-False parameter
    # (run_plnerf.py:553,645).  Exposed here for all tasks — deviation:
    # broader surface, same default.
    a("--farcolorfix", default=False, type=str2bool)
    # parse-only in the reference (nerf_extract_mesh.py:735 defines it,
    # nothing reads it); accepted-inert for config compatibility
    a("--coarse_weight", type=float, default=1.0)
    a("--zero_tol", type=float, default=1e-4)
    a("--epsilon", type=float, default=1e-3)
    a("--set_near_plane", default=2.0, type=float)
    a("--constant_init", type=int, default=1000)
    a("--test_dist", default=1.0, type=float)
    a("--eval_scene_id", type=str,
      default="chair_rgba_fixdist_nv100_dist0.25-1.0-4_depth_sfn")
    a("--eval_data_dir", type=str,
      default="../nerf_synthetic/fixed_dist_new-rgba/")
    # DTU
    a("--dtu_scene_id", type=int, default=21)
    a("--num_train", type=int, default=40)
    a("--dtu_split", type=str, default=None)
    # --- additions of the JAX package and the port (not in reference) ---
    a("--lpips_weights", type=str, default=None,
      help="LPIPS (AlexNet) weights for the eval tasks: the .npz of "
           "tools/export_lpips_weights.py or a torch state dict; unset "
           "reads $PLNERF_LPIPS_WEIGHTS, then weights/lpips_alex.npz, and "
           "without a file metrics.txt notes LPIPS as UNAVAILABLE")
    a("--mlp_dtype", type=str, default="float32",
      help="float32 | bfloat16 matmul dtype for the NeRF MLP")
    a("--use_kernel", action=argparse.BooleanOptionalAction, default=None,
      help="the fused CUDA MLP kernels (folded heads) for training and "
           "eval.  Default (unset) is AUTO: on for a CUDA device, off on "
           "the CPU (its plain version would run there).  --use_kernel "
           "forces them on, --no-use_kernel off (unfused PyTorch MLP)")
    a("--device", type=str, default=None, choices=["cpu", "cuda"],
      help="where to run; unset means the CUDA device (raises without "
           "one)")
    a("--steps_per_dispatch", type=int, default=1,
      help="run N optimization steps per window in which the host "
           "reads nothing back from the device; logging/ckpt cadences "
           "round to the windows' ends")
    a("--remat", action="store_true",
      help="recompute the MLP in backward (torch.utils.checkpoint) to "
           "raise the ray-batch memory ceiling")
    # --task export_serving (serving/export.py)
    a("--serve_out", type=str, default=None,
      help="artifact directory; default <ckpt_dir>/<expname>/serving")
    a("--serve_weights", type=str, default="baked",
      choices=["baked", "args"],
      help="weights inside the programs, or in weights.pt as an input")
    a("--serve_platforms", type=str, default=None,
      help="comma list of devices; only the export device is accepted")
    a("--serve_image", type=str, default=None,
      help="HxW: also export a whole-batch module for H*W rays")
    a("--sigma_bias_init", type=float, default=0.0,
      help="constant added to the density head's bias at init; 0.0 = "
           "exact reference init.  ~0.1 prevents the dead-coarse "
           "init trap on raw-relu heads (BASELINE.md collapse sweep)")
    a("--grad_accum", type=int, default=1,
      help="accumulate grads over N equal ray chunks per optimizer "
           "step: peak memory of one chunk, same update")
    a("--eval_N_samples", type=int, default=None,
      help="test/video tasks only: render with this many coarse samples "
           "instead of the trained N_samples — a quality/latency dial "
           "for serving (the reference pins eval to the trained counts "
           "via its args.json reload, run_plnerf.py:937-975)")
    a("--eval_N_importance", type=int, default=None,
      help="test/video tasks only: importance-sample count override "
           "(see --eval_N_samples)")
    a("--eval_det", action="store_true",
      help="test/video tasks only: deterministic sample placement at "
           "eval (perturb off). The reference deliberately evaluates "
           "with perturb=True (run_plnerf.py:497-499, preserved as the "
           "default); det placement is measured +0.04-0.31 dB / up to "
           "+0.045 SSIM at identical cost (BASELINE.md). Writes into "
           "the same test_images dir as the default eval.")
    a("--no_mesh", action="store_true",
      help="one device: refused under torchrun with more than one "
           "process (without torchrun the run uses one device anyway)")
    add_occ_flags(a)
    a("--seed", type=int, default=0)
    a("--profile", type=int, default=0,
      help="torch.profiler trace of N training steps, from the 4th step "
           "of the run, into <expname>/profile/ (rank 0; 0 = off)")
    a("--debug", action="store_true",
      help="per-print NaN/Inf scan over training metrics (the reference's "
           "DEBUG flag, run_plnerf.py:42,754-757)")


def config_parser() -> ConfigArgumentParser:
    parser = ConfigArgumentParser()
    add_base_flags(parser)
    return parser


def add_occ_flags(a) -> None:
    """Occupancy-grid flag group, shared by the NVS and depth drivers, with
    the JAX package's defaults (``core/occgrid.py``;
    ``run_plnerf.occ_cfg_from_args``).  ``a`` is a parser's
    ``add_argument``."""
    a("--occ_grid", action="store_true")
    a("--occ_res", type=int, default=128)
    a("--occ_candidates", type=int, default=96)
    a("--occ_warmup", type=int, default=256)
    a("--occ_bound", type=float, default=1.5)
    a("--occ_decay", type=float, default=0.7)
    a("--occ_threshold", type=float, default=1e-2)
    a("--occ_floor", type=float, default=0.03)
    a("--occ_keep_degenerate", action="store_true")
    a("--occ_eval_fresh_grid", action="store_true")


# CLI fields preserved (from the command line) when reloading args.json for
# a non-train task — reference run_plnerf.py:937-975.
_TEST_OVERRIDES = [
    "task", "data_dir", "ckpt_dir", "set_near_plane", "dataset",
    "test_dist", "scene_id", "white_bkgd", "eval_scene_id",
    "eval_data_dir", "testskip",
    # eval-time flags this framework adds (not meaningful to inherit from
    # the training args.json).  Only flags whose parser default means
    # "off" belong here — plain argparse can't distinguish an explicit
    # CLI value from the default, so overriding e.g. chunk/mlp_dtype/seed
    # would silently replace the trained values with defaults.
    "lpips_weights", "render_test", "render_factor", "render_only",
    "ft_path", "no_reload", "no_mesh", "use_kernel", "device", "profile",
    "debug",
    "occ_eval_fresh_grid", "eval_N_samples", "eval_N_importance",
    "eval_det", "serve_out", "serve_platforms", "serve_image",
    "serve_weights",
]


def resolve_args(args: argparse.Namespace,
                 write: bool = True) -> argparse.Namespace:
    """Train: dump args.json into <ckpt_dir>/<expname>/ (unless not
    ``write``: a data-parallel rank other than 0).  Other tasks: reload
    args.json and keep only the ``_TEST_OVERRIDES`` CLI fields."""
    if args.task == "train":
        if args.expname is None:
            import datetime
            import time

            args.expname = "{}_{}".format(
                datetime.datetime.fromtimestamp(time.time()).strftime(
                    "%Y%m%d_%H%M%S"), args.scene_id)
        if not write:
            return args
        exp_dir = os.path.join(args.ckpt_dir, args.expname)
        os.makedirs(exp_dir, exist_ok=True)
        with open(os.path.join(exp_dir, "args.json"), "w") as f:
            json.dump(vars(args), f, indent=4)
        if args.config is not None and os.path.isfile(args.config):
            with open(args.config) as src, \
                    open(os.path.join(exp_dir, "config.txt"), "w") as f:
                f.write(src.read())
        return args

    if args.expname is None:
        raise SystemExit("Error: Specify experiment name for test or video")
    keep = {k: getattr(args, k) for k in _TEST_OVERRIDES if hasattr(args, k)}
    args_file = os.path.join(args.ckpt_dir, args.expname, "args.json")
    with open(args_file) as f:
        loaded = json.load(f)
    merged = argparse.Namespace(**loaded)
    for k, v in keep.items():
        setattr(merged, k, v)
    # fields added after a checkpoint was written default sensibly
    for k, v in vars(args).items():
        if not hasattr(merged, k):
            setattr(merged, k, v)
    return merged
