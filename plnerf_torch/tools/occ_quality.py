"""Quality and cost of the occupancy-grid recipe beside uniform sampling at
the same dtype, through the port's driver on the sphere scene that
``chip_smoke.py``'s driver and occ phases train on (8 / 1 / 2 views at
400x400), seed 0.  Arms: ``occ``, ``configs/blender_linear_occ.txt``
(bf16, 32 grid-guided + 64 importance samples, a 128^3 grid with 96
candidates); ``uniform``, ``configs/blender_linear.txt --mlp_dtype
bfloat16`` (128 + 64 uniform); ``uniform_noise``, the same with
``--raw_noise_std 1e0``, the driver's dead-coarse advisory's remedy.
Each trains ``--iters`` steps (2,000) with the precrop and constant
quadrature cut to 50 / 100 and the grid's warm-up to 100, then runs
``--task test``.

    python -m plnerf_torch.tools.occ_quality --out DIR [--iters 2000]
        [--device cpu]

Prints one JSON line: per arm, the held-out PSNR / SSIM (fine and
coarse), the last training loss, ms per step (the ``i_print`` windows'
times from ``metrics.jsonl``, summed over the run, and window by window:
past ``run_plnerf.OCC_ADVISORY_GRACE`` guided steps the occ arm's
degenerate-guidance guard reads ``occ_ray_frac`` on every step, a host
sync), ``sigma0_pos_frac`` at every print (the share of positive raw
coarse densities; 0 is the dead-coarse trap of BASELINE.md, in which
the linear coarse renders a billboard at far and its importance samples
guide nothing) and, per test image, the median depth of the fine pass
over the target's background pixels; for the occ arm also ``occ_ray_frac`` at every print,
and of the final grid the occupied share, the share of voxels the run
observed, the density quantiles of those and whether the centre voxel
is occupied; with the card's name and power limit.  The driver runs on
the CUDA device with its fused kernels on; ``--device cpu`` runs their
plain versions, and its times are CPU times, never a device metric.
"""
from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np
import torch

from ..cli import run_plnerf
from ..data.png import read_png
from ..data.synthetic import write_sphere_scene
from .llff_quality import card

PRINT = 100
VIEWS = {"train": 8, "val": 1, "test": 2}
SIZE = 400
WARMUP = 100
FAR = 6.0                               # the Blender loader's far plane
CONFIGS = {"occ": ["--config", "configs/blender_linear_occ.txt"],
           "uniform": ["--config", "configs/blender_linear.txt",
                       "--mlp_dtype", "bfloat16"],
           "uniform_noise": ["--config", "configs/blender_linear.txt",
                             "--mlp_dtype", "bfloat16",
                             "--raw_noise_std", "1e0"]}


def _grid_stats(path: str, threshold: float) -> dict:
    grid = torch.load(path, map_location="cpu", weights_only=True)
    dens, occ = grid["density"], grid["occ"]
    seen = dens != torch.tensor(10.0 * threshold)
    q = torch.quantile(dens[seen][:1 << 24], torch.tensor(
        [0.1, 0.5, 0.9])) if seen.any() else None
    g = occ.shape[0]
    return {"occupied_share": float(occ.mean()),
            "observed_share": float(seen.float().mean()),
            "observed_density_q10_q50_q90": (None if q is None
                                             else q.tolist()),
            "centre_voxel_occupied": bool(occ[g // 2, g // 2, g // 2])}


def _background_depth(exp: str, far: float) -> list:
    """Per test image, the median depth the fine pass rendered over the
    pixels the target shows as white background (from the test task's
    ``{n}_gt.png`` and 16-bit ``{n}_d.png``): near ``far`` where the
    field is empty, near the near plane where it paints the view on an
    opaque shell in front of the camera."""
    res_dir, = glob.glob(os.path.join(exp, "test_images_*"))
    out = []
    for n in range(len(glob.glob(os.path.join(res_dir, "*_gt.png")))):
        bg = (read_png(os.path.join(res_dir, f"{n}_gt.png"))[..., :3]
              >= 253).all(-1)
        depth = read_png(os.path.join(res_dir, f"{n}_d.png")) / 65535 * far
        out.append(float(np.median(depth[bg])))
    return out


def run(out: str, arm: str, iters: int, device=None) -> dict:
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    argv = list(CONFIGS[arm])
    argv[1] = os.path.join(repo, argv[1])
    where = ["--data_dir", os.path.join(out, "data"), "--scene_id",
             "sphere", "--ckpt_dir", os.path.join(out, "ckpt"),
             "--expname", arm]
    where += ["--device", device] if device else []
    every = min(PRINT, iters)
    run_plnerf.main(argv + ["--task", "train"] + where + [
        "--precrop_iters", "50", "--constant_init", "100",
        "--occ_warmup", str(WARMUP), "--num_iterations", str(iters),
        "--i_print", str(every), "--i_weights", str(iters),
        "--i_img", "1000000", "--i_testset", "1000000",
        "--i_video", "1000000"])
    mm = run_plnerf.main(["--task", "test", "--white_bkgd"] + where)
    exp = os.path.join(out, "ckpt", arm)
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        recs = [r for r in map(json.loads, f) if "train/loss" in r]
    res = {"psnr": mm.get("psnr"), "ssim": mm.get("ssim"),
           "psnr0": mm.get("psnr0"), "loss": recs[-1]["train/loss"],
           "ms_per_step": 1e3 * sum(every / r["train/steps_per_sec"]
                                    for r in recs) / iters,
           "ms_per_step_by_window": {
               r["step"]: 1e3 / r["train/steps_per_sec"] for r in recs},
           "sigma0_pos_frac": {r["step"]: r["train/sigma0_pos_frac"]
                               for r in recs},
           "background_depth_median": _background_depth(exp, FAR)}
    if arm == "occ":
        res["occ_ray_frac"] = {r["step"]: r["train/occ_ray_frac"]
                               for r in recs if "train/occ_ray_frac" in r}
        res["grid"] = _grid_stats(os.path.join(exp, f"{iters:06d}.occ"),
                                  1e-2)
    return res


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--iters", type=int, default=2000)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    write_sphere_scene(os.path.join(args.out, "data", "sphere"), SIZE, VIEWS)
    res = {"card": card(), "iters": args.iters, "warmup": WARMUP,
           "views": VIEWS, "size": SIZE,
           "runs": {a: run(args.out, a, args.iters, args.device)
                    for a in CONFIGS}}
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
