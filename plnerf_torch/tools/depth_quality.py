"""Held-out quality of the port's depth driver on the multi-object scene
with ground-truth depth, at the geometry of the JAX package's depth
convergence runs (160x160, 30 train and 6 held-out views, a field of view
of 0.5 rad), written in the blender2_depth layout: the depth recipe at
full width (linear, 128 + 64 samples, 1024 rays, white background, near
2) for ``--iters`` steps (2,000) in two arms, space carving at 0.007 and
photometric only (weight 0), then ``test``.

    python -m plnerf_torch.tools.depth_quality --out DIR [--iters 2000]
        [--arms 0.007,0] [--device cpu]

The loader reads the test split at a stride of 8, so the scene holds 41
test views of which 6 are read.  With weight 0 the driver skips the
termination quantiles (``compute_pred_hyp`` follows the weight), so the
photometric arm's step is the lighter of the two.

Prints one JSON line: per arm, the held-out PSNR / SSIM / depth RMSE of
the test task (the reference's perturb-at-test render), the last training
loss and space-carving loss, and ms per step (the ``i_print`` windows'
times from ``metrics.jsonl``, summed over the run); with the card's name
and power limit.  The driver runs on the CUDA device, its fused kernels
on; ``--device cpu`` runs their plain versions, and its times are CPU
times, never a device metric.
"""
from __future__ import annotations

import argparse
import json
import os

from ..cli import run_depth
from ..data.synthetic import write_blender2_depth_scene
from .llff_quality import card

PRINT = 100
VIEWS = {"train": 30, "test": 41}     # 6 test views read (stride 8)
SIZE = 160
CAMERA_ANGLE_X = 0.5                  # make_multi_object_dataset's focal
RECIPE = ["--dataset", "blender2_depth", "--mode", "linear", "--N_samples",
          "128", "--N_importance", "64", "--N_rand", "1024",
          "--white_bkgd", "--set_near_plane", "2.0"]


def run(out: str, iters: int, weight: str, device=None) -> dict:
    name = f"sc_{weight}"
    where = ["--data_dir", os.path.join(out, "data"), "--scene_id", "mobj",
             "--ckpt_dir", os.path.join(out, "ckpt"), "--expname", name]
    where += ["--device", device] if device else []
    every = min(PRINT, iters)
    run_depth.main(["train"] + RECIPE + where + [
        "--space_carving_weight", weight, "--num_iterations", str(iters),
        "--i_print", str(every), "--i_weights", str(iters)])
    mm = run_depth.main(["test"] + RECIPE + where)
    with open(os.path.join(out, "ckpt", name, "metrics.jsonl")) as f:
        recs = [r for r in map(json.loads, f) if "train/loss" in r]
    return {"psnr": mm.get("psnr"), "ssim": mm.get("ssim"),
            "depth_rmse": mm.get("depth_rmse"), "psnr0": mm.get("psnr0"),
            "loss": recs[-1]["train/loss"],
            "space_carving_loss": recs[-1].get("train/space_carving_loss"),
            "ms_per_step": 1e3 * sum(every / r["train/steps_per_sec"]
                                     for r in recs) / iters}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--iters", type=int, default=2000)
    ap.add_argument("--arms", default="0.007,0",
                    help="space-carving weights, one run each")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    write_blender2_depth_scene(
        os.path.join(args.out, "data", "mobj"), VIEWS, SIZE, SIZE,
        CAMERA_ANGLE_X, seed=0, workers=min(8, os.cpu_count() or 1))
    res = {"card": card(), "iters": args.iters, "views": VIEWS,
           "read_test_views": len(range(0, VIEWS["test"], 8)),
           "size": SIZE, "runs": {w: run(args.out, args.iters, w,
                                         args.device)
                                  for w in args.arms.split(",")}}
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
