"""Held-out quality of the port's LLFF driver on the forward-facing
fixture: the geometry of the JAX package's LLFF convergence study (12
views of 120x160, ``--factor 1``, llffhold 8: views 0 and 8 held out), the
``configs/llff_linear.txt`` recipe as it stands, ``--iters`` steps
(2,000), then ``--task test``.

    python -m plnerf_torch.tools.llff_quality --out DIR [--iters 2000]
        [--dtypes float32,bfloat16] [--device cpu]

Prints one JSON line: per MLP dtype, the held-out PSNR / SSIM of the test
task (the reference's perturb-at-test render), the last training loss,
and ms per step (the ``i_print`` windows' times from ``metrics.jsonl``,
summed over the run); with the card's name and power limit.  The driver
runs on the CUDA device, its fused kernels on; ``--device cpu`` runs
their plain versions, and its times are CPU times, never a device
metric.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess

import torch

from ..cli import run_plnerf
from ..data.synthetic import make_llff_fixture

CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "configs", "llff_linear.txt")
PRINT = 100


def card() -> str:
    if not torch.cuda.is_available():
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def run(out: str, iters: int, dtype: str, device=None) -> dict:
    data = os.path.join(out, "data")
    where = ["--data_dir", data, "--scene_id", "ff", "--ckpt_dir",
             os.path.join(out, "ckpt"), "--expname", dtype,
             "--dataset", "llff"]
    where += ["--device", device] if device else []
    every = min(PRINT, iters)
    run_plnerf.main(["--config", CONFIG, "--task", "train", "--factor", "1",
                     "--mlp_dtype", dtype, "--num_iterations", str(iters),
                     "--i_print", str(every), "--i_weights", str(iters),
                     "--i_img", "100000000", "--i_testset", "100000000",
                     "--i_video", "100000000"] + where)
    mm = run_plnerf.main(["--task", "test"] + where)
    with open(os.path.join(out, "ckpt", dtype, "metrics.jsonl")) as f:
        recs = [r for r in map(json.loads, f) if "train/loss" in r]
    return {"psnr": mm.get("psnr"), "ssim": mm.get("ssim"),
            "psnr0": mm.get("psnr0"), "loss": recs[-1]["train/loss"],
            "ms_per_step": 1e3 * sum(every / r["train/steps_per_sec"]
                                     for r in recs) / iters}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--iters", type=int, default=2000)
    ap.add_argument("--dtypes", default="float32,bfloat16")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    make_llff_fixture(os.path.join(args.out, "data", "ff"),
                      workers=min(8, os.cpu_count() or 1))
    res = {"card": card(), "iters": args.iters, "views": 12,
           "size": [120, 160], "held_out": [0, 8],
           "runs": {d: run(args.out, args.iters, d, args.device)
                    for d in args.dtypes.split(",")}}
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
