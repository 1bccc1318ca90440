"""Driver ms per training step of the NVS recipes at chosen
``--steps_per_dispatch`` values, for one checkout of the port; run it once
per checkout in one machine's session to compare two of them on one card.

    python plnerf_torch/tools/dispatch_ab.py --root DIR [--n 1,8]
        [--recipes bf16,occ_bf16] [--steps 200] [--after 64]
        [--profile] [--out OUT.json] [--label NAME]

``--root``: the checkout whose ``plnerf_torch`` and ``configs/`` run (its
package is imported from there, so this file may come from another
checkout).  The recipes are ``chip_smoke.py``'s dispatch recipes on its
driver sphere (8 views at 400x400): ``blender_linear.txt`` in fp32
(``fp32``) or bf16 (``bf16``), ``blender_linear_occ.txt`` with a grid
warm-up of 40 (``occ_bf16``); precrop / constant quadrature 30 / 60, val
renders, test sets and videos off, a print record every 8 steps.  Each
run's ms per step is read from its print records past step ``--after``
(every phase boundary behind it): the steps between two records over
their ``steps_per_sec``.  ``--profile`` traces 8 steps of each run (the
driver's ``--profile 8``, from the window past step 3) and adds what the
host did in them per step: ms inside the windows' spans, CUDA
runtime launches, CPU ops, and the 30 most frequent CPU ops.  Prints one
JSON line per run and, with ``--out``, writes them all.
"""
from __future__ import annotations

import argparse
import collections
import glob
import json
import os
import sys
import tempfile
import time

RECIPES = {
    "fp32": ("blender_linear.txt", []),
    "bf16": ("blender_linear.txt", ["--mlp_dtype", "bfloat16"]),
    "occ_bf16": ("blender_linear_occ.txt", ["--occ_warmup", "40"]),
}
PRINT = 8
VIEWS = {"train": 8, "val": 1, "test": 2}
SIZE = 400


def ms_per_step(metrics_path: str, after: int) -> float:
    """ms per step from a run's print records past step ``after``."""
    recs = {}
    with open(metrics_path) as f:
        for line in f:
            r = json.loads(line)
            if "train/steps_per_sec" in r:
                recs[r["step"]] = r["train/steps_per_sec"]
    steps = sorted(recs)
    t = n = 0.0
    for prev, k in zip(steps, steps[1:]):
        if prev >= after:
            t += (k - prev) / recs[k]
            n += k - prev
    return 1e3 * t / n


def host_work(trace_path: str, steps: int) -> dict:
    """Per step of a driver's ``--profile`` trace: the host's ms inside
    its windows' spans (``window``; ``dispatch_window`` in a checkout
    older than the program's span recorder), its CUDA runtime launches
    and CPU ops there, and the 30 most frequent CPU ops."""
    with open(trace_path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("name") in ("window", "dispatch_window")
             and e.get("cat") == "user_annotation"]

    def inside(e):
        return any(a <= e["ts"] <= b for a, b in spans)

    ops = collections.Counter(e["name"] for e in events
                              if e.get("cat") == "cpu_op" and inside(e))
    launches = sum(1 for e in events if e.get("cat") == "cuda_runtime"
                   and "Launch" in e["name"] and inside(e))
    return {"host_ms": sum(b - a for a, b in spans) / 1e3 / steps,
            "launches": launches / steps,
            "cpu_ops": sum(ops.values()) / steps,
            "top_ops": [[k, c / steps] for k, c in ops.most_common(30)]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--n", default="1,8")
    ap.add_argument("--recipes", default="bf16,occ_bf16")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--after", type=int, default=64)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    from plnerf_torch.cli import run_plnerf
    from plnerf_torch.data.synthetic import write_sphere_scene

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    out = []
    with tempfile.TemporaryDirectory(prefix="plnerf_ab_") as tmp:
        write_sphere_scene(os.path.join(tmp, "sphere"), SIZE, VIEWS)
        for name in args.recipes.split(","):
            cfg, extra = RECIPES[name]
            for n in (int(x) for x in args.n.split(",")):
                exp = f"{name}_n{n}"
                t0 = time.perf_counter()
                run_plnerf.main([
                    "--config", os.path.join(root, "configs", cfg),
                    "--task", "train", "--ckpt_dir", tmp, "--expname", exp,
                    "--data_dir", tmp, "--scene_id", "sphere",
                    "--steps_per_dispatch", str(n), "--precrop_iters", "30",
                    "--constant_init", "60", "--i_print", str(PRINT),
                    "--i_weights", str(args.steps), "--i_img", "1000000",
                    "--i_testset", "1000000", "--i_video", "1000000",
                    "--num_iterations", str(args.steps)] + extra
                    + (["--profile", "8"] if args.profile else []))
                torch.cuda.synchronize()
                rec = {"label": args.label, "root": root, "recipe": name,
                       "n": n, "steps": args.steps, "after": args.after,
                       "ms_per_step": ms_per_step(os.path.join(
                           tmp, exp, "metrics.jsonl"), args.after),
                       "run_s": time.perf_counter() - t0}
                if args.profile:
                    (trace,) = glob.glob(os.path.join(tmp, exp, "profile",
                                                      "trace_*.json"))
                    rec["per_step"] = host_work(trace, 8)
                print(json.dumps(rec), flush=True)
                out.append(rec)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "a") as f:
            for rec in out:
                f.write(json.dumps(rec) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
