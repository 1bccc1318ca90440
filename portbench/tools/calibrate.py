"""Readings that the limits of ``limits/<workload>.json`` are set from;
not run by the benchmark's own runs.

    python3 portbench/tools/calibrate.py --workload W --seeds 1,2,3 \\
        --mode program|control|state_unchanged|half_batch|replay_unchanged

prints one JSON line per seed with the numbers that decide ``correct``:

* ``program``: the program as a run drives it (training: the first
  two windows against the reference; serving: the requests of a
  ``--seconds`` window);
* ``control``: the reference put in the program's place, computed in the
  next precision below the configuration's (TF32 for float32, float8
  e4m3 for bfloat16), against the reference;
* ``state_unchanged`` / ``half_batch`` / ``replay_unchanged``
  (training): the program with a step that leaves the state unchanged
  (no optimizer step), with half the batch left out and the mean taken
  over the rest, or with the second window's (the graph's first
  replay's) optimizer steps left out.

All in one process: set-up once per seed, the kernels built once.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".")
               != os.path.dirname(os.path.abspath(__file__))]
sys.path.insert(0, ROOT)

CONTROL = {"float32": "tf32", "bfloat16": "fp8"}


@contextlib.contextmanager
def fault(name: str, b):
    """Plant one of the training faults in the program for the block:
    ``b`` is the cell's train objects (``drivers/train.build``)."""
    from plnerf_torch.train import step as pstep

    multi = b.loop.multi
    saved_update, saved_one = pstep._update, multi.one
    if name == "state_unchanged":
        pstep._update = lambda state, opts, inputs: None
    elif name == "half_batch":
        def half(state, grid, batch, *a):
            n = batch["rays"].shape[0] // 2
            return saved_one(state, grid, {k: v[:n] for k, v in
                                           batch.items()}, *a)
        multi.one = half
    elif name == "replay_unchanged":
        # the second window (the graph's first replay) leaves the state
        # unchanged: its optimizer steps left out of the capture
        loop_step, calls = b.loop.step, []

        def step():
            calls.append(1)
            if len(calls) == 2:
                pstep._update = lambda state, opts, inputs: None
            try:
                return loop_step()
            finally:
                pstep._update = saved_update
        b.loop.step = step
    elif name != "program":
        raise SystemExit(f"unknown fault {name}")
    try:
        yield
    finally:
        pstep._update, multi.one = saved_update, saved_one
        b.loop.__dict__.pop("step", None)


def train_reading(ctx, mode: str) -> dict:
    """The gaps, and each checked step's loss on both sides."""
    from portbench.drivers import train
    from portbench.reference import check

    b = train.build(ctx)
    n, m = int(ctx.traffic["checked_steps"]), b.n_inner
    if mode == "control":
        gen_state = b.g.get_state().clone()
        b.state = b.loop = b.prog_grid = None
        low = train.follow(ctx, b, gen_state,
                           CONTROL[ctx.flags["mlp_dtype"]])
        at = low["params_at"]
        first = {"gen_state": gen_state, "prog": {
            "loss": low["loss"][:n], "params": at[n], "rgb1": low["rgb1"],
            "moment1": {k: v * (1 - check.BETA1)
                        for k, v in low["grad1"].items()},
            "replay": {"kind": "control", "loss": low["loss"][2 * m - 1],
                       "before": at[m], "after": at[2 * m]}}}
    else:
        with fault(mode, b):
            first = train.checked_windows(ctx, b)
        b.state = b.loop = b.prog_grid = None
    ref = train.follow(ctx, b, first["gen_state"])
    return dict(train.reference_gaps(ctx, b, first, ref),
                kind=first["prog"]["replay"]["kind"],
                loss=first["prog"]["loss"], loss_ref=ref["loss"][:n])


def render_reading(ctx, mode: str) -> dict:
    import torch

    from portbench.drivers import render

    if mode == "control":
        from portbench.reference import check, nerf
        from portbench.lib import scene as S

        weights = S.make_weights(ctx.flags, ctx.seed, ctx.device)
        grid = (S.sphere_grid(ctx.flags, ctx.device)
                if ctx.flags.get("occ_grid") else None)
        reqs = render.Requests(ctx)
        served = [reqs.get(i) for i in range(int(ctx.traffic_requests))]
        chunk = int(ctx.flags["chunk"])
        low = check.render_pixels(weights, grid, served, ctx.ref_flags,
                                  chunk, nerf.Precision(
                                      CONTROL[ctx.flags["mlp_dtype"]]),
                                  ctx.device)
        ref = check.render_pixels(weights, grid, served, ctx.ref_flags,
                                  chunk, nerf.Precision("fp32"), ctx.device)
        return dict(check.rgb_gaps(low, ref), requests=len(served))
    out = render.run(ctx)
    torch.cuda.empty_cache()
    return dict(out["checks"], requests=out["attempted"])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--mode", default="program")
    p.add_argument("--seconds", type=float, default=30.0)
    p.add_argument("--requests", type=int, default=0,
                   help="serving control: the requests compared per seed")
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)

    import torch

    from portbench.lib import harness

    cell = harness.Cell(a.workload)
    dev = torch.device(a.device)
    for mode in a.mode.split(","):
        for seed in [int(s) for s in a.seeds.split(",")]:
            t0 = time.perf_counter()
            ctx = harness.Ctx(cell, seed, a.seconds, False, dev, t0)
            ctx.traffic_requests = a.requests
            if cell.traffic["driver"] == "train":
                r = train_reading(ctx, mode)
            else:
                r = render_reading(ctx, mode)
            print(json.dumps({"workload": a.workload, "mode": mode,
                              "seed": seed, **r,
                              "s": time.perf_counter() - t0}), flush=True)
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
