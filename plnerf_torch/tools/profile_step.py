"""Profile the port's NVS train step and print the top device ops: the
port of ``tools/profile_step.py`` (``torch.profiler`` in place of the
TPU's xplane trace, read by ``utils/profile.py``).

    python -m plnerf_torch.tools.profile_step [--mode linear|constant]
        [--rays 8192] [--steps 20] [--remat] [--occ] [--grad_accum 1]
        [--fused] [--mlp_dtype bfloat16] [--top 30] [--out DIR]
        [--device cpu]

Flagship widths (two 8x256 MLPs, 128 + 64 samples in linear mode, 64 +
128 in constant), white background, perturb on, on a fixed batch of
random rays.  ``--grad_accum`` is the step's ``accum_chunks``; ``--fused``
runs the MLP through the fused CUDA kernels with folded heads (the JAX
tool profiled the unfused path, its default).  Prints ms/step without the
profiler, then per step under it: device ms by kernel group, the device's
busy share of the wall time, and the top device and host ops (where the
host spends the time between kernels).  ``--out DIR`` writes a Chrome
trace to ``DIR/trace.json`` and reads it back: every host wait on the
device grouped by the ops around it, and the device's idle gaps.
``--occ`` profiles the occupancy-grid step (``make_occ_train_step``: 32
grid-guided coarse samples, a 128^3 grid with 96 candidate bins over the
box [-1.5, 1.5]^3, updated every step), as the JAX tool does.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import List, Optional

import torch

from ..core import occgrid as og
from ..core.config import ModelConfig, RenderConfig
from ..core.rays import pack_rays
from ..device import DeviceLike, resolve_device
from ..train.step import (TrainSetup, init_state, make_occ_train_step,
                          make_train_step)
from ..utils.profile import (profile_steps, trace_device_gaps,
                             trace_host_syncs)


def make_setup(mode: str = "linear", remat: bool = False,
               grad_accum: int = 1, mlp_dtype: str = "bfloat16",
               fused: bool = False,
               mcfg: ModelConfig = ModelConfig(),
               occ: bool = False) -> TrainSetup:
    ns, ni = (128, 64) if mode == "linear" else (64, 128)
    occ_cfg = None
    if occ:
        occ_cfg = og.OccGridConfig(resolution=128, candidates=96)
        ns = 32
    rcfg = RenderConfig(n_samples=ns, n_importance=ni, mode=mode,
                        white_bkgd=True, perturb=True, mlp_dtype=mlp_dtype,
                        remat_mlp=remat, use_fused_mlp=fused,
                        fused_fold_heads=fused, occ=occ_cfg)
    return TrainSetup(mcfg=mcfg, rcfg=rcfg, accum_chunks=grad_accum)


def make_batch(n: int, device: torch.device) -> dict:
    """Random rays near the origin, directions on the sphere, near 2, far
    6, target grey."""
    g = torch.Generator(device=device).manual_seed(1)
    d = torch.nn.functional.normalize(
        torch.randn(n, 3, generator=g, device=device), dim=-1)
    o = torch.randn(n, 3, generator=g, device=device) * 0.1
    return {"rays": pack_rays(o, d, 2.0, 6.0, d),
            "target": torch.full((n, 3), 0.5, device=device)}


def profile(setup: TrainSetup, rays: int, steps: int, device: DeviceLike,
            top: int = 30, out: Optional[str] = None) -> dict:
    """ms/step of ``steps`` steps after 3 settling steps, then the same
    count under the profiler (``utils.profile.profile_steps``)."""
    device = resolve_device(device)
    state = init_state(torch.Generator(device=device).manual_seed(0), setup,
                       device)
    batch = make_batch(rays, device)
    g = torch.Generator(device=device).manual_seed(2)
    metrics = {}
    if setup.rcfg.occ is None:
        step = make_train_step(setup)

        def run():
            nonlocal state, metrics
            state, metrics = step(state, batch, g)
    else:
        occ_step = make_occ_train_step(setup)
        grid = og.init_grid([-1.5] * 3, [1.5] * 3, setup.rcfg.occ, device)

        def run():
            nonlocal state, grid, metrics
            state, grid, metrics = occ_step(state, grid, batch, g)

    for _ in range(3):
        run()
        float(metrics["loss"])
    t0 = time.perf_counter()
    for _ in range(steps):
        run()
    loss = float(metrics["loss"])             # synchronises
    dt = time.perf_counter() - t0
    trace = None
    if out:
        os.makedirs(out, exist_ok=True)
        trace = os.path.join(out, "trace.json")
    prof = profile_steps(run, steps, device, top=top, trace_path=trace)
    res = {"device": (torch.cuda.get_device_name(device)
                      if device.type == "cuda" else "cpu"),
           "rays": rays, "steps": steps, "ms_per_step": dt / steps * 1e3,
           "loss": loss, "profile": prof}
    if "occ_ray_frac" in metrics:
        res["occ_ray_frac"] = float(metrics["occ_ray_frac"])
    if trace:
        with open(trace) as f:
            tr = json.load(f)
        res["host_syncs"] = trace_host_syncs(tr)
        res["device_gaps"] = trace_device_gaps(tr)
    return res


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mode", default="linear",
                    choices=["linear", "constant"])
    ap.add_argument("--rays", type=int, default=8192)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--occ", action="store_true")
    ap.add_argument("--grad_accum", type=int, default=1)
    ap.add_argument("--fused", action="store_true")
    ap.add_argument("--mlp_dtype", default="bfloat16",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--out", default=None)
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA device; 'cpu' runs on the CPU")
    args = ap.parse_args(argv)
    setup = make_setup(args.mode, args.remat, args.grad_accum,
                       args.mlp_dtype, args.fused, occ=args.occ)
    res = profile(setup, args.rays, args.steps, args.device, args.top,
                  args.out)
    p = res["profile"]
    print(f"[profile] {res['device']}: {args.steps} steps of {args.rays} "
          f"rays, {res['ms_per_step']:.2f} ms/step (loss {res['loss']:.4f}); "
          f"under the profiler {p['wall_ms_per_step']:.2f} ms/step")
    if p["device_ms_per_step"] is not None:
        print(f"[profile] device {p['device_ms_per_step']:.2f} ms/step, "
              f"busy share {p['device_busy_share']:.3f}; by group "
              + ", ".join(f"{k} {v:.2f}" for k, v in
                          p["ms_per_step"].items()))
    print("[profile] top device ops, ms/step:")
    for name, ms in p["top_device_ops"]:
        print(f"  {ms:9.3f}  {name}")
    print("[profile] top host ops (self CPU time), ms/step:")
    for name, ms in p["top_host_ops"]:
        print(f"  {ms:9.3f}  {name}")
    if "host_syncs" in res:
        print(f"[profile] host waits on the device over {args.steps} steps "
              "(ms, count, op chain):")
        for chain, n, ms in res["host_syncs"]:
            print(f"  {ms:9.3f}  x{n:<3d} {chain}")
        g = res["device_gaps"]
        print(f"[profile] device idle: {g['gaps']} gaps > 0.2 ms, "
              f"{g['idle_ms']:.2f} ms of {g['span_ms']:.2f} ms")
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
