"""Fused-MLP kernel times against the unfused cuBLAS MLP: the port of
``tools/bench_kernel.py``.

    python -m plnerf_torch.tools.bench_kernel [--n 2629632]
        [--what fwd,fwdbwd,bwd] [--fold both|on|off] [--no-unfused]
        [--device cpu]

Forward and forward + backward (loss: the sum of raw) of the flagship
8x256 viewdirs MLP in bf16 at N points (default 8192 rays x 321 samples),
inputs ~ N(0, 1) per point:

* the unfused ``core.mlp.apply_mlp`` (cuBLAS), the path without
  ``use_fused_mlp``;
* the fused kernels (``kernels.fused_mlp.apply``), split and folded heads.

Forward + backward folds the loss and every parameter grad into one
value (``pair_fn``, the TPU tool's ``_pair_fn``), so the forward is part
of what is timed.  The TPU tool's ``--tiles`` has no counterpart: the
CUDA kernels' row tile is fixed when they are compiled.  Times are
CUDA-event medians on a CUDA device; with ``device="cpu"`` the plain
versions run and times are CPU times, never a device metric.

``--what bwd`` (``bwd_ways``, CUDA only) times the fp32 backward kernel
alone at one fine pass of a 1024-ray training step (1024 rays x 192
samples, per-ray views) both ways: reading the activations the forward
kept (``saved``, as training calls it) and the standalone call, which
recomputes them by running the forward first (``recompute``); five
rounds of recompute, saved, saved, recompute, and says whether the two
give bit-equal grads.
"""
from __future__ import annotations

import argparse
import json
import statistics
from typing import Callable, List, Optional, Sequence

import torch

from ..core.config import ModelConfig
from ..core.mlp import NeRF, apply_mlp
from ..device import DeviceLike, resolve_device
from ..kernels import fused_mlp
from ..utils.profile import timed_ms

N = 8192 * 321
BWD_RAYS, BWD_SAMPLES = 1024, 192


def pair_fn(loss: Callable[[], torch.Tensor],
            params: Sequence[torch.Tensor]) -> torch.Tensor:
    """The loss plus the sum of every grad of it: one value that needs the
    forward and the backward."""
    with torch.enable_grad():
        val = loss()
        grads = torch.autograd.grad(val, list(params))
    return val.detach() + sum(g.sum() for g in grads)


def run(cfg: ModelConfig, n: int, device: DeviceLike,
        what: Sequence[str] = ("fwd", "fwdbwd"),
        folds: Sequence[bool] = (False, True),
        unfused: bool = True) -> List[dict]:
    """One dict per timed function: label, ms and the value it returns."""
    device = resolve_device(device)
    reps = 3 if device.type == "cuda" else 1
    g = torch.Generator(device=device).manual_seed(0)
    model = NeRF(cfg, g, device=device)
    x = torch.randn(n, cfg.input_ch, generator=g, device=device)
    v = torch.randn(n, cfg.input_ch_views, generator=g, device=device)
    params = list(model.parameters())
    dt = torch.bfloat16

    paths = []
    if unfused:
        paths.append(("unfused", lambda: apply_mlp(model, x, v, cfg, dt)))
    for fold in folds:
        paths.append((f"fused fold={int(fold)}",
                      lambda f=fold: fused_mlp.apply(model, x, v, cfg, dt,
                                                     fold_heads=f)))
    out = []
    for name, mlp in paths:
        fns = {"fwd": lambda m=mlp: m().sum(),
               "fwdbwd": lambda m=mlp: pair_fn(lambda: m().sum(), params)}
        for kind in what:
            with torch.no_grad():
                ms = timed_ms(fns[kind], device, reps)
                value = float(fns[kind]())
            out.append({"label": f"{name} {kind}", "ms": ms, "value": value})
    return out


def bwd_ways(cfg: ModelConfig, device: DeviceLike,
             folds: Sequence[bool] = (False, True), rounds: int = 5,
             rays: int = BWD_RAYS, samples: int = BWD_SAMPLES) -> List[dict]:
    """One dict per head schedule and way (``saved``, ``recompute``) of
    the fp32 backward kernel at ``rays`` x ``samples`` points: label, the
    median ms of its rounds and whether the two ways' grads, dx and dv
    are bit-equal."""
    device = resolve_device(device)
    if device.type != "cuda":
        raise ValueError("the fp32 backward's two ways are the kernel's: "
                         "bwd needs a CUDA device")
    g = torch.Generator(device=device).manual_seed(0)
    model = NeRF(cfg, g, device=device)
    x = torch.randn(rays, samples, cfg.input_ch, generator=g, device=device)
    v = torch.randn(rays, 1, cfg.input_ch_views, generator=g, device=device)
    out = []
    for fold in folds:
        with torch.no_grad():
            p, xp, vp, v_div = fused_mlp.prepare(model, x, v, cfg,
                                                 torch.float32, fold)
            cot = torch.randn(xp.shape[0], 4, generator=g, device=device)
            acts = xp.new_empty((xp.shape[0], fused_mlp.acts_cols(p)))
            fused_mlp.forward_cuda(p, xp, vp, v_div, acts)
            ways = {"saved": lambda: fused_mlp.backward_cuda(
                        p, xp, vp, v_div, cot, acts),
                    "recompute": lambda: fused_mlp.backward_cuda(
                        p, xp, vp, v_div, cot)}
            got = {k: f() for k, f in ways.items()}
            equal = all(torch.equal(a, b) for a, b in zip(
                *(r[0] + r[1] + [r[2], r[3]] for r in got.values())))
            ms = {k: [] for k in ways}
            for _ in range(rounds):
                for k in ("recompute", "saved", "saved", "recompute"):
                    ms[k].append(timed_ms(ways[k], device, 1))
        out += [{"label": f"fp32 bwd fold={int(fold)} {k}",
                 "ms": statistics.median(t), "bit_equal": equal}
                for k, t in ms.items()]
    return out


def main(argv: Optional[List[str]] = None) -> List[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=N)
    ap.add_argument("--what", default="fwd,fwdbwd")
    ap.add_argument("--fold", default="both", choices=["both", "on", "off"],
                    help="head schedule of the fused kernels: folded, "
                         "split or both")
    ap.add_argument("--unfused", action="store_true", default=True)
    ap.add_argument("--no-unfused", dest="unfused", action="store_false")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA device; 'cpu' runs on the CPU")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    folds = {"both": (False, True), "on": (True,), "off": (False,)}[args.fold]
    kinds = args.what.split(",")
    rest = [k for k in kinds if k != "bwd"]
    cfg = ModelConfig()
    res = run(cfg, args.n, dev, rest, folds, args.unfused) if rest else []
    if "bwd" in kinds:
        res += bwd_ways(cfg, dev, folds)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    for r in res:
        tail = (f"bit-equal {r['bit_equal']}" if "bit_equal" in r
                else f"value {r['value']:.4e}")
        print(f"[{r['label']}] {r['ms']:.3f} ms ({tail})", flush=True)
    print(json.dumps({"device": name, "n": args.n, "runs": res}))
    return res


if __name__ == "__main__":
    main()
