"""Fused-MLP kernel times against the unfused cuBLAS MLP: the port of
``tools/bench_kernel.py``.

    python -m plnerf_torch.tools.bench_kernel [--n 2629632] [--what fwd,fwdbwd]
        [--fold both|on|off] [--no-unfused] [--device cpu]

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
"""
from __future__ import annotations

import argparse
import json
from typing import Callable, List, Optional, Sequence

import torch

from ..core.config import ModelConfig
from ..core.mlp import NeRF, apply_mlp
from ..device import DeviceLike, resolve_device
from ..kernels import fused_mlp
from ..utils.profile import timed_ms

N = 8192 * 321


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
    res = run(ModelConfig(), args.n, dev, args.what.split(","), folds,
              args.unfused)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    for r in res:
        print(f"[{r['label']}] {r['ms']:.3f} ms (value {r['value']:.4e})",
              flush=True)
    print(json.dumps({"device": name, "n": args.n, "runs": res}))
    return res


if __name__ == "__main__":
    main()
