"""The matmul-throughput probe on Hopper: the port of
``tools/mosaic_probe.py`` onto the ``mosaic`` kernel of
``kernels/csrc/dot_probe.cu``.

    python -m plnerf_torch.tools.mosaic_probe [--rows 2629632] [--device cpu]

Kernels that do nothing but 13 [T, 256] @ [256, 256] bf16 dots per row
tile (fp32 sums) on one weight set, at N = 8192 x 321 rows to match the
NeRF forward's work, at every row tile the kernel takes (independent,
the shape kernel at (256, 256) x 13, also at 256).  Variants: (a)
``chained``, a dependency chain like the MLP's; (b) ``independent``, 13
dots of x summed; (c) ``mlp``, chained with +0.01 and relu between dots
(the MLP's per-layer op).  On the TPU the weights were resident in VMEM;
here each CTA streams them from L2 through shared memory.  Times include
the wrapper's pack of the weights into the kernel's stream.

``experiment(n_rows, device)`` returns one dict per tile and variant.  On
a CUDA device times are CUDA-event medians; with ``device="cpu"`` the
plain version runs and times are CPU times, never a device metric.
"""
from __future__ import annotations

import argparse
import json
from typing import List, Optional

import torch

from ..device import DeviceLike, resolve_device
from ..kernels import dot_probe
from ..utils.profile import timed_ms
from . import dot_decompose

N = 8192 * 321
D = dot_probe.MOSAIC_DEPTH      # dots per tile pass (~ the MLP's count)
W = dot_probe.MOSAIC_WIDTH


def inputs(n_rows: int, device: torch.device, seed: int = 0):
    """x [n_rows, W] ~ N(0, 1) and D [W, W] weights ~ 0.05 N(0, 1), bf16."""
    return dot_decompose.inputs(n_rows, W, [(W, W)] * D, device, seed)


def run(x: torch.Tensor, ws, variant: str, tile: int) -> torch.Tensor:
    return dot_probe.run_mosaic(x, ws, tile, variant)


def experiment(n_rows: int, device: DeviceLike) -> List[dict]:
    device = resolve_device(device)
    x, ws = inputs(n_rows, device)
    flops = 2.0 * n_rows * W * W * D
    out = []
    for tile in dot_probe.SHAPE_TILES:
        for variant in dot_probe.VARIANTS:
            if tile not in dot_probe.mosaic_tiles(variant):
                continue
            ms = timed_ms(lambda: run(x, ws, variant, tile), device,
                          5 if device.type == "cuda" else 1)
            out.append({"tile": tile, "variant": variant, "ms": ms,
                        "tflop_per_s": flops / ms / 1e9})
    return out


def main(argv: Optional[List[str]] = None) -> List[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=N)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA device; 'cpu' runs the plain "
                         "version")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu (plain version, CPU times)")
    print(f"device: {name}, rows {args.rows}", flush=True)
    res = experiment(args.rows, dev)
    for r in res:
        print(f"tile {r['tile']} {r['variant']:12s}: {r['ms']:8.3f} ms  "
              f"{r['tflop_per_s']:6.1f} TFLOP/s", flush=True)
    print(json.dumps({"device": name, "rows": args.rows, "runs": res}))
    return res


if __name__ == "__main__":
    main()
