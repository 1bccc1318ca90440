"""Per-dot-shape decomposition of the fused forward kernel on Hopper: the
port of ``tools/dot_decompose.py`` onto the probe kernels of
``kernels/csrc/dot_probe.cu``.

    python -m plnerf_torch.tools.dot_decompose [--what shapes,mixed,merged,real]
        [--tile 128] [--rows 2629632] [--device cpu]

The fused forward kernel runs, per row tile, this dot walk (bf16
operands, fp32 sums; the TPU probe's padding, input 63 -> 128):

    1x [T,128]@[128,256]   L0 (embedded x)
    4x [T,256]@[256,256]   L1-L4
    1x [T,128]@[128,256] + 1x [T,256]@[256,256]   L5 skip (split blocks)
    2x [T,256]@[256,256]   L6, L7
    1x [T,256]@[256,384]   fused feature|alpha head
    1x [T,256]@[256,128] + 1x [T,128]@[128,128]   views layer (split)
    1x [T,128]@[128,128]   rgb head

Experiments, at N_ROWS = 8192 x 321 rows unless ``--rows``:
  A. (shapes) each (K, n) of the walk alone, 13 dots per tile: TFLOP/s
     per shape, and the walk time the shapes predict, the sum of count x
     per-pass time.
  B. (mixed) the walk itself, same dots, no bias or relu: does the sum
     predict it, or does switching between shapes cost?
  D. (mixed) the row-tile knob on B: every tile the kernel takes.
  E. (merged) the skip and views layers as one [T, 384] dot each, the
     operand a scratch buffer written in place or a fresh concatenation
     per use, beside B and the two 384-deep shapes.
  C. (real) the real forward, ``fused_mlp.forward_cuda`` in bf16 at N rows,
     split and folded heads, weights from ``NeRF(ModelConfig(), g)``.

If B ~= sum(A) ~= C, the gap to the bound is the per-shape rate of the
product code; if B >> sum(A), switching between shapes costs; if C >> B,
what the real kernel adds (bias, relu, heads, stores) costs.  A, B, C and
E run one product code (``wgmma``, ``kernels/csrc/wgmma_core.cuh``), so
they compare like with like.

Dropped from the TPU tool, with no counterpart here: the SIGALRM watchdog
(its ``bench``), which skipped an experiment when the TPU's remote relay
stalled (a CUDA call returns or raises), and ``dimension_semantics``, a
Mosaic compiler parameter for the order of the grid (CUDA blocks run in
parallel, in no order), so D keeps only the row tile.

Every experiment is a function of ``(n_rows, device)`` that returns a
dict.  On a CUDA device times are CUDA-event medians; with
``device="cpu"`` the plain versions run and times are CPU times, never a
device metric.
"""
from __future__ import annotations

import argparse
import json
from typing import List, Optional

import torch

from ..core.config import ModelConfig
from ..core.mlp import NeRF
from ..device import DeviceLike, resolve_device
from ..kernels import dot_probe, fused_mlp
from ..utils.profile import timed_ms

N_ROWS = 8192 * 321
T = 128                     # default row tile (the TPU tool's was 512)
REPS = dot_probe.MAX_REPS   # dots per tile in experiment A
# the forward's dot walk: (K, n_out, count)
WALK = [
    (128, 256, 2),   # L0 + skip x-block
    (256, 256, 7),   # L1-L4, skip h-block, L6, L7
    (256, 384, 1),   # fused feature|alpha head
    (256, 128, 1),   # views-layer feature block
    (128, 128, 2),   # views-layer v block + rgb head
]
MIXED_SHAPES = dot_probe.MIXED_SHAPES
MERGED_SHAPES = dot_probe.MERGED_SHAPES


def inputs(n_rows: int, k: int, shapes, device: torch.device, seed: int = 0):
    """x [n_rows, k] ~ N(0, 1) and weights ~ 0.05 N(0, 1), all bf16."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(n_rows, k, generator=g, device=device).to(torch.bfloat16)
    ws = [torch.randn(*s, generator=g, device=device).to(torch.bfloat16)
          * 0.05 for s in shapes]
    return x, ws


def _timed(fn, device: torch.device) -> float:
    return timed_ms(fn, device, 5 if device.type == "cuda" else 1)


def _rate(flops: float, ms: float) -> float:
    return flops / ms / 1e9


def run_shape(k: int, n_out: int, reps: int, tile: int, n_rows: int,
              device: torch.device) -> dict:
    x, ws = inputs(n_rows, k, [(k, n_out)] * reps, device)
    ms = _timed(lambda: dot_probe.run_shape(x, ws, tile), device)
    flops = 2.0 * n_rows * k * n_out * reps
    return {"shape": [k, n_out], "reps": reps, "tile": tile, "ms": ms,
            "per_pass_ms": ms / reps, "tflop_per_s": _rate(flops, ms)}


def run_mixed(tile: int, n_rows: int, device: torch.device) -> dict:
    x, ws = inputs(n_rows, 128, MIXED_SHAPES, device)
    ms = _timed(lambda: dot_probe.run_mixed(x, ws, tile), device)
    flops = 2.0 * n_rows * sum(k * n for k, n in MIXED_SHAPES)
    return {"walk": "mixed", "tile": tile, "ms": ms,
            "tflop_per_s": _rate(flops, ms)}


def run_merged(tile: int, use_concat: bool, n_rows: int,
               device: torch.device) -> dict:
    x, ws = inputs(n_rows, 128, MERGED_SHAPES, device)
    ms = _timed(lambda: dot_probe.run_merged(x, ws, tile, use_concat),
                device)
    flops = 2.0 * n_rows * sum(k * n for k, n in MERGED_SHAPES)
    return {"walk": "merged", "operand": "concat" if use_concat else
            "scratch", "tile": tile, "ms": ms,
            "tflop_per_s": _rate(flops, ms)}


def run_real_forward(fold: bool, n_rows: int, device: torch.device) -> dict:
    cfg = ModelConfig()
    g = torch.Generator(device=device).manual_seed(0)
    model = NeRF(cfg, g, device=device)
    x = torch.randn(n_rows, cfg.input_ch, generator=g, device=device)
    v = torch.randn(n_rows, cfg.input_ch_views, generator=g, device=device)
    with torch.no_grad():
        p, xp, vp, v_div = fused_mlp.prepare(model, x, v, cfg,
                                             torch.bfloat16, fold)
    ms = _timed(lambda: fused_mlp.forward(p, xp, vp, v_div), device)
    return {"walk": "real forward", "heads": "folded" if fold else "split",
            "ms": ms}


def experiment_shapes(n_rows: int, device: DeviceLike,
                      tile: int = T) -> dict:
    """A: every shape of the walk, 13 dots per tile."""
    device = resolve_device(device)
    shapes = [run_shape(k, n, REPS, tile, n_rows, device)
              for k, n, _ in WALK]
    predicted = sum(c * r["per_pass_ms"] for (_, _, c), r in
                    zip(WALK, shapes))
    return {"experiment": "A", "tile": tile, "shapes": shapes,
            "predicted_walk_ms": predicted}


def experiment_mixed(n_rows: int, device: DeviceLike, tile: int = T) -> dict:
    """B: the 13-dot walk."""
    return {"experiment": "B",
            **run_mixed(tile, n_rows, resolve_device(device))}


def _walk(b: dict) -> dict:
    """B's result as one walk of D or E."""
    return {k: v for k, v in b.items() if k != "experiment"}


def experiment_tiles(n_rows: int, device: DeviceLike,
                     b: Optional[dict] = None) -> dict:
    """D: the walk at every row tile; B's result, when given, stands for
    its own tile."""
    device = resolve_device(device)
    return {"experiment": "D", "mixed": [
        _walk(b) if b is not None and b["tile"] == t
        else run_mixed(t, n_rows, device) for t in dot_probe.TILES]}


def experiment_merged(n_rows: int, device: DeviceLike, tile: int = T,
                      b: Optional[dict] = None) -> dict:
    """E: the 11-dot walk, scratch at ``tile`` and, like for like, scratch
    and concat at every tile concat takes; beside the split walk (B's
    result, when given at ``tile``) and the two 384-deep shapes."""
    device = resolve_device(device)
    merged = [run_merged(tile, False, n_rows, device)]
    for t in dot_probe.CONCAT_TILES:
        if t != tile:
            merged.append(run_merged(t, False, n_rows, device))
        merged.append(run_merged(t, True, n_rows, device))
    split = (_walk(b) if b is not None and b["tile"] == tile
             else run_mixed(tile, n_rows, device))
    return {"experiment": "E", "split": split,
            "shapes": [run_shape(k, n, REPS, tile, n_rows, device)
                       for k, n in ((384, 256), (384, 128))],
            "merged": merged}


def experiment_real(n_rows: int, device: DeviceLike) -> dict:
    """C: the fused forward kernel in bf16, split and folded heads."""
    device = resolve_device(device)
    return {"experiment": "C", "forward": [
        run_real_forward(fold, n_rows, device) for fold in (False, True)]}


def _describe(r: dict) -> str:
    rate = (f"  {r['tflop_per_s']:7.1f} TFLOP/s" if "tflop_per_s" in r
            else "")
    what = (f"shape K={r['shape'][0]:3d} n={r['shape'][1]:3d} x{r['reps']}"
            if "shape" in r else " ".join(
                str(r[k]) for k in ("walk", "operand", "heads") if k in r))
    tile = f" tile={r['tile']}" if "tile" in r else ""
    return f"  {what}{tile}: {r['ms']:9.3f} ms{rate}"


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--what", default="shapes,mixed,real",
                    help="comma list of shapes, mixed, merged, real")
    ap.add_argument("--tile", type=int, default=T, choices=dot_probe.TILES)
    ap.add_argument("--rows", type=int, default=N_ROWS)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA device; 'cpu' runs the plain "
                         "versions")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    what = set(args.what.split(","))
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu (plain versions, CPU times)")
    print(f"device: {name}, rows {args.rows}, tile {args.tile}", flush=True)
    out = {}
    if "shapes" in what:
        out["A"] = experiment_shapes(args.rows, dev, args.tile)
        print("=== A. per-shape throughput ===")
        for r in out["A"]["shapes"]:
            print(_describe(r) + f"  {r['per_pass_ms']:7.3f} ms per pass")
        print(f"--- predicted walk time: {out['A']['predicted_walk_ms']:.3f} "
              "ms (sum of count x per-shape pass) ---", flush=True)
    if "mixed" in what:
        out["B"] = experiment_mixed(args.rows, dev, args.tile)
        out["D"] = experiment_tiles(args.rows, dev, out["B"])
        print("=== B. mixed-shape walk ===\n" + _describe(out["B"]))
        print("=== D. row tile ===")
        for r in out["D"]["mixed"]:
            print(_describe(r))
    if "merged" in what:
        out["E"] = experiment_merged(args.rows, dev, args.tile, out.get("B"))
        print("=== E. merged skip and views ===")
        for r in [out["E"]["split"]] + out["E"]["shapes"] + \
                out["E"]["merged"]:
            print(_describe(r))
    if "real" in what:
        out["C"] = experiment_real(args.rows, dev)
        print("=== C. real forward kernel (bf16) ===")
        for r in out["C"]["forward"]:
            print(_describe(r))
    print(json.dumps({"device": name, "rows": args.rows, **out}), flush=True)
    return out


if __name__ == "__main__":
    main()
