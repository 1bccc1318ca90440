"""Serving-artifact time against the in-process eval renderer (port of
``tools/serving_bench.py``):

    python -m plnerf_torch.tools.serving_bench --out DIR/serving.json \\
        [--rounds 3] [--size 800] [--chunk 32768] [--device cpu]

One image of ``--size`` squared pixels, the linear flagship recipe at full
width (two 8x256 MLPs, 128 + 64 samples, perturb on), bf16 on the fused
kernels, chunk 32768, random weights from seed 0: the artifact's
``render_image`` (baked weights through the whole-batch module, the
``args`` weights through it, the baked chunk path, the baked whole-batch
module fetching ``rgb_map`` only) against ``eval.images.render_image``,
each the best of ``--rounds`` after two warm-up calls.  Writes one JSON
line to ``--out``.  Runs on the CUDA device; the CPU only with ``--device
cpu`` and a ``--size`` of at most 64.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import tempfile
import time

import numpy as np
import torch

from ..core.config import ModelConfig, RenderConfig
from ..core.mlp import NeRF
from ..device import make_generator, resolve_device
from ..eval import images as EI
from ..serving import export as SE
from ..serving.runtime import ServingRenderer

CPU_MAX_SIZE = 64


def card() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        return "not read"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--chunk", type=int, default=32768)
    ap.add_argument("--size", type=int, default=800, help="image H = W")
    ap.add_argument("--device", default=None, choices=["cpu", "cuda"])
    ap.add_argument("--out", required=True, help="path of the JSON line")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cpu" and args.size > CPU_MAX_SIZE:
        raise SystemExit(f"--device cpu: --size {args.size} is a card's "
                         f"load; at most {CPU_MAX_SIZE} on the CPU")

    mcfg = ModelConfig()
    rcfg = RenderConfig(n_samples=128, n_importance=64, mode="linear",
                        white_bkgd=True, perturb=True, mlp_dtype="bfloat16",
                        use_fused_mlp=True, fused_fold_heads=True)
    g = make_generator(0, dev)
    pc, pf = NeRF(mcfg, g, dev), NeRF(mcfg, g, dev)
    H = W = args.size
    n = H * W

    arts, export_s, load_s = {}, {}, {}
    for mode in ("baked", "args"):
        art = tempfile.mkdtemp(prefix=f"serve_bench_{mode}_")
        t0 = time.perf_counter()
        SE.export_renderer(pc, pf, mcfg, rcfg, art, chunk=args.chunk,
                           fused_n_rays=n, weights_mode=mode)
        export_s[mode] = time.perf_counter() - t0
        t0 = time.perf_counter()
        arts[mode] = ServingRenderer.load(art, device=dev)
        load_s[mode] = time.perf_counter() - t0

    focal = 0.5 * W / np.tan(0.25)
    K = np.array([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1]],
                 np.float32)
    c2w = np.eye(4, dtype=np.float32)[:3]
    c2w[2, 3] = 4.0
    hwf = (H, W, focal)

    def served(srv, **kw):
        return lambda: srv.render_image(c2w, hwf, K, **kw)

    def chunked():
        srv = arts["baked"]
        fused, srv._fused = srv._fused, None
        try:
            return srv.render_image(c2w, hwf, K)
        finally:
            srv._fused = fused

    def inproc():
        with torch.no_grad():
            return EI.render_image(pc, pf, c2w, hwf, K, mcfg, rcfg, seed=3,
                                   chunk=args.chunk)

    paths = {}
    for name, fn in (("serving-fused", served(arts["baked"])),
                     ("serving-fused-args", served(arts["args"])),
                     ("serving-fused-rgbonly",
                      served(arts["baked"], keys=["rgb_map"])),
                     ("serving-chunked", chunked), ("inprocess", inproc)):
        fn()
        fn()
        best = float("inf")
        for _ in range(args.rounds):
            t0 = time.perf_counter()
            out = fn()                       # numpy maps: synchronized
            best = min(best, time.perf_counter() - t0)
        assert np.isfinite(out["rgb_map"]).all(), name
        paths[name] = {"s_per_img": best, "rays_per_sec": n / best}
        print(f"[serving_bench] {name}: {best:.4f} s/img", flush=True)

    row = {"tool": "serving_bench", "device": dev.type,
           "card": card() if dev.type == "cuda" else None,
           "torch": torch.__version__, "size": H, "chunk": args.chunk,
           "rounds": args.rounds, "export_s": export_s, "load_s": load_s,
           "paths": paths}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.write(json.dumps(row) + "\n")
    print(json.dumps(row), flush=True)
    return row


if __name__ == "__main__":
    main()
