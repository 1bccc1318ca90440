"""What each part of the bf16 fused-MLP backward costs on the card:
variants of ``csrc/fused_mlp_bwd.cu`` with one part taken out, timed
beside the source as it is, on the same inputs, interleaved.

    python -m plnerf_torch.tools.bwd_ablate [--variants a,b] [--rounds 6]
        [--reps 5] [--rays 1024] [--samples 192] [--out OUT.json]

Each variant is the source with the textual replacements of ``VARIANTS``
applied (a replacement that does not match raises, so a variant never
times the source unchanged), compiled with nvcc into a temporary
directory.  The variants compute wrong grads: they exist to be timed.
For the split and folded heads of the 8x256 viewdirs MLP at ``--rays`` x
``--samples`` points, seeded, every variant's library is called through
ctypes as ``bwd_ab`` calls one, ``--rounds`` rounds of every variant in
turn, each ``--reps`` calls timed by CUDA events; per variant the median,
min and max ms per call.  Prints one JSON line and, with ``--out``,
writes it.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import torch

from plnerf_torch.core.config import ModelConfig
from plnerf_torch.core.encoding import embed
from plnerf_torch.core.mlp import NeRF
from plnerf_torch.kernels import build, fused_mlp
from plnerf_torch.tools.bwd_ab import caller, event_ms

# name: [(text, replacement), ...] on csrc/fused_mlp_bwd.cu
VARIANTS = {
    "base": [],
    # the data pass writes no acts / dacts image (the weight pass reads
    # whatever the workspace held)
    "no_image_stores": [("bulk_store(", "if (false) bulk_store(")],
    # no relu-mask bits recorded or applied (and so no relu): every
    # epilogue into T the plain one
    "no_masks": [("const int mode = q.mset >= 0 ? M_RECORD : q.mget >= 0 ? "
                  "M_APPLY : M_PLAIN;", "const int mode = M_PLAIN;")],
    # the mask bits not recorded in the recompute / not applied to the
    # data grads (the other half kept)
    "no_mask_record": [("      if (MODE == M_RECORD)\n        pos[j >> 3] |=",
                        "      if (false)\n        pos[j >> 3] |=")],
    "no_mask_apply": [("if (MODE == M_APPLY) {\n        // where",
                       "if (false) {\n        // where")],
    # the data pass's products without their in-place epilogues: the walk
    # of wgmmas and the weight stream alone
    "no_tile_epilogue": [("  if (c.tid == 0) bulk_wait_read<0>();\n"
                          "  wg_sync(c.wg);\n",
                          "  return;\n")],
    # a 4-stage weight ring in the data pass (6 fit at 8x256)
    "data_ring_4": [("const int nstage = data_stages(y);",
                     "const int nstage = data_stages(y) < 4 ? "
                     "data_stages(y) : 4;")],
    # the weight pass: 2 ring stages, 4 waves of chunks (not 8), no db
    # sums
    "weight_ring_2": [("WM = 128, WN = 256, WSTAGES = 4;",
                       "WM = 128, WN = 256, WSTAGES = 2;")],
    "weight_waves_4": [("constexpr int W_WAVES = 8;",
                        "constexpr int W_WAVES = 4;")],
    "weight_no_db": [("const bool summer = dn > 0 && rs < nrs;",
                      "const bool summer = false;")],
}


def variant_source(src: str, reps) -> str:
    for old, new in reps:
        if old not in src:
            raise ValueError(f"variant text not in the source: {old[:60]!r}")
        src = src.replace(old, new)
    return src


def note(msg: str) -> None:
    print(f"[bwd_ablate {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr,
          flush=True)


def build_variant(name: str, reps, tmp: str) -> str:
    d = os.path.join(tmp, name)
    os.makedirs(d)
    for f in os.listdir(build.CSRC):
        if f.endswith(".cuh"):
            shutil.copy(os.path.join(build.CSRC, f), d)
    with open(os.path.join(build.CSRC, "fused_mlp_bwd.cu")) as f:
        src = variant_source(f.read(), reps)
    with open(os.path.join(d, "fused_mlp_bwd.cu"), "w") as f:
        f.write(src)
    out = os.path.join(d, "libfused_mlp_bwd.so")
    proc = subprocess.run([build.nvcc_path()] + build.NVCC_FLAGS + [
        "-o", out, os.path.join(d, "fused_mlp_bwd.cu")],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for variant {name}:\n{proc.stderr}")
    note(f"built {name}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--rays", type=int, default=1024)
    ap.add_argument("--samples", type=int, default=192)
    ap.add_argument("--out")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bwd_ablate needs a CUDA device", file=sys.stderr)
        return 1
    names = a.variants.split(",")
    dev = torch.device("cuda")
    tmp = tempfile.mkdtemp(prefix="plnerf_bwd_ablate_")
    try:
        with ThreadPoolExecutor(len(names)) as ex:
            paths = list(ex.map(lambda k: build_variant(k, VARIANTS[k], tmp),
                                names))
        libs = {k: ctypes.CDLL(path) for k, path in zip(names, paths)}
        cfg = ModelConfig()
        out = {"card": subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip(), "points": a.rays * a.samples,
            "rounds": a.rounds, "reps": a.reps, "cases": {}}
        for fold in (False, True):
            g = torch.Generator(device=dev).manual_seed(6)
            m = NeRF(cfg, g, device=dev)
            pts = torch.randn(a.rays, a.samples, 3, generator=g, device=dev)
            vd = torch.nn.functional.normalize(
                torch.randn(a.rays, 3, generator=g, device=dev), dim=-1)
            with torch.no_grad():
                p, x, v, v_div = fused_mlp.prepare(
                    m, embed(pts, cfg.multires, cfg.pi_bands),
                    embed(vd, cfg.multires_views, cfg.pi_bands)[:, None, :],
                    cfg, torch.bfloat16, fold)
                cot = torch.randn(x.shape[0], 4, device=dev,
                                  generator=torch.Generator(
                                      device=dev).manual_seed(7))
                runs = {k: caller(lib, p, x, v, v_div, cot)
                        for k, lib in libs.items()}
                for k, r in runs.items():
                    r()
                    torch.cuda.synchronize()
                    note(f"{'folded' if fold else 'split'} {k} ran")
                ms = {k: [] for k in runs}
                for _ in range(a.rounds):
                    for k in names:
                        ms[k].append(event_ms(runs[k], a.reps))
            out["cases"]["folded" if fold else "split"] = {
                k: {"median_ms": statistics.median(v), "min_ms": min(v),
                    "max_ms": max(v)} for k, v in ms.items()}
            del runs, p, x, v, cot, m
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    line = json.dumps(out)
    print(line)
    if a.out:
        with open(a.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
