"""Time this checkout's fused-MLP backward library beside another
checkout's, on the same inputs, interleaved, on one card.

    python -m plnerf_torch.tools.bwd_ab --other DIR [--rounds 8]
        [--reps 5] [--rays 1024] [--samples 192] [--out OUT.json]

``--other``: a checkout whose ``plnerf_torch/kernels/csrc/fused_mlp_bwd.cu``
is compiled with nvcc (its own headers beside it) into
``DIR/build/plnerf_torch/``; its C entry point is called through ctypes
(any of three interfaces: the one taking the forward's activations, which
this checkout's ``fused_mlp.forward_cuda`` writes once before the timed
calls, in fp32, where it needs them; the one taking the bf16 weight
stream, which this checkout's ``fused_mlp.bwd_stream`` fills; or the
older one without it, both of which recompute the fp32 forward in the
timed call).
For each of bf16 and fp32 and the split and folded heads, the 8x256
viewdirs MLP at ``--rays`` x ``--samples`` points (one fine pass of a
1024-ray step by default, per-ray views), seeded: ``--rounds`` rounds of
other, this, this, other, each ``--reps`` calls timed by CUDA events;
per library the median, min and max ms per call, and a sha256 of every
output (packed grads, dx, dv) with the relative L2 distance between the
two libraries' outputs.  Prints one JSON line and, with ``--out``,
writes it.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import statistics
import subprocess
import sys

import torch

from plnerf_torch.core.config import ModelConfig
from plnerf_torch.core.encoding import embed
from plnerf_torch.core.mlp import NeRF
from plnerf_torch.kernels import build, fused_mlp


def build_other(root: str) -> ctypes.CDLL:
    """nvcc of ``root``'s backward source into ``root/build/plnerf_torch``."""
    csrc = os.path.join(root, "plnerf_torch", "kernels", "csrc")
    out = os.path.join(root, "build", "plnerf_torch", "libfused_mlp_bwd-ab.so")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    proc = subprocess.run([build.nvcc_path()] + build.NVCC_FLAGS + [
        "-o", out, os.path.join(csrc, "fused_mlp_bwd.cu")],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {csrc}:\n{proc.stderr}")
    return ctypes.CDLL(out)


def caller(lib: ctypes.CDLL, p, x, v, v_div, g):
    """A function of no arguments launching ``lib``'s backward once on the
    current stream; returns (grads, dx, dv)."""
    P, I, L, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_uint
    takes_acts = hasattr(lib, "plnerf_fused_mlp_bwd_acts_cols")
    streamed = takes_acts or hasattr(lib, "plnerf_fused_mlp_bwd_stream_len")
    bf16 = int(p.dtype == torch.bfloat16)
    layout = (p.n_layers, p.skip_mask, p.in_p, p.w_p, p.v_p, p.h_p, p.head)
    fn = lib.plnerf_fused_mlp_bwd
    fn.restype = I
    if takes_acts:
        fn.argtypes = [P, P, L, P, P, P, L, P, P, P, P, P, P, L, I, U, I, I,
                       I, I, I, I, P]
    elif streamed:
        fn.argtypes = [P, P, L, P, P, P, L, P, P, P, P, P, L, I, U, I, I, I,
                       I, I, I, P]
    else:
        fn.argtypes = [P, P, L, P, P, P, P, P, P, P, L, I, U, I, I, I, I, I,
                       I, P]
    lib.plnerf_fused_mlp_bwd_workspace.argtypes = [L, I, U, I, I, I, I, I,
                                                   I]
    lib.plnerf_fused_mlp_bwd_workspace.restype = L
    dev = x.device
    n = x.shape[0]
    wbuf = torch.cat([w.reshape(-1) for w in p.weights])
    bbuf = torch.cat([b.reshape(-1) for b in p.biases])
    grads = torch.empty(wbuf.numel() + bbuf.numel(), dtype=torch.float32,
                        device=dev)
    dx = torch.empty((n, p.in_p), dtype=torch.float32, device=dev)
    dv = torch.empty((n, p.v_p), dtype=torch.float32, device=dev)
    ws = torch.empty(lib.plnerf_fused_mlp_bwd_workspace(n, *layout, bf16),
                     dtype=torch.uint8, device=dev)
    ws_stream = (wbuf[fused_mlp._stream_index(p, dev, fused_mlp.bwd_stream)]
                 if streamed and bf16 else None)
    acts = None
    if takes_acts and not bf16:
        acts = x.new_empty((n, fused_mlp.acts_cols(p)))
        fused_mlp.forward_cuda(p, x, v, v_div, acts)

    def run():
        stream = torch.cuda.current_stream(dev).cuda_stream
        head = (x.data_ptr(), v.data_ptr(), v_div, g.data_ptr(),
                wbuf.data_ptr())
        if streamed:
            head += (None if ws_stream is None else ws_stream.data_ptr(),
                     0 if ws_stream is None else ws_stream.numel())
        head += (bbuf.data_ptr(),)
        if takes_acts:
            head += (None if acts is None else acts.data_ptr(),)
        rc = fn(*head, grads.data_ptr(), dx.data_ptr(),
                dv.data_ptr(), ws.data_ptr(), n, *layout, bf16, stream)
        if rc != 0:
            raise RuntimeError(f"fused_mlp_bwd launch failed ({rc})")
        return grads, dx, dv

    return run


def event_ms(fn, reps: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def digest(ts) -> str:
    h = hashlib.sha256()
    for t in ts:
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def rel_l2(a, b) -> float:
    num = sum(float((x.double() - y.double()).norm()) ** 2
              for x, y in zip(a, b)) ** 0.5
    den = sum(float(y.double().norm()) ** 2 for y in b) ** 0.5
    return num / max(den, 1e-30)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", required=True)
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--rays", type=int, default=1024)
    ap.add_argument("--samples", type=int, default=192)
    ap.add_argument("--out")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bwd_ab needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    libs = {"other": build_other(a.other), "this": fused_mlp._bwd_library()}
    cfg = ModelConfig()
    out = {"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), "other": os.path.abspath(a.other),
        "points": a.rays * a.samples, "rounds": a.rounds, "reps": a.reps,
        "order": "other, this, this, other per round", "cases": {}}
    for dtype in (torch.bfloat16, torch.float32):
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
                    cfg, dtype, fold)
                cot = torch.randn(x.shape[0], 4, device=dev,
                                  generator=torch.Generator(
                                      device=dev).manual_seed(7))
                runs = {k: caller(lib, p, x, v, v_div, cot)
                        for k, lib in libs.items()}
                res = {k: [t.clone() for t in r()] for k, r in runs.items()}
                torch.cuda.synchronize()
                ms = {k: [] for k in runs}
                for _ in range(a.rounds):
                    for k in ("other", "this", "this", "other"):
                        ms[k].append(event_ms(runs[k], a.reps))
            key = f"{'folded' if fold else 'split'}_{str(dtype)[6:]}"
            out["cases"][key] = {
                **{k: {"median_ms": statistics.median(v), "min_ms": min(v),
                       "max_ms": max(v)} for k, v in ms.items()},
                "digest": {k: digest(r) for k, r in res.items()},
                "bit_equal": all(torch.equal(s, t) for s, t in
                                 zip(res["this"], res["other"])),
                "rel_l2_this_vs_other": rel_l2(res["this"], res["other"])}
            del runs, res, p, x, v, cot, m
            torch.cuda.empty_cache()
    line = json.dumps(out)
    print(line)
    if a.out:
        with open(a.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
