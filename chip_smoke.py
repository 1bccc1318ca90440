"""Smoke run of the PyTorch port on one CUDA card (an NVIDIA H100).

    python3 chip_smoke.py

Phases, one line each, then the result line:

1. env     card name and power limit (nvidia-smi), torch / CUDA versions,
           and the build of every kernel under plnerf_torch/kernels/csrc
           (one nvcc per source, all started together).
2. kernel  the fused MLP forward kernel against its plain PyTorch version
           on the card: 8x256 viewdirs MLP (input 63, views 27) at 65,537
           points, split / folded / plain heads, and at the coarse and fine
           passes of a 32,768-ray chunk, in fp32 (tolerance 1e-4) and bf16
           (2e-2); then kernel, plain-version and unfused
           ``apply_mlp`` (cuBLAS) times at one fine pass of a 32,768-ray
           chunk (6.29 M points), beside the bound.
3. slice   ``ServingRenderer.from_params`` at full width (two 8x256 MLPs,
           128 + 64 samples, linear, white background, fused MLP on) with
           seeded random weights: three 32,768-ray requests (test config,
           perturb kept, seeds 0-2), the first again with bf16 MLPs, and
           one 400x400 image (800x800 Blender intrinsics, render_factor 2)
           in eval_det mode, rendered twice.
           The kernels' launch counters are set to 0 before and read after.
4. ref     the card's render of 512 rays against the CPU render (the
           kernel's plain version) of the same weights.

Then one JSON line with every kernel's numbers, the card line, and the
last line ``{"ok": true, "device": {...}}``.  Exits non-zero, printing no
result, without CUDA, without the repository beside it, or on any failure.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
R_CHUNK = 32768
N_COARSE, N_FINE = 128, 64
KERNEL_REPLACES = "plnerf/kernels/fused_mlp.py:186"   # _kernel
TOLERANCE = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def log(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 5) -> float:
    """Median CUDA-event time of ``fn`` after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def macs_per_point(cfg, head: int) -> int:
    """The MLP's multiply-adds per point on unpadded widths."""
    from plnerf_torch.kernels import fused_mlp

    W, in_ch = cfg.netwidth, cfg.input_ch
    vch = cfg.input_ch_views + cfg.input_ch_cam
    macs = in_ch * W + (cfg.netdepth - 1) * W * W
    macs += sum(in_ch * W for i in range(cfg.netdepth) if (i - 1) in cfg.skips)
    if head == fused_mlp.SPLIT:
        macs += W * (W + 1) + (W + vch) * (W // 2) + (W // 2) * 3
    elif head == fused_mlp.FOLDED:
        macs += W * (W // 2 + 1) + vch * (W // 2) + (W // 2) * 3
    else:
        macs += W * cfg.output_ch
    return macs


def bound(p, x, v, n: int, cfg) -> tuple:
    """(bound_ms, bound_by): the larger of the bytes the call must move
    (inputs read once, raw written once) over HBM bandwidth and its FLOPs
    over the card's peak for the operand type."""
    wbuf, bbuf = p.flat()
    nbytes = sum(t.numel() * t.element_size() for t in (x, wbuf, bbuf)
                 if t is not None) + n * 4 * 4
    if v is not None:
        nbytes += v.numel() * v.element_size()
    flops = 2.0 * macs_per_point(cfg, p.head) * n
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[p.dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def phase_env():
    from plnerf_torch.kernels import build

    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    names = sorted(f[:-3] for f in os.listdir(build.CSRC) if f.endswith(".cu"))
    with ThreadPoolExecutor(len(names)) as ex:
        list(ex.map(build.build, names))
    log("env", card=card_line(), torch=torch.__version__,
        cuda=torch.version.cuda, kernels_built=names,
        build_s=round(time.perf_counter() - t0, 3),
        allow_tf32=torch.backends.cuda.matmul.allow_tf32)


def _kernel_inputs(cfg, R, S, fold, dtype, dev, seed):
    from plnerf_torch.core.encoding import embed
    from plnerf_torch.core.mlp import NeRF
    from plnerf_torch.kernels import fused_mlp

    g = torch.Generator(device=dev).manual_seed(seed)
    m = NeRF(cfg, g, device=dev)
    pts = torch.randn(R, S, 3, generator=g, device=dev)
    ve = None
    if cfg.use_viewdirs:
        vd = torch.nn.functional.normalize(
            torch.randn(R, 3, generator=g, device=dev), dim=-1)
        ve = embed(vd, cfg.multires_views, cfg.pi_bands)[:, None, :]
    pe = embed(pts, cfg.multires, cfg.pi_bands)
    p, x, v, v_div = fused_mlp.prepare(m, pe, ve, cfg, dtype, fold)
    return m, pe, ve, p, x, v, v_div


def _hold(key, p, x, v, v_div, errs) -> None:
    """The kernel against its plain version on the same inputs; records
    the max abs error under ``key`` and raises past the tolerance, which
    scales with max(1, max|raw|)."""
    from plnerf_torch.kernels import fused_mlp

    got = fused_mlp.forward_cuda(p, x, v, v_div)
    torch.cuda.synchronize()
    ref = fused_mlp.forward_plain(p, x, v, v_div)
    err = float((got - ref).abs().max())
    errs[key] = err
    scale = float(ref.abs().max())
    if not (torch.isfinite(got).all() and
            err <= TOLERANCE[p.dtype] * max(1.0, scale)):
        raise AssertionError(f"kernel {key}: max abs err {err} (scale "
                             f"{scale}) over tolerance {TOLERANCE[p.dtype]}")


def phase_kernel(dev):
    """Returns (max abs error over every comparison, split fp32 times)."""
    from plnerf_torch.core.config import ModelConfig
    from plnerf_torch.core.mlp import apply_mlp
    from plnerf_torch.kernels import fused_mlp

    full = ModelConfig()                      # 8x256, in 63, views 27
    plain = ModelConfig(use_viewdirs=False)
    dtypes = (torch.float32, torch.bfloat16)
    errs = {}
    with torch.no_grad():
        # every head schedule at 65,537 points = 1 ray x 65,537 samples
        # (ragged last tile), then the main path's own shapes: the coarse
        # (128 samples) and fine (192) passes of a 32,768-ray chunk
        for name, cfg, fold in (("split", full, False),
                                ("folded", full, True),
                                ("plain", plain, False)):
            for dtype in dtypes:
                _, _, _, p, x, v, v_div = _kernel_inputs(
                    cfg, 1, 65537, fold, dtype, dev, seed=1)
                _hold(f"{name}_{str(dtype)[6:]}_65537", p, x, v, v_div, errs)
        for dtype in dtypes:
            _, _, _, p, x, v, v_div = _kernel_inputs(
                full, R_CHUNK, N_COARSE, False, dtype, dev, seed=3)
            _hold(f"split_{str(dtype)[6:]}_coarse", p, x, v, v_div, errs)
            del p, x, v

        # one fine pass of a 32,768-ray chunk: 192 samples per ray
        times = {}
        S = N_COARSE + N_FINE
        n = R_CHUNK * S
        for dtype in dtypes:
            for fold in (False, True):
                m, pe, ve, p, x, v, v_div = _kernel_inputs(
                    full, R_CHUNK, S, fold, dtype, dev, seed=2)
                key = f"{'folded' if fold else 'split'}_{str(dtype)[6:]}"
                _hold(key + "_fine", p, x, v, v_div, errs)
                entry = {"kernel_ms": cuda_ms(
                    lambda: fused_mlp.forward_cuda(p, x, v, v_div))}
                entry["bound_ms"], entry["bound_by"] = bound(p, x, v, n, full)
                if not fold:
                    entry["plain_ms"] = cuda_ms(
                        lambda: fused_mlp.forward_plain(p, x, v, v_div), 3)
                    entry["library_ms"] = cuda_ms(
                        lambda: apply_mlp(m, pe, ve, full, dtype), 3)
                times[key] = entry
                del m, pe, ve, p, x, v
                torch.cuda.empty_cache()
        log("kernel_check", max_abs_err=errs,
            tolerance={"float32": TOLERANCE[torch.float32],
                       "bfloat16": TOLERANCE[torch.bfloat16]},
            note="tolerance scales with max(1, max|raw|)")
        log("kernel_time", points=n, rays=R_CHUNK, samples=S, card=card_line(),
            times=times)
    return max(errs.values()), times["split_float32"]


def _blender_rays(dev, n_rays, seed):
    """Rays of a random Blender test camera (radius 4, looking at the
    origin, 800x800 intrinsics): ``n_rays`` random pixels."""
    from plnerf_torch.core import rays as raysmod
    from plnerf_torch.core.render import make_ray_batch

    c2w, K = _blender_camera(seed)
    ro, rd = raysmod.get_rays(800, 800, K, torch.as_tensor(c2w, device=dev))
    packed, _ = make_ray_batch(ro, rd, 2.0, 6.0, True)
    idx = torch.as_tensor(np.random.default_rng(seed).choice(
        800 * 800, n_rays, replace=False), device=dev)
    return packed[idx]


def _blender_camera(seed):
    rng = np.random.default_rng(seed)
    theta, phi = rng.uniform(0, 2 * np.pi), rng.uniform(0.2, 1.2)
    eye = 4.0 * np.array([np.cos(theta) * np.cos(phi),
                          np.sin(theta) * np.cos(phi), np.sin(phi)])
    fwd = -eye / np.linalg.norm(eye)
    right = np.cross(fwd, [0.0, 0.0, 1.0])
    right /= np.linalg.norm(right)
    up = np.cross(right, fwd)
    c2w = np.stack([right, up, -fwd, eye], 1).astype(np.float32)
    focal = 0.5 * 800 / np.tan(0.5 * 0.6911112)      # Blender camera_angle_x
    K = np.array([[focal, 0, 400], [0, focal, 400], [0, 0, 1]], np.float32)
    return c2w, K


def _renderers(dev):
    from plnerf_torch.core.config import ModelConfig, RenderConfig
    from plnerf_torch.core.mlp import NeRF
    from plnerf_torch.eval.images import test_render_config
    from plnerf_torch.serving.runtime import ServingRenderer

    mcfg = ModelConfig()
    base = RenderConfig(n_samples=N_COARSE, n_importance=N_FINE,
                        mode="linear", color_mode="midpoint",
                        white_bkgd=True, use_fused_mlp=True)
    g = torch.Generator(device=dev).manual_seed(0)
    pc, pf = NeRF(mcfg, g, device=dev), NeRF(mcfg, g, device=dev)
    test = ServingRenderer.from_params(pc, pf, mcfg, test_render_config(base),
                                       chunk=R_CHUNK, device=dev)
    det = ServingRenderer.from_params(
        pc, pf, mcfg, test_render_config(base, perturb=False),
        chunk=R_CHUNK, device=dev)
    bf16 = ServingRenderer.from_params(
        pc, pf, mcfg, test_render_config(base, mlp_dtype="bfloat16"),
        chunk=R_CHUNK, device=dev)
    return test, det, bf16


def _check_maps(out, n):
    """Finite maps of n rows with rgb in [0, 1 + 1e-5].  The one exception
    is the reference's own 0/0: disparity 1/max(1e-10, depth/acc) is NaN
    on a ray whose weights are all 0; returns the count of such rays."""
    empty = out["acc_map"].reshape(n) == 0
    for k, v in out.items():
        ok = np.isfinite(v).reshape(n, -1).all(-1)
        if k == "disp_map":
            ok |= empty
        if v.shape[0] != n or not ok.all():
            raise AssertionError(f"{k}: shape {v.shape} or non-finite")
    rgb = out["rgb_map"]
    if rgb.min() < 0.0 or rgb.max() > 1.0 + 1e-5:
        raise AssertionError(f"rgb_map outside [0, 1]: {rgb.min()} "
                             f"{rgb.max()}")
    return int(empty.sum())


def phase_slice(dev):
    from plnerf_torch.kernels import fused_mlp

    test, det, bf16 = _renderers(dev)
    requests = [_blender_rays(dev, R_CHUNK, seed) for seed in range(3)]
    torch.cuda.synchronize()

    fused_mlp.launches = 0                    # main path starts here
    req = []
    # three fp32 requests (the recipe's mlp_dtype), then one in bf16
    for seed, rays, srv in [(0, requests[0], test), (1, requests[1], test),
                            (2, requests[2], test), (0, requests[0], bf16)]:
        before = fused_mlp.launches
        t0 = time.perf_counter()
        out = srv.render_rays(rays, seed=seed)
        dt = time.perf_counter() - t0
        empty = _check_maps(out, R_CHUNK)
        if fused_mlp.launches - before != 2:
            raise AssertionError("expected 2 kernel launches per chunk")
        req.append({"seed": seed, "mlp_dtype": srv.rcfg.mlp_dtype,
                    "rays": R_CHUNK, "s": dt, "rays_per_s": R_CHUNK / dt,
                    "empty_rays": empty,
                    "mean_acc": float(out["acc_map"].mean())})

    c2w, K = _blender_camera(7)
    imgs, img_s = [], []
    for _ in range(2):
        before = fused_mlp.launches
        t0 = time.perf_counter()
        imgs.append(det.render_image(c2w, (400, 400, K[0, 0] / 2),
                                     np.array([[K[0, 0] / 2, 0, 200],
                                               [0, K[0, 0] / 2, 200],
                                               [0, 0, 1]], np.float32)))
        img_s.append(time.perf_counter() - t0)
        n_chunks = -(-400 * 400 // R_CHUNK)
        if fused_mlp.launches - before != 2 * n_chunks:
            raise AssertionError("expected 2 kernel launches per chunk")
    launches = fused_mlp.launches             # main path ends here
    img_empty = _check_maps({k: v.reshape(400 * 400, -1)
                             for k, v in imgs[0].items()}, 400 * 400)
    for k in imgs[0]:
        if not np.array_equal(imgs[0][k], imgs[1][k], equal_nan=True):
            raise AssertionError(f"eval_det renders differ in {k}")
    log("slice", card=card_line(), requests=req, image="400x400",
        image_s=img_s, image_empty_rays=img_empty, images_identical=True,
        launches=launches)
    return launches


def phase_reference(dev):
    """The card's serving render against the CPU's (the kernel's plain
    version) on the same weights and rays, eval_det."""
    from plnerf_torch.serving.runtime import ServingRenderer

    _, det, _ = _renderers(dev)
    rays = _blender_rays(dev, 512, 11)
    gpu = det.render_rays(rays)
    cpu_srv = ServingRenderer.from_params(
        det.params_c.to("cpu"), det.params_f.to("cpu"), det.mcfg, det.rcfg,
        chunk=512, device="cpu")
    cpu = cpu_srv.render_rays(rays.cpu())
    tol = {"rgb_map": 1e-3, "acc_map": 1e-3, "depth_map": 1e-2,
           "rgb0": 1e-3, "depth0": 1e-2}
    errs = {}
    for k, lim in tol.items():
        errs[k] = float(np.abs(gpu[k] - cpu[k]).max())
        if errs[k] > lim:
            raise AssertionError(f"{k}: card vs CPU {errs[k]} > {lim}")
    log("reference", rays=512, max_abs_err=errs, tolerance=tol)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import plnerf_torch  # noqa: F401
        from plnerf_torch.device import resolve_device
    except ImportError as e:
        print(f"chip_smoke: the plnerf_torch package is missing: {e}",
              file=sys.stderr)
        return 1
    try:
        dev = resolve_device(None)
        phase_env()
        err, t = phase_kernel(dev)
        launches = phase_slice(dev)
        phase_reference(dev)
    except Exception:
        traceback.print_exc()
        return 1
    if launches < 1:
        print("chip_smoke: the main path launched no kernel", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": [{
        "name": "fused_mlp_fwd", "route": "cuda",
        "source": "plnerf_torch/kernels/csrc/fused_mlp_fwd.cu",
        "replaces": KERNEL_REPLACES, "launches": launches,
        "max_abs_err": err, "ms": t["kernel_ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
        "library_ms": t["library_ms"]}]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
