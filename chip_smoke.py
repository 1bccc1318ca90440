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
3. bwd     the fused MLP backward kernel against its plain PyTorch version
           on the card: 8x256 viewdirs MLP at 65,537 points (one ray, a
           ragged last tile) and at the coarse (1024 x 128) and fine
           (1024 x 192) passes of a 1024-ray train step, split and folded
           heads, fp32 (relative L2 tolerance 1e-3, beside the plain
           version's own distance from a float64 evaluation) and bf16
           (2e-2), per-ray views, every call made twice and held to
           bit-identical results; then kernel, plain-version and
           autograd-through-``apply_mlp`` (cuBLAS) times at the fine pass,
           beside the bound.
4. slice   ``ServingRenderer.from_params`` at full width (two 8x256 MLPs,
           128 + 64 samples, linear, white background, fused MLP on) with
           seeded random weights: three 32,768-ray requests (test config,
           perturb kept, seeds 0-2), the first again with bf16 MLPs, and
           one 400x400 image (800x800 Blender intrinsics, render_factor 2)
           in eval_det mode, rendered twice.
           The kernels' launch counters are set to 0 before and read after.
5. ref     the card's render of 512 rays against the CPU render (the
           kernel's plain version) of the same weights.
6. train   the NVS training step of configs/blender_linear.txt at full
           width (two 8x256 MLPs, 128 + 64 samples, 1024 rays per step
           from one image, two Adams under the exponential decay, fused
           MLP on with folded heads) on the numpy sphere scene, 8 views at
           200x200, seeded random weights: 30 steps of each variant the
           JAX driver switches between (precrop + constant quadrature,
           constant quadrature, linear; its 500 / 1000-step boundaries cut
           to 30 / 60), then 20 bf16 steps.  The kernels' launch counters
           are set to 0 before and read after; every step must launch each
           kernel twice (coarse, fine) and the loss must fall.  Then three
           more fp32 steps under torch.profiler: device time by kernel.
7. train_reference  three steps from the same weights on the same injected
           batch (256 rays, perturb off) on the card (kernels) and on the
           CPU (plain versions), and the card's first step with the
           unfused MLP: step-1 grads and per-step losses.

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
BWD_REPLACES = "plnerf/kernels/fused_mlp.py:345"      # _bwd_kernel
TOLERANCE = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# backward, relative L2 error per output: relu mask flips put the plain
# fp32 version itself ~1e-3 from a float64 evaluation (see _bwd_hold)
BWD_TOLERANCE = {torch.float32: 1e-3, torch.bfloat16: 2e-2}
N_RAND = 1024                      # rays per train step (blender_linear)
# the JAX driver's step variants (run_plnerf.py:582,620): precrop for the
# first 500 steps, constant quadrature for the first 1000; cut to 30 / 60
PRECROP_STEPS, CONSTANT_STEPS, TRAIN_STEPS, BF16_STEPS = 30, 60, 90, 20


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


def bwd_flops_per_point(cfg, head: int) -> int:
    """Exact FLOPs per point of the backward kernel on unpadded widths:
    every dense layer's K x N multiply-adds three times (the recomputed
    forward, the data grad da @ W^T, the weight grad A^T @ da), except
    that the recompute skips the two outputs nothing reads (the rgb layer,
    W/2 x 3, and the alpha column, W x 1)."""
    W = cfg.netwidth
    return 2 * (3 * macs_per_point(cfg, head) - 3 * (W // 2) - W)


def bwd_bound(p, x, v, g, n: int, cfg) -> tuple:
    """(bound_ms, bound_by) of one backward call: x, v, g and the packed
    weights read once, dx, dv and every fp32 grad written once, against
    ``bwd_flops_per_point`` at the card's peak for the operand type."""
    wbuf, bbuf = p.flat()
    n_grad = wbuf.numel() + bbuf.numel()
    nbytes = sum(t.numel() * t.element_size() for t in (x, v, g, wbuf, bbuf))
    nbytes += n * (p.in_p + p.v_p) * 4 + n_grad * 4
    flops = float(bwd_flops_per_point(cfg, p.head)) * n
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[p.dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def rel_l2(got: torch.Tensor, ref: torch.Tensor) -> float:
    """||got - ref|| / ||ref|| (fp64 sums)."""
    d = float((got.double() - ref.double()).norm())
    return d / max(float(ref.double().norm()), 1e-30)


def _bwd_hold(key, p, x, v, v_div, g, errs, rels) -> None:
    """The backward kernel, called twice, against its plain version on the
    same inputs.  The two calls must be bit-identical, and every dW and db
    block, dx and dv within BWD_TOLERANCE in relative L2 norm.  Not in max
    abs error: every grad jumps where a relu mask flips, and over 10^5
    points x 2,048 units some pre-activation always lies within rounding
    of 0, kept by one summation order and dropped by another.  In fp32 the
    plain version summed in float64 shows how far the plain fp32 version
    itself sits from it (``rels[... _plain_vs_f64]``) beside the kernel
    (``_kernel_vs_f64``).  ``errs`` records max abs errors, ``rels``
    relative L2 errors, worst block of each output."""
    from plnerf_torch.kernels import fused_mlp

    got = fused_mlp.backward_cuda(p, x, v, v_div, g)
    again = fused_mlp.backward_cuda(p, x, v, v_div, g)
    torch.cuda.synchronize()
    ref = fused_mlp.backward_plain(p, x, v, v_div, g)
    f64 = (fused_mlp.backward_plain(p, x, v, v_div, g, torch.float64)
           if p.dtype == torch.float32 else None)
    tol = BWD_TOLERANCE[p.dtype]
    for o, name in enumerate(("dW", "db", "dx", "dv")):
        blocks = [got[o], again[o], ref[o]] + ([f64[o]] if f64 else [])
        if not isinstance(got[o], list):
            blocks = [[b] for b in blocks]
        k = f"{key}_{name}"
        for i, (ga, gb, gr, *g64) in enumerate(zip(*blocks)):
            where = f"backward {key} {name}[{i}]"
            if not torch.equal(ga, gb):
                raise AssertionError(f"{where}: two calls on the same inputs "
                                     "differ")
            if not torch.isfinite(ga).all():
                raise AssertionError(f"{where}: non-finite")
            errs[k] = max(errs.get(k, 0.0), float((ga - gr).abs().max()))
            rels[k] = max(rels.get(k, 0.0), rel_l2(ga, gr))
            if g64:
                for tag, t in (("kernel", ga), ("plain", gr)):
                    kk = f"{k}_{tag}_vs_f64"
                    rels[kk] = max(rels.get(kk, 0.0), rel_l2(t, g64[0]))
            if rels[k] > tol:
                raise AssertionError(f"{where}: relative L2 error {rels[k]} "
                                     f"> {tol}")


def phase_bwd_kernel(dev):
    """Returns (max abs error over every comparison, times by schedule)."""
    from plnerf_torch.core.config import ModelConfig
    from plnerf_torch.core.mlp import apply_mlp
    from plnerf_torch.kernels import fused_mlp

    full = ModelConfig()
    dtypes = (torch.float32, torch.bfloat16)
    errs, rels = {}, {}
    S = N_COARSE + N_FINE
    with torch.no_grad():
        for tag, R, spr in (("65537", 1, 65537), ("coarse", N_RAND, N_COARSE),
                            ("fine", N_RAND, S)):
            for fold in (False, True):
                for dtype in dtypes:
                    _, _, _, p, x, v, v_div = _kernel_inputs(
                        full, R, spr, fold, dtype, dev, seed=4)
                    g = torch.randn(x.shape[0], 4, device=dev,
                                    generator=torch.Generator(
                                        device=dev).manual_seed(5))
                    head = "folded" if fold else "split"
                    _bwd_hold(f"{head}_{str(dtype)[6:]}_{tag}", p, x, v,
                              v_div, g, errs, rels)
                    del p, x, v, g
        log("bwd_kernel_check", max_abs_err=errs, rel_l2_err=rels,
            tolerance={"float32": BWD_TOLERANCE[torch.float32],
                       "bfloat16": BWD_TOLERANCE[torch.bfloat16]},
            note="tolerance on the relative L2 error of every dW / db "
                 "block, dx and dv; every call repeated and bit-identical")

    # one fine pass of a 1024-ray step: 196,608 points
    n = N_RAND * S
    times = {}
    for dtype in dtypes:
        library_ms = None
        for fold in (False, True):
            m, pe, ve, p, x, v, v_div = _kernel_inputs(
                full, N_RAND, S, fold, dtype, dev, seed=6)
            g = torch.randn(n, 4, device=dev, generator=torch.Generator(
                device=dev).manual_seed(7))
            entry = {"kernel_ms": cuda_ms(
                lambda: fused_mlp.backward_cuda(p, x, v, v_div, g))}
            entry["bound_ms"], entry["bound_by"] = bwd_bound(p, x, v, g, n,
                                                             full)
            entry["plain_ms"] = cuda_ms(
                lambda: fused_mlp.backward_plain(p, x, v, v_div, g), 3)
            if library_ms is None:
                # one PyTorch call for the same function: autograd through
                # the unfused MLP (cuBLAS), forward included as the
                # kernel recomputes it
                params = list(m.parameters())
                pe_ = pe.detach().requires_grad_()
                ve_ = ve.detach().requires_grad_()
                cot = g.reshape(N_RAND, S, 4)

                def library():
                    with torch.enable_grad():
                        raw = apply_mlp(m, pe_, ve_, full, dtype)
                        return torch.autograd.grad(
                            raw, [pe_, ve_] + params, cot)

                library_ms = cuda_ms(library, 3)
            entry["library_ms"] = library_ms
            times[f"{'folded' if fold else 'split'}_{str(dtype)[6:]}"] = entry
            del m, pe, ve, p, x, v, g
            torch.cuda.empty_cache()
    log("bwd_kernel_time", points=n, rays=N_RAND, samples=S,
        card=card_line(), flops_per_point={
            "split": bwd_flops_per_point(full, fused_mlp.SPLIT),
            "folded": bwd_flops_per_point(full, fused_mlp.FOLDED)},
        times=times)
    return max(errs.values()), times


def _train_setups(perturb=True, mlp_dtype="float32"):
    """(linear, constant-quadrature) setups of the blender_linear recipe,
    fused MLP on with folded heads."""
    import dataclasses

    from plnerf_torch.core.config import ModelConfig, RenderConfig
    from plnerf_torch.train.step import TrainSetup

    rcfg = RenderConfig(n_samples=N_COARSE, n_importance=N_FINE,
                        mode="linear", color_mode="midpoint",
                        white_bkgd=True, perturb=perturb,
                        mlp_dtype=mlp_dtype, use_fused_mlp=True,
                        fused_fold_heads=True)
    lin = TrainSetup(mcfg=ModelConfig(), rcfg=rcfg, lrate=5e-4,
                     coarse_lrate=5e-4, lrate_decay=500)
    const = dataclasses.replace(
        lin, rcfg=dataclasses.replace(rcfg, constant_init=True))
    return lin, const


def _sphere_scene(dev):
    from plnerf_torch.data.synthetic import make_sphere_dataset

    images, poses, hwf, K = make_sphere_dataset(8, 200, 200)
    return (torch.as_tensor(images, device=dev),
            torch.as_tensor(poses, device=dev), K,
            torch.arange(8, device=dev))


def _profile_steps(step, state, batches) -> dict:
    """Device time by kernel over a few train steps (torch.profiler): ms
    per step in the forward kernel, the backward kernel's three passes
    and everything else, and the device's busy share of the wall time
    (the profiler's own overhead included in the wall time)."""
    from torch.profiler import ProfilerActivity, profile

    groups = {"fused_mlp_fwd": ("fp32_kernel", "bf16_kernel"),
              "fused_mlp_bwd_data": ("data_kernel",),
              "fused_mlp_bwd_weight": ("weight_kernel",),
              "fused_mlp_bwd_reduce": ("reduce_kernel",)}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for rays, target in batches:
            state, _ = step(state, {"rays": rays, "target": target})
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ms = dict.fromkeys(list(groups) + ["other"], 0.0)
    top = []
    for e in prof.key_averages():
        # device-side events only: a CPU op's entry repeats its kernels
        dev_us = e.self_device_time_total
        if e.device_type != torch.autograd.DeviceType.CUDA or dev_us <= 0:
            continue
        top.append((dev_us, e.key))
        name = next((k for k, pats in groups.items()
                     if any(p in e.key for p in pats)), "other")
        ms[name] += dev_us / 1e3
    n = len(batches)
    total = sum(ms.values())
    top.sort(reverse=True)
    return {"ms_per_step": {k: v / n for k, v in ms.items()},
            "device_ms_per_step": total / n, "wall_ms_per_step": wall_ms / n,
            "device_busy_share": total / wall_ms,
            "top_device_ops": [[k[:60], us / 1e3 / n] for us, k in top[:12]]}


def phase_train(dev):
    """Returns (forward launches, backward launches, timing summary)."""
    from plnerf_torch.kernels import fused_mlp
    from plnerf_torch.train import batching
    from plnerf_torch.train.step import init_state, make_train_step

    images, poses, K, i_train = _sphere_scene(dev)
    lin, const = _train_setups()
    bf16, _ = _train_setups(mlp_dtype="bfloat16")
    g = torch.Generator(device=dev).manual_seed(0)
    state = init_state(g, lin, dev)
    steps = {"lin": make_train_step(lin), "const": make_train_step(const),
             "bf16": make_train_step(bf16)}
    torch.cuda.synchronize()

    fused_mlp.launches = fused_mlp.bwd_launches = 0   # main path starts
    rec = []
    for i in range(TRAIN_STEPS + BF16_STEPS):
        variant = ("bf16" if i >= TRAIN_STEPS else
                   "const" if i < CONSTANT_STEPS else "lin")
        precrop = i < PRECROP_STEPS
        f0, b0 = fused_mlp.launches, fused_mlp.bwd_launches
        t0 = time.perf_counter()
        rays, target, _ = batching.sample_one_image_batch(
            images, poses, K, i_train, g, N_RAND, 2.0, 6.0, True,
            precrop=precrop, precrop_frac=0.5)
        state, m = steps[variant](state, {"rays": rays, "target": target})
        loss = float(m["loss"])                     # synchronises
        dt = time.perf_counter() - t0
        launches = (fused_mlp.launches - f0, fused_mlp.bwd_launches - b0)
        if launches != (2, 2):
            raise AssertionError(f"step {i}: {launches} forward / backward "
                                 "launches, expected 2 / 2 (coarse, fine)")
        if not np.isfinite(loss):
            raise AssertionError(f"step {i}: loss {loss}")
        rec.append({"variant": variant + ("_precrop" if precrop else ""),
                    "loss": loss, "psnr": float(m["psnr"]), "s": dt})
    fwd, bwd = fused_mlp.launches, fused_mlp.bwd_launches   # main path ends
    profile = _profile_steps(steps["lin"], state, [
        batching.sample_one_image_batch(images, poses, K, i_train, g, N_RAND,
                                        2.0, 6.0, True)[:2]
        for _ in range(3)])

    fp32 = rec[:TRAIN_STEPS]
    first = statistics.mean(r["loss"] for r in fp32[:10])
    last = statistics.mean(r["loss"] for r in fp32[-10:])
    if not last < first:
        raise AssertionError(f"fp32 loss did not fall: first 10 steps "
                             f"{first}, last 10 {last}")

    def median_ms(rs):
        return statistics.median(r["s"] for r in rs) * 1e3

    by_variant = {}
    for r in rec[3:]:                                    # warm steps
        by_variant.setdefault(r["variant"], []).append(r)
    summary = {"ms_per_step_fp32": median_ms(fp32[3:]),
               "ms_per_step_bf16": median_ms(rec[TRAIN_STEPS + 3:]),
               "ms_per_step_by_variant": {k: median_ms(v)
                                          for k, v in by_variant.items()}}
    summary["train_rays_per_s_fp32"] = N_RAND / summary[
        "ms_per_step_fp32"] * 1e3
    summary["train_rays_per_s_bf16"] = N_RAND / summary[
        "ms_per_step_bf16"] * 1e3
    log("train", card=card_line(), rays_per_step=N_RAND,
        points_per_step={"coarse": N_RAND * N_COARSE,
                         "fine": N_RAND * (N_COARSE + N_FINE)},
        steps=len(rec), launches={"fused_mlp_fwd": fwd, "fused_mlp_bwd": bwd},
        launches_per_step={"fused_mlp_fwd": fwd / len(rec),
                           "fused_mlp_bwd": bwd / len(rec)},
        loss_first10_fp32=first, loss_last10_fp32=last,
        loss_last_bf16=rec[-1]["loss"], psnr_last_fp32=fp32[-1]["psnr"],
        **summary, profile_3_fp32_steps=profile,
        losses=[round(r["loss"], 6) for r in rec])
    return fwd, bwd, summary


def _grads(state) -> dict:
    return {f"{n}.{k}": q.grad.detach().cpu().clone()
            for n, model in (("c", state.params_coarse),
                             ("f", state.params_fine))
            for k, q in model.named_parameters()}


def _grad_errs(got: dict, ref: dict) -> dict:
    """Relative L2 error per tensor, and over all of them (``all``)."""
    errs = {k: rel_l2(got[k], r) for k, r in ref.items()}
    names = sorted(ref)
    errs["all"] = rel_l2(torch.cat([got[k].reshape(-1) for k in names]),
                         torch.cat([ref[k].reshape(-1) for k in names]))
    return errs


def phase_train_reference(dev):
    """Three steps from the same weights on the same injected batch on the
    card (kernels) and on the CPU (plain versions): step-1 grads to 1e-3
    relative L2 over both networks and 1e-2 per tensor, losses to 1e-3
    relative.  The two devices round the encoding, the quadrature and
    every sum differently; a tensor whose grad is nearly 0 (at step 1 the
    coarse colour head's) shows that most.  So the card's first step also
    runs with the unfused MLP (autograd through ``apply_mlp``, cuBLAS) on
    the same device, and the kernels must match it to 1e-4 over all and
    1e-3 per tensor (relu mask flips, see _bwd_hold)."""
    import dataclasses

    from plnerf_torch.train import batching
    from plnerf_torch.train.step import (_render_loss, init_state,
                                         make_train_step)

    images, poses, K, i_train = _sphere_scene("cpu")
    lin, _ = _train_setups(perturb=False)
    unfused = dataclasses.replace(lin, rcfg=dataclasses.replace(
        lin.rcfg, use_fused_mlp=False, fused_fold_heads=False))
    rng = np.random.default_rng(3)
    rays, target, _ = batching.sample_one_image_batch(
        images, poses, K, i_train, None, 256, 2.0, 6.0, True,
        draws=(rng.integers(0, len(i_train)),
               rng.integers(0, images.shape[1], 256),
               rng.integers(0, images.shape[2], 256)))
    card = init_state(torch.Generator(device=dev).manual_seed(1), lin, dev)
    host = init_state(None, lin, "cpu")
    host.params_coarse.load_state_dict(card.params_coarse.state_dict())
    host.params_fine.load_state_dict(card.params_fine.state_dict())
    loss, _ = _render_loss(card.params_coarse, card.params_fine,
                           {"rays": rays.to(dev), "target": target.to(dev)},
                           None, unfused)
    loss.backward()
    unfused_grads = _grads(card)
    runs = {}
    for name, state in (("card", card), ("cpu", host)):
        d = next(state.params_coarse.parameters()).device
        step = make_train_step(lin)
        batch = {"rays": rays.to(d), "target": target.to(d)}
        losses, grads = [], None
        for i in range(3):
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
            if i == 0:
                grads = _grads(state)
        runs[name] = {"losses": losses, "grads": grads}
    gpu, cpu = runs["card"], runs["cpu"]
    vs_cpu = _grad_errs(gpu["grads"], cpu["grads"])
    vs_unfused = _grad_errs(gpu["grads"], unfused_grads)
    loss_err = [abs(a / b - 1) for a, b in zip(gpu["losses"],
                                               cpu["losses"])]
    log("train_reference", rays=256, steps=3, losses_card=gpu["losses"],
        losses_cpu=cpu["losses"], loss_rel_err=loss_err,
        grad_rel_l2_err_card_vs_cpu=vs_cpu,
        grad_rel_l2_err_kernels_vs_unfused_on_card=vs_unfused,
        tolerance={"card_vs_cpu": "1e-3 over all, 1e-2 per tensor",
                   "kernels_vs_unfused": "1e-4 over all, 1e-3 per tensor",
                   "loss": "1e-3 relative"})
    for what, errs, lim in (("card vs CPU", vs_cpu, 1e-3),
                            ("kernels vs unfused", vs_unfused, 1e-4)):
        worst = max((k for k in errs if k != "all"), key=errs.get)
        if not (errs["all"] <= lim and errs[worst] <= 10 * lim):
            raise AssertionError(f"step-1 grads {what}: relative L2 error "
                                 f"{errs['all']} over all, {errs[worst]} "
                                 f"in {worst}")
    if not max(loss_err) <= 1e-3:
        raise AssertionError(f"losses card {gpu['losses']} CPU "
                             f"{cpu['losses']}")


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
        bwd_err, bwd_t = phase_bwd_kernel(dev)
        launches = phase_slice(dev)
        phase_reference(dev)
        train_fwd, train_bwd, _ = phase_train(dev)
        phase_train_reference(dev)
    except Exception:
        traceback.print_exc()
        return 1
    if launches < 1 or train_fwd < 1 or train_bwd < 1:
        print("chip_smoke: a main path launched no kernel", file=sys.stderr)
        return 1
    # the training path runs folded heads in fp32
    bt = bwd_t["folded_float32"]
    print(json.dumps({"kernels": [{
        "name": "fused_mlp_fwd", "route": "cuda",
        "source": "plnerf_torch/kernels/csrc/fused_mlp_fwd.cu",
        "replaces": KERNEL_REPLACES, "launches": launches + train_fwd,
        "max_abs_err": err, "ms": t["kernel_ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
        "library_ms": t["library_ms"]}, {
        "name": "fused_mlp_bwd", "route": "cuda",
        "source": "plnerf_torch/kernels/csrc/fused_mlp_bwd.cu",
        "replaces": BWD_REPLACES, "launches": train_bwd,
        "max_abs_err": bwd_err, "ms": bt["kernel_ms"],
        "plain_ms": bt["plain_ms"], "bound_ms": bt["bound_ms"],
        "bound_by": bt["bound_by"], "library_ms": bt["library_ms"]}]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
