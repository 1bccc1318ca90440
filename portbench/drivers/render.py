"""Serving traffic: the eval task's test-set renders, one client asking
for whole images back to back.

Each request is ``ServingRenderer.render_image`` of a renderer made by
``ServingRenderer.from_params`` under the eval task's render config
(``eval/images.test_render_config``: the jitter kept on, as the
reference's test renders keep it, no density noise), of one test view
at the configuration's image size (the scene's ``size``: Blender's
800 x 800), as the eval task renders the test set: ``test_poses`` poses
evenly spaced in azimuth on the ring at ``ring_phi`` degrees of
elevation and the scene's distance, taken in turn from a pose drawn from
the seed.  Every request asks for the same rays, so every seed offers
the same work.  A request is timed from its call until its maps are in
host memory; the next starts when it returns; the window ends when the
last request started before ``--seconds`` returns, so that it holds
whole requests only.

``correct``: ``pixels_per_request`` pixels of each request answered in
the window, drawn from the seed, against the reference's render of the
same rays at the same draws (``reference/check.render_pixels``): the
widest gap of a colour channel and their root mean square.

Traffic parameters: ``test_poses``, ``ring_phi``,
``pixels_per_request``, ``trace_s`` (the traced slice's length, in whole
requests).
"""
from __future__ import annotations

import math
import time
from typing import List

import numpy as np
import torch

from ..lib import scene as S
from ..lib.trace import Session
from ..reference import check, nerf


# the warm-up's request, numbered past any window's
WARM = 10 ** 9


class Requests:
    """The seed's requests, in order: size, pose, seed, compared pixels."""

    def __init__(self, ctx):
        self.ctx, self.tr = ctx, ctx.traffic
        self.size = int(ctx.scene["size"])
        self.poses = int(self.tr["test_poses"])
        rng = np.random.default_rng(S.sub_seed(ctx.seed, 6))
        self.first = int(rng.integers(self.poses))

    def get(self, i: int) -> dict:
        ctx, tr, size = self.ctx, self.tr, self.size
        rng = np.random.default_rng(S.sub_seed(ctx.seed, 6, i))
        theta = -180.0 + 360.0 * ((self.first + i) % self.poses) / self.poses
        pixels = rng.choice(size * size, int(tr["pixels_per_request"]),
                            replace=False)
        return {"size": size, "focal": S.focal_of(ctx.scene, size),
                "c2w": S.pose_spherical(theta, float(tr["ring_phi"]),
                                        float(ctx.scene["distance"])),
                "seed": S.sub_seed(ctx.seed, 7, i), "pixels": pixels}


def build(ctx):
    """The serving renderer of the cell's weights (and grid)."""
    from plnerf_torch.cli import run_plnerf
    from plnerf_torch.core.mlp import NeRF
    from plnerf_torch.eval.images import test_render_config
    from plnerf_torch.serving.runtime import ServingRenderer

    dev = ctx.device
    args = ctx.program_args()
    mcfg, rcfg, setup = run_plnerf.build_configs(args)
    occ_cfg = run_plnerf.occ_cfg_from_args(args)
    weights = S.make_weights(ctx.flags, ctx.seed, dev)
    nets = []
    for k in ("coarse", "fine"):
        net = NeRF(mcfg, None, dev)
        net.load_state_dict(weights[k])
        nets.append(net)
    grid = S.sphere_grid(ctx.flags, dev) if occ_cfg is not None else None
    srv = ServingRenderer.from_params(
        nets[0], nets[1], mcfg, test_render_config(rcfg, occ=occ_cfg),
        chunk=args.chunk, device=dev, mcfg_fine=setup.mcfg_fine,
        occ_grid=None if grid is None else {k: v.clone()
                                            for k, v in grid.items()})
    return srv, weights, grid, int(args.chunk)


def serve(ctx, srv, req: dict) -> np.ndarray:
    """One request; returns the colours of its compared pixels."""
    s = req["size"]
    K = S.intrinsics(s, req["focal"])
    with torch.profiler.record_function("portbench.request"):
        out = srv.render_image(req["c2w"], (s, s, req["focal"]), K,
                               near=float(ctx.scene["near"]),
                               far=float(ctx.scene["far"]), seed=req["seed"])
    return out["rgb_map"].reshape(-1, 3)[req["pixels"]]


def run(ctx) -> dict:
    dev, tr = ctx.device, ctx.traffic
    t0 = time.perf_counter()
    srv, weights, grid, chunk = build(ctx)
    reqs = Requests(ctx)
    t1 = time.perf_counter()
    # one request of the window's size, at a request it does not make
    a = time.perf_counter()
    serve(ctx, srv, reqs.get(WARM))
    t2 = time.perf_counter()
    setup_s = t2 - ctx.t_start
    print(f"[setup] imports {t0 - ctx.t_start:.3f} s, build {t1 - t0:.3f} s,"
          f" warm request {t2 - a:.3f} s", flush=True)

    served: List[tuple] = []
    lat, failed, i = [], 0, 0
    t0 = time.perf_counter()
    deadline = t0 + ctx.seconds
    while time.perf_counter() < deadline:
        req = reqs.get(i)
        i += 1
        a = time.perf_counter()
        try:
            rgb = serve(ctx, srv, req)
        except Exception as e:  # a failed request counts, the loop goes on
            failed += 1
            print(f"[render] request {i - 1} failed: {e!r}", flush=True)
            continue
        lat.append(time.perf_counter() - a)
        served.append((req, rgb))
    wall = time.perf_counter() - t0
    rays = sum(r["size"] ** 2 for r, _ in served)

    summary, traced = None, []
    if ctx.trace:
        per = wall / max(len(served), 1)
        n = max(2, min(32, round(float(tr["trace_s"]) / per)))
        with Session(dev) as s:
            for _ in range(n):
                req = reqs.get(i)
                i += 1
                traced.append(req)
                served.append((req, serve(ctx, srv, req)))
        summary = s.summary
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    q = (np.percentile(np.asarray(lat) * 1e3, [0, 50, 100]) if lat
         else [math.nan] * 3)
    print(f"[render] {len(lat)} requests, {rays} rays in {wall:.3f} s, "
          "ms a request min / median / max " + " / ".join(
              f"{v:.1f}" for v in q), flush=True)
    srv = None
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    gaps = rgb_gaps(ctx, weights, grid, served, chunk)
    print(f"[render] compared {len(served)} requests: " + ", ".join(
        f"{k} {v!r}" for k, v in gaps.items()), flush=True)
    return {"e2e": {"render_rays_per_s": rays / wall, "setup_s": setup_s},
            "obs": {"kind": "render", "flags": ctx.flags, "rays": rays,
                    "wall_s": wall, "traced_padded_rays": sum(
                        -(-r["size"] ** 2 // chunk) * chunk for r in traced),
                    "trace": summary},
            "checks": gaps, "attempted": len(lat) + failed,
            "failed": failed, "memory_peak_bytes": int(peak),
            "device_kind": kind, "trace": summary}


def rgb_gaps(ctx, weights, grid, served, chunk: int) -> dict:
    """``check.rgb_gaps`` of the served colours against the reference."""
    if not served:
        return {}
    ref = check.render_pixels(weights, grid, [r for r, _ in served],
                              ctx.ref_flags, chunk, nerf.Precision("fp32"),
                              ctx.device)
    return check.rgb_gaps([torch.as_tensor(c) for _, c in served], ref)
