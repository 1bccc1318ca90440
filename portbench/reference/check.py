"""What the reference works out again from the inputs both sides were
handed, and the numbers that decide ``correct``.

Training: ``follow_train`` runs the first steps of a cell from the same
weights, grid, scene and generator state, drawing the batches and the
renderer's draws in the order the run draws them (``lib/draws.py``).
``train_gaps`` compares the program's readings with it: each checked
step's loss, the first gradient as Adam got it (its first moment after
one step over 1 - beta1) and the parameters' change after the steps, the
last two by leaf; and the second window's (the graph's first replay)
last loss and the parameters' change over it.

Serving: ``render_pixels`` renders sampled pixels of served requests at
each pixel's own draws (its chunk's generator, its row), and
``rgb_gaps`` are the widest gap of a served colour and the gaps' root
mean square.
"""
from __future__ import annotations

import statistics
from typing import Dict, List, Optional, Tuple

import torch

from ..lib import draws
from ..lib.scene import pixel_rays
from . import nerf

BETA1 = 0.9
# leaves whose reference gradient is under this share of the median
# leaf's move under Adam by round-off alone: left out of the change
DEAD_LEAF = 1e-3


def _leaves(weights: Dict[str, Dict[str, torch.Tensor]], device):
    return {net: {k: v.detach().to(device).clone().requires_grad_(True)
                  for k, v in leaves.items()}
            for net, leaves in weights.items()}


def follow_train(weights, grid, scene: Dict[str, torch.Tensor],
                 gen_state: torch.Tensor, flags: dict, start_count: int,
                 n_steps: int, prec: nerf.Precision,
                 keep: Tuple[int, ...] = ()) -> dict:
    """The reference's ``n_steps`` from ``weights`` ({"coarse", "fine"}:
    {leaf: tensor}) at update count ``start_count``: {"loss": [per step],
    "grad1": {net.leaf: first step's gradient}, "rgb1": the first step's
    colours, "params_at": {k: {net.leaf: after step k}} for each k of
    ``keep`` and ``n_steps``}."""
    dev = scene["images"].device
    cfg = nerf.render_cfg(flags)
    p = _leaves(weights, dev)
    opts = {net: nerf.Adam(p[net]) for net in p}
    gen = torch.Generator(device=dev)
    gen.set_state(gen_state)
    images, poses, K = scene["images"], scene["poses"], scene["K"]
    n_train, H, W = images.shape[0], images.shape[1], images.shape[2]
    R = int(flags["N_rand"])
    near, far = float(flags["near"]), float(flags["far"])
    g = None if grid is None else {k: v.clone() for k, v in grid.items()}
    out = {"loss": [], "grad1": None, "params_at": {}}
    keep = set(keep) | {n_steps}
    for k in range(n_steps):
        ti, y, x = draws.batch(gen, n_train, H, W, R, dev)
        img = ti[0]
        o, d = pixel_rays(poses[img], K, y, x)
        rays = nerf.pack_rays(o, d, near, far)
        target = images[img, y, x]
        t_rand, u = draws.render(gen, R, cfg["N_samples"],
                                 cfg["N_importance"], dev)
        r = nerf.render(p["coarse"], p["fine"], rays, t_rand, u, cfg, prec,
                        g)
        loss = ((r["rgb"] - target) ** 2).mean() + \
            ((r["rgb0"] - target) ** 2).mean()
        names = [(net, leaf) for net in p for leaf in p[net]]
        grads = torch.autograd.grad(loss, [p[n][l] for n, l in names])
        by_net: Dict[str, Dict[str, torch.Tensor]] = {net: {} for net in p}
        for (net, leaf), gr in zip(names, grads):
            by_net[net][leaf] = gr
        if k == 0:
            out["grad1"] = {f"{n}.{l}": gr.detach().clone()
                            for (n, l), gr in zip(names, grads)}
            out["rgb1"] = torch.cat([r["rgb"], r["rgb0"]]).detach()
        lr = nerf.lrate(cfg, start_count + k)
        for net in p:
            opts[net].step(by_net[net], lr)
        out["loss"].append(float(loss.detach()))
        if g is not None:
            pts = rays[:, None, 0:3] + rays[:, None, 3:6] * r["occ_z"][..., None]
            g = nerf.update_grid(g, pts, r["occ_sigma"], cfg["occ"])
        if k + 1 in keep:
            out["params_at"][k + 1] = {f"{n}.{l}": v.detach().clone()
                                       for n in p for l, v in p[n].items()}
    return out


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
               keep: Optional[List[str]] = None) -> List[float]:
    """Each leaf's gap of its norm, over the larger of the reference's
    norm of that leaf and of the median leaf."""
    keys = keep if keep is not None else list(ref)
    med = statistics.median(ref[k] for k in ref)
    return [abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keys]


def _norms(x: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in x.items()}


def train_gaps(prog: dict, ref: dict, p0: Dict[str, torch.Tensor],
               checked: int, n_inner: int) -> Dict[str, float]:
    """``loss_gap``, the widest relative gap of a checked step's loss,
    and ``loss1_gap``, the first step's; ``grad_gap`` / ``grad_med``, the
    worst / the median leaf's gap of the first gradient's norm;
    ``change_gap`` / ``change_med``, the worst / the median leaf's gap of
    the norm of the change after the ``checked`` steps, over the leaves
    whose reference gradient is at least ``DEAD_LEAF`` of the median
    leaf's; ``rgb1_rms``, the root mean square of the first step's colour
    gaps (over the rows both have: a program that rendered fewer rays
    differs in its draws).  The second window of ``n_inner`` steps (the
    graph's first replay): ``replay_loss_gap``, the relative gap of its
    last step's loss, and ``replay_change_gap`` / ``replay_change_med``,
    the worst / the median leaf's gap of the norm of the parameters'
    change over it.  ``prog``: {"loss", "moment1" (Adam's first moment
    after one step), "params" (after the checked steps), "rgb1",
    "replay": {"loss", "before", "after"}}; ``p0``: the weights both
    started from."""
    steps = [abs(a - b) / abs(b) for a, b in zip(prog["loss"], ref["loss"])]
    g_ref = _norms(ref["grad1"])
    g_prog = _norms({k: v / (1.0 - BETA1) for k, v in prog["moment1"].items()})
    med = statistics.median(g_ref.values())
    live = [k for k, v in g_ref.items() if v >= DEAD_LEAF * med]

    def change(p_prog, a_prog, p_ref, a_ref):
        d_ref = _norms({k: p_ref[k] - a_ref[k] for k in p0})
        d_prog = _norms({k: p_prog[k].to(a_ref[k].device)
                         - a_prog[k].to(a_ref[k].device) for k in p0})
        return _leaf_gaps(d_prog, d_ref, live)
    grad = _leaf_gaps(g_prog, g_ref)
    first = change(prog["params"], p0, ref["params_at"][checked], p0)
    n = min(prog["rgb1"].shape[0], ref["rgb1"].shape[0])
    d = (prog["rgb1"][:n].to(ref["rgb1"].device) - ref["rgb1"][:n]).double()
    out = {"loss_gap": max(steps), "loss1_gap": steps[0],
           "rgb1_rms": float(d.pow(2).mean().sqrt()),
           "grad_gap": max(grad), "grad_med": statistics.median(grad),
           "change_gap": max(first),
           "change_med": statistics.median(first)}
    rp = prog["replay"]
    second = change(rp["after"], rp["before"], ref["params_at"][2 * n_inner],
                    ref["params_at"][n_inner])
    ref_loss = ref["loss"][2 * n_inner - 1]
    out.update(replay_loss_gap=abs(rp["loss"] - ref_loss) / abs(ref_loss),
               replay_change_gap=max(second),
               replay_change_med=statistics.median(second))
    return out


def render_pixels(weights, grid, requests: List[dict], flags: dict,
                  chunk: int, prec: nerf.Precision, device,
                  block: int = 16384) -> List[torch.Tensor]:
    """The reference's colour [n, 3] of each request's pixels.  A request:
    {"c2w" [4, 4], "size", "focal", "seed", "pixels" (flat indices into
    the size x size image)}; the pixel at flat index ``q`` lies in chunk
    ``q // chunk`` of the padded request, whose draws come from a
    generator seeded ``seed + q // chunk``, and takes row ``q % chunk`` of
    them."""
    cfg = nerf.render_cfg(flags)
    near, far = float(flags["near"]), float(flags["far"])
    pc = {k: v.to(device) for k, v in weights["coarse"].items()}
    pf = {k: v.to(device) for k, v in weights["fine"].items()}
    rows, t_all, u_all = [], [], []
    for req in requests:
        q = torch.as_tensor(req["pixels"], device=device, dtype=torch.int64)
        size = int(req["size"])
        f = float(req["focal"])
        K = torch.tensor([[f, 0, 0.5 * size], [0, f, 0.5 * size], [0, 0, 1]],
                         device=device)
        c2w = torch.as_tensor(req["c2w"], device=device, dtype=torch.float32)
        o, d = pixel_rays(c2w, K, q // size, q % size)
        rows.append(nerf.pack_rays(o, d, near, far))
        t = torch.empty((q.shape[0], cfg["N_samples"]), device=device)
        u = torch.empty((q.shape[0], cfg["N_importance"]), device=device)
        for c in torch.unique(q // chunk).tolist():
            sel = (q // chunk) == c
            gen = torch.Generator(device=device)
            gen.manual_seed(int(req["seed"]) + c)
            tc, uc = draws.render(gen, chunk, cfg["N_samples"],
                                  cfg["N_importance"], device)
            t[sel], u[sel] = tc[q[sel] % chunk], uc[q[sel] % chunk]
        t_all.append(t)
        u_all.append(u)
    rays, t, u = torch.cat(rows), torch.cat(t_all), torch.cat(u_all)
    out = []
    with torch.no_grad():
        for a in range(0, rays.shape[0], block):
            out.append(nerf.render(pc, pf, rays[a:a + block], t[a:a + block],
                                   u[a:a + block], cfg, prec, grid)["rgb"])
    rgb = torch.cat(out)
    sizes = [len(r["pixels"]) for r in requests]
    return list(torch.split(rgb, sizes))


def rgb_gaps(served: List[torch.Tensor], ref: List[torch.Tensor]
             ) -> Dict[str, float]:
    """``rgb_gap``, the widest gap of a served colour channel, and
    ``rgb_rms``, the root mean square of the gaps over every channel of
    every compared pixel."""
    d = torch.cat([(s.to(r.device) - r).reshape(-1)
                   for s, r in zip(served, ref)]).double()
    return {"rgb_gap": float(d.abs().max()),
            "rgb_rms": float(d.pow(2).mean().sqrt())}
