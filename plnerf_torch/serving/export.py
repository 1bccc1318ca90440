"""Serving artifacts for trained models (port of
``plnerf/serving/export.py``).

A trained coarse/fine pair is exported once into an artifact directory
that ``serving.runtime.ServingRenderer.load`` serves with no model code:

* ``module.pt2``: ``torch.export`` of the render function of one ray
  chunk (``build_chunk_fn``), the occupancy grid (when the model trained
  with one) baked in as constants.  Under ``use_fused_mlp`` each network
  is packed once here (``kernels.fused_mlp.PackedNet``) and the program
  calls the fused forward as the operator
  ``torch.ops.plnerf_torch.fused_mlp_fwd``, which the runtime registers
  by importing ``kernels.fused_mlp``: on a CUDA artifact every chunk
  launches the hand-written kernel.
* ``module_fused.pt2`` (optional, ``fused_n_rays``): the whole-batch
  variant (``build_fused_fn``), the chunk loop unrolled in one program.
* ``weights.pt`` (``weights_mode="args"``): the weights (the packed
  buffers under ``use_fused_mlp``, else the ``NeRF`` parameters) as a
  list of tensors that the programs take as their first input.
* ``manifest.json``: chunk, ray layout, output keys, the random inputs
  and the provenance needed to drive it.

Randomness: a ``torch.Generator`` cannot be traced, so the random draws
of ``core.render.render_rays`` are program inputs (``draw_inputs``, in
the order ``render_rays`` draws them: ``t_rand`` with ``perturb``, the
coarse ``noise0`` with ``raw_noise_std``, ``u`` with ``perturb`` and a
fine pass, the fine ``noise``).  With ``perturb`` off and no noise the
program takes the rays alone.

Differences from the JAX package: an artifact runs on the one device it
was exported on (``platforms`` is that device; a ``torch.export`` program
holds its constants on it), and the manifest records ``torch_version``
and ``device`` for ``jax_version``.
"""
from __future__ import annotations

import copy
import json
import os
from typing import Dict, List, Optional, Sequence

import torch

from ..core import render
from ..core.config import ModelConfig, RenderConfig
from ..core.mlp import NeRF
from ..device import module_device
from ..kernels import fused_mlp

MODULE_FILE = "module.pt2"
MODULE_FUSED_FILE = "module_fused.pt2"
MANIFEST_FILE = "manifest.json"
WEIGHTS_FILE = "weights.pt"
FORMAT_VERSION = 1

# per-ray outputs a serving client can consume (subset of render_rays'
# returns; *0 = coarse-network maps, present with a fine network only)
_OUTPUT_KEYS = ("rgb_map", "disp_map", "acc_map", "depth_map",
                "rgb0", "depth0")
_GRID_KEYS = ("density", "occ", "aabb_min", "aabb_max")


def ray_dim(rcfg: RenderConfig) -> int:
    return 11 if rcfg.use_viewdirs else 8


def output_keys(has_fine: bool, rcfg: RenderConfig) -> List[str]:
    """The maps a chunk returns: the coarse ``*0`` ones only with a fine
    network that a fine pass runs."""
    fine = has_fine and rcfg.n_importance > 0
    return [k for k in _OUTPUT_KEYS if fine or not k.endswith("0")]


def draw_inputs(rcfg: RenderConfig) -> List[dict]:
    """The random inputs of one chunk in ``render_rays``'s draw order:
    name, columns, and ``uniform`` (``torch.rand``) or ``normal``
    (``torch.randn`` times ``scale``)."""
    ns, ni = rcfg.n_samples, max(rcfg.n_importance, 0)
    noise = rcfg.raw_noise_std > 0.0
    out = []
    if rcfg.perturb:
        out.append(dict(name="t_rand", cols=ns, dist="uniform", scale=1.0))
    if noise:
        out.append(dict(name="noise0", cols=ns, dist="normal",
                        scale=rcfg.raw_noise_std))
    if ni:
        if rcfg.perturb:
            out.append(dict(name="u", cols=ni, dist="uniform", scale=1.0))
        if noise:
            out.append(dict(name="noise", cols=ns + ni, dist="normal",
                            scale=rcfg.raw_noise_std))
    return out


def _serving_net(model: NeRF, cfg: ModelConfig, rcfg: RenderConfig):
    """The network as the program holds it: packed once for the fused
    forward op, else a frozen copy of the ``NeRF``."""
    if rcfg.use_fused_mlp and (cfg.netdepth - 1) not in cfg.skips:
        dtype = (torch.bfloat16 if rcfg.mlp_dtype == "bfloat16"
                 else torch.float32)
        with torch.no_grad():
            return fused_mlp.PackedNet(model, cfg, dtype,
                                       rcfg.fused_fold_heads)
    net = copy.deepcopy(model).eval()
    return net.requires_grad_(False)


class ChunkFn(torch.nn.Module):
    """One chunk's render: ``(rays [chunk, rdim], **draws) -> {key: map}``
    with the networks (``net_c``, ``net_f``) and the grid as the module's
    tensors."""

    def __init__(self, params_c: NeRF, params_f: Optional[NeRF],
                 mcfg: ModelConfig, rcfg: RenderConfig,
                 mcfg_fine: Optional[ModelConfig] = None, occ_grid=None):
        super().__init__()
        self.mcfg, self.rcfg, self.mcfg_fine = mcfg, rcfg, mcfg_fine
        self.net_c = _serving_net(params_c, mcfg, rcfg)
        self.net_f = (None if params_f is None else
                      _serving_net(params_f, mcfg_fine or mcfg, rcfg))
        self.has_grid = occ_grid is not None
        for k in _GRID_KEYS if self.has_grid else ():
            self.register_buffer(f"grid_{k}", occ_grid[k].clone())
        self.keys = output_keys(params_f is not None, rcfg)

    def weight_names(self) -> List[str]:
        """The networks' tensors, in the order ``weights.pt`` lists them."""
        return [n for n, _ in self.named_parameters()] + [
            n for n, _ in self.named_buffers() if not n.startswith("grid_")]

    def forward(self, rays: torch.Tensor, **draws: torch.Tensor
                ) -> Dict[str, torch.Tensor]:
        grid = ({k: getattr(self, f"grid_{k}") for k in _GRID_KEYS}
                if self.has_grid else None)
        ret = render.render_rays(self.net_c, self.net_f, rays, None,
                                 self.mcfg, self.rcfg, overrides=draws,
                                 mcfg_fine=self.mcfg_fine, occ_grid=grid)
        return {k: ret[k] for k in self.keys}


class FusedFn(torch.nn.Module):
    """The whole batch: ``n_total / chunk`` chunks of ``ChunkFn``, each on
    its slice of the rays and of every draw, unrolled in one program."""

    def __init__(self, chunk_fn: ChunkFn, n_total: int, chunk: int):
        super().__init__()
        self.chunk_fn, self.n_total, self.chunk = chunk_fn, n_total, chunk

    def weight_names(self) -> List[str]:
        return ["chunk_fn." + n for n in self.chunk_fn.weight_names()]

    def forward(self, rays: torch.Tensor, **draws: torch.Tensor
                ) -> Dict[str, torch.Tensor]:
        outs = []
        for s in range(0, self.n_total, self.chunk):
            outs.append(self.chunk_fn(
                rays[s:s + self.chunk],
                **{k: v[s:s + self.chunk] for k, v in draws.items()}))
        return {k: torch.cat([o[k] for o in outs], 0) for k in outs[0]}


class WithWeights(torch.nn.Module):
    """``fn`` with its weights as the first input (``weights_mode="args"``):
    ``(weights, rays, **draws)``.  ``fn`` is held outside the module tree,
    so the exported program carries no weights; what is not a weight (the
    grid) stays a constant."""

    def __init__(self, fn: torch.nn.Module):
        super().__init__()
        object.__setattr__(self, "fn", fn)
        self.names = fn.weight_names()

    def forward(self, weights: Sequence[torch.Tensor], rays: torch.Tensor,
                **draws: torch.Tensor) -> Dict[str, torch.Tensor]:
        return torch.func.functional_call(
            self.fn, dict(zip(self.names, weights)), (rays,), draws)


def build_chunk_fn(params_c, params_f, mcfg: ModelConfig,
                   rcfg: RenderConfig,
                   mcfg_fine: Optional[ModelConfig] = None,
                   occ_grid=None) -> ChunkFn:
    """One-chunk render module (the JAX closure's counterpart)."""
    return ChunkFn(params_c, params_f, mcfg, rcfg, mcfg_fine, occ_grid)


def build_fused_fn(params_c, params_f, mcfg: ModelConfig,
                   rcfg: RenderConfig, chunk: int, n_total: int,
                   mcfg_fine: Optional[ModelConfig] = None,
                   occ_grid=None) -> FusedFn:
    """Whole-batch render module for ``n_total`` rays, a chunk multiple.
    Chunk ``i`` takes rows ``[i * chunk, (i + 1) * chunk)`` of every draw,
    so given the chunk path's per-chunk draws it returns the chunk path's
    maps (the JAX module instead splits one key over the chunks)."""
    return FusedFn(ChunkFn(params_c, params_f, mcfg, rcfg, mcfg_fine,
                           occ_grid), n_total, chunk)


def _example(fn, n: int, rdim: int, draws: List[dict], device,
             weights: Optional[List[torch.Tensor]]):
    args = (torch.zeros(n, rdim, device=device),)
    if weights is not None:
        args = (tuple(weights),) + args
    kwargs = {d["name"]: torch.zeros(n, d["cols"], device=device)
              for d in draws}
    return args, kwargs


def _export(fn, args, kwargs, path: str) -> torch.export.ExportedProgram:
    with torch.no_grad():
        ep = torch.export.export(fn, args, kwargs, strict=False)
    # the example inputs (zeros, and the weights in "args" mode) are not
    # part of the program: saved, they would be most of the file
    ep.example_inputs = None
    torch.export.save(ep, path)
    return ep


def export_renderer(params_c: NeRF, params_f: Optional[NeRF],
                    mcfg: ModelConfig, rcfg: RenderConfig, out_dir: str,
                    chunk: int = 32768,
                    mcfg_fine: Optional[ModelConfig] = None,
                    occ_grid=None,
                    platforms: Optional[Sequence[str]] = None,
                    fused_n_rays: Optional[int] = None,
                    weights_mode: str = "baked",
                    provenance: Optional[dict] = None) -> dict:
    """Export the render function and its weights into ``out_dir`` on the
    device of ``params_c``; returns the manifest.

    ``platforms``: the devices the artifact may run on; only the export
    device is possible, and naming another raises ``ValueError``.
    ``fused_n_rays``: also export the whole-batch module for this many rays
    rounded up to a chunk multiple (H * W serves fixed-size images in one
    call).  ``weights_mode``: ``"baked"`` keeps the weights inside the
    programs; ``"args"`` writes them to ``weights.pt`` and makes them the
    programs' first input, so retrained weights of the same shapes drop in
    without exporting again.  The occupancy grid is baked in both modes.
    """
    if weights_mode not in ("baked", "args"):
        raise ValueError(f"weights_mode must be baked|args: {weights_mode}")
    device = module_device(params_c)
    if platforms and any(p != device.type for p in platforms):
        raise ValueError(
            f"platforms {list(platforms)}: an artifact runs only on the "
            f"device it was exported on ({device.type})")
    rdim = ray_dim(rcfg)
    draws = draw_inputs(rcfg)
    os.makedirs(out_dir, exist_ok=True)

    fn: torch.nn.Module = build_chunk_fn(params_c, params_f, mcfg, rcfg,
                                         mcfg_fine, occ_grid)
    weights = None
    if weights_mode == "args":
        tensors = {**dict(fn.named_parameters()), **dict(fn.named_buffers())}
        weights = [tensors[n] for n in fn.weight_names()]
        torch.save([w.detach().cpu() for w in weights],
                   os.path.join(out_dir, WEIGHTS_FILE))
    wrap = WithWeights if weights is not None else (lambda f: f)
    _export(wrap(fn), *_example(fn, chunk, rdim, draws, device, weights),
            os.path.join(out_dir, MODULE_FILE))

    fused_total = None
    if fused_n_rays:
        fused_total = -(-int(fused_n_rays) // chunk) * chunk
        ffn = FusedFn(fn, fused_total, chunk)
        _export(wrap(ffn), *_example(ffn, fused_total, rdim, draws, device,
                                     weights),
                os.path.join(out_dir, MODULE_FUSED_FILE))

    manifest = {
        "format_version": FORMAT_VERSION,
        "torch_version": torch.__version__,
        "device": device.type,
        "platforms": [device.type],
        "chunk": chunk,
        "ray_dim": rdim,
        "use_viewdirs": rcfg.use_viewdirs,
        "output_keys": sorted(fn.keys),
        "mode": rcfg.mode,
        "n_samples": rcfg.n_samples,
        "n_importance": rcfg.n_importance,
        "perturb": rcfg.perturb,
        "occ_grid_embedded": occ_grid is not None,
        "fused_n_rays": fused_total,
        "weights_mode": weights_mode,
        "n_weight_leaves": len(weights) if weights is not None else 0,
        "draw_inputs": draws,
        "provenance": provenance or {},
    }
    with open(os.path.join(out_dir, MANIFEST_FILE), "w") as f:
        json.dump(manifest, f, indent=1)
    return manifest
