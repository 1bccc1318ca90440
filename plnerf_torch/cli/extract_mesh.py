"""Mesh-extraction driver (port of ``plnerf/cli/extract_mesh.py``): a
trained checkpoint -> density grid -> marching cubes -> floater removal ->
PLY.

    python -m plnerf_torch.cli.extract_mesh --ckpt_dir C --expname E \\
        --data_dir D --scene_id S [--mesh_res 512] [--device cpu] ...

Reference: the nerf_extract_mesh.py driver (:758-1115): args.json of the
experiment reloaded, the GT mesh's bbox with a +-0.25 margin
(:1030-1051), the fine network at 512^3, ``mcubes.marching_cubes(u,
25)``, connected components of fewer than 10000 faces removed, the mesh
written to ``{mesh_outdir}/{scene_id}_{mode}_res{res}_thresh{thr:g}
_cleaned.ply``.

Runs on the CUDA device unless ``--device cpu`` is given, and raises
where there is none.  ``--use_kernel`` is AUTO as in ``run_plnerf``: on a
CUDA device the grid goes through the fp32 fused forward kernel
(``mesh/extract.py``); the JAX driver's grid runs the unfused XLA MLP.

Under ``torchrun --nproc_per_node N -m plnerf_torch.cli.extract_mesh
...`` each rank evaluates its own queries of the grid and rank 0 gathers
it, runs marching cubes and the filter and writes the PLY (the
counterpart of the JAX driver's sharded grid); the other ranks return
None.
"""
from __future__ import annotations

import os

import numpy as np

from ..device import resolve_device
from ..mesh import extract as MX
from ..parallel import mesh as pmesh
from .config import ConfigArgumentParser, add_base_flags, resolve_args
from .run_plnerf import (_resolve_kernel, build_configs, join_mesh,
                         restore_or_init)


def config_parser() -> ConfigArgumentParser:
    p = ConfigArgumentParser()
    add_base_flags(p)
    a = p.add_argument
    a("--mesh_res", type=int, default=512,
      help="density grid resolution per axis")
    a("--mesh_threshold", type=float, default=25.0,
      help="density iso threshold")
    a("--adaptive_iso", action="store_true",
      help="adaptive iso level from density statistics")
    a("--gt_mesh_path", type=str, default=None,
      help="GT mesh (.ply/.obj) whose bbox +-0.25 bounds the grid; "
           "default <data_dir>/nerf_meshes_reoriented/<scene_id>.obj")
    a("--bbox_min", type=float, nargs=3, default=None)
    a("--bbox_max", type=float, nargs=3, default=None)
    a("--min_component_faces", type=int, default=10000,
      help="floater-removal threshold (faces per connected component)")
    a("--mesh_outdir", type=str, default="extracted_meshes")
    a("--mesh_chunk", type=int, default=64 ** 3)
    return p


def _load_obj_vertices(path: str) -> np.ndarray:
    verts = []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                verts.append([float(x) for x in line.split()[1:4]])
    return np.asarray(verts, np.float32)


def resolve_bbox(args):
    """(bmin, bmax): ``--bbox_min`` / ``--bbox_max``, else the GT mesh's
    bbox with a 0.25 margin, else [-1.25, 1.25]^3."""
    if args.bbox_min is not None and args.bbox_max is not None:
        return (np.asarray(args.bbox_min, np.float32),
                np.asarray(args.bbox_max, np.float32))
    path = args.gt_mesh_path
    if path is None:
        path = os.path.join(args.data_dir, "nerf_meshes_reoriented",
                            args.scene_id + ".obj")
    if os.path.exists(path):
        if path.endswith(".ply"):
            verts, _ = MX.load_ply(path)
        else:
            verts = _load_obj_vertices(path)
        return verts.min(0) - 0.25, verts.max(0) + 0.25
    print(f"WARNING: no GT mesh at {path}; using default bbox [-1.25,1.25]^3")
    return (np.full(3, -1.25, np.float32), np.full(3, 1.25, np.float32))


def run(args, mesh=None):
    """Extract, clean and write the mesh; returns the PLY's path (None on
    a rank other than 0 of ``mesh``)."""
    device = resolve_device(args.device)
    _, _, setup = build_configs(args)
    state, start, path = restore_or_init(args, setup, device, mesh)
    if path is None:
        print("WARNING: extracting from an untrained network")
    net = (state.params_fine if state.params_fine is not None
           else state.params_coarse)

    bmin, bmax = resolve_bbox(args)
    print("bbox:", bmin, bmax)
    geometry = MX.extract_geometry(
        net, net.cfg, bmin, bmax, resolution=args.mesh_res,
        threshold=args.mesh_threshold, adaptive=args.adaptive_iso,
        chunk=args.mesh_chunk, use_kernel=_resolve_kernel(args, device),
        mesh=mesh)
    if geometry is None:
        return None
    verts, faces = geometry
    print(f"raw mesh: {verts.shape[0]} verts, {faces.shape[0]} faces")
    verts, faces = MX.filter_connected_components(
        verts, faces, min_len=args.min_component_faces)
    print(f"cleaned: {verts.shape[0]} verts, {faces.shape[0]} faces")

    os.makedirs(args.mesh_outdir, exist_ok=True)
    fname = (f"{args.scene_id}_{args.mode}_res{args.mesh_res}"
             f"_thresh{args.mesh_threshold:g}_cleaned.ply")
    out = os.path.join(args.mesh_outdir, fname)
    MX.export_ply(out, verts, faces)
    print("exported", out)
    return out


def main(argv=None):
    """Parse ``argv``; resolve the device before anything is read (raises
    without CUDA unless ``--device cpu``); join the process group under
    ``torchrun``; reload the experiment's args.json with the mesh flags and
    the eval overrides from the command line; run, printing from rank
    0."""
    args = config_parser().parse_args(argv)
    resolve_device(args.device)
    mesh = join_mesh(args)
    args.task = "mesh"
    with pmesh.main_stdout(mesh):
        return run(resolve_args(args), mesh)


if __name__ == "__main__":
    main()
