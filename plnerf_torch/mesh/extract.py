"""Mesh extraction (port of ``plnerf/mesh/extract.py``): the density grid
on the model's device -> marching cubes (native C++) -> connected-component
floater removal -> PLY export.

Behavioural reference: ``extract_fields`` / ``extract_iso_level`` /
``extract_geometry`` (nerf_extract_mesh.py:531-594) and the trimesh
cleanup and export of its driver (:1084-1106).

The grid: the three axes are ``np.linspace(bmin[d], bmax[d], res,
dtype=np.float32)``, as in the JAX function (``torch.linspace`` differs
from it by an ulp at some points).  Each chunk's points are formed on the
device from the axes by index arithmetic, in the ``ij`` order, so no
[res^3, 3] point array is built on the host; the density comes back to the
host once, as [res]^3 float32.  Every point is queried with the zero view
direction, embedded as it is (not normalised), and its density is
``relu(raw[..., 3])``, as in the JAX function, in fp32 whatever the
recipe's ``mlp_dtype``.  With ``use_kernel`` the weights are packed once
per grid and each chunk goes through ``kernels/fused_mlp.forward`` (on a
CUDA device the fp32 fused forward kernel, folded heads, as the drivers'
eval renders run it; on the CPU its plain version); without it, through
the unfused ``core/mlp.query_network``.  The JAX package's sharded grid
(``mesh=``) is not ported (ROADMAP A15).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core import encoding, mlp
from ..core.config import ModelConfig
from ..device import module_device
from ..kernels import fused_mlp
from .marching_cubes import marching_cubes


def _grid_points(axes, start: int, stop: int) -> torch.Tensor:
    """Points ``start:stop`` of the flattened ``ij`` meshgrid of ``axes``
    (three [res] tensors): [stop - start, 3]."""
    res = axes[0].shape[0]
    idx = torch.arange(start, stop, device=axes[0].device)
    return torch.stack([axes[0][idx // (res * res)],
                        axes[1][(idx // res) % res], axes[2][idx % res]], -1)


def _zero_views(mcfg: ModelConfig, n: int, device) -> Optional[torch.Tensor]:
    """The embedded zero view direction of ``n`` points, [n, 1, ch] (None
    without viewdirs)."""
    if not mcfg.use_viewdirs:
        return None
    return mlp.embed_views(torch.zeros(n, 3, device=device), (n, 1), mcfg)


def _kernel_density(model, mcfg: ModelConfig, chunk: int):
    """``density(pts)``: relu(sigma) of points [n <= chunk, 3] through the
    fused forward on weights packed once, per-point views (divisor 1)."""
    dev = module_device(model)
    ve = _zero_views(mcfg, 1, dev)
    vch = None if ve is None else ve.shape[-1]
    p = fused_mlp.pack_weights(model, mcfg, torch.float32, fold_heads=True,
                               vch=vch)
    v_all = None
    if ve is not None:
        v_all = F.pad(ve[:, 0], (0, p.v_p - vch)).expand(
            chunk, p.v_p).contiguous()

    def density(pts):
        pe = (pts if mcfg.i_embed == -1
              else encoding.embed(pts, mcfg.multires, mcfg.pi_bands))
        x = F.pad(pe, (0, p.in_p - p.in_ch)).contiguous()
        v = None if v_all is None else v_all[:pts.shape[0]]
        raw = mlp.softplus10_density(fused_mlp.forward(p, x, v, 1), mcfg)
        return F.relu(raw[:, 3])

    return density


def _unfused_density(model, mcfg: ModelConfig):
    def density(pts):
        views = (torch.zeros(pts.shape[0], 3, device=pts.device)
                 if mcfg.use_viewdirs else None)
        raw = mlp.query_network(model, pts[:, None, :], views, mcfg)
        return F.relu(raw[:, 0, 3])

    return density


def extract_density_grid(model, mcfg: ModelConfig, bound_min, bound_max,
                         resolution: int = 512, chunk: int = 64 ** 3,
                         use_kernel: bool = False) -> np.ndarray:
    """relu(sigma) of ``model`` on a resolution^3 grid over the bbox, on
    the model's device, ``chunk`` points per query; [res]^3 float32 on the
    host.  ``use_kernel``: the fused forward (see the module docstring); a
    final-layer skip, which it does not take, runs unfused."""
    dev = module_device(model)
    bmin = np.asarray(bound_min, np.float32)
    bmax = np.asarray(bound_max, np.float32)
    axes = [torch.as_tensor(np.linspace(bmin[d], bmax[d], resolution,
                                        dtype=np.float32), device=dev)
            for d in range(3)]
    n = resolution ** 3
    chunk = min(chunk, n)
    if use_kernel and (mcfg.netdepth - 1) not in mcfg.skips:
        density = _kernel_density(model, mcfg, chunk)
    else:
        density = _unfused_density(model, mcfg)
    sigma = torch.empty(n, dtype=torch.float32, device=dev)
    with torch.no_grad():
        for start in range(0, n, chunk):
            stop = min(start + chunk, n)
            sigma[start:stop] = density(_grid_points(axes, start, stop))
    return sigma.cpu().numpy().reshape(resolution, resolution, resolution)


def extract_iso_level(density: np.ndarray, threshold: float = 25.0) -> float:
    """Adaptive iso level (reference nerf_extract_mesh.py:564-573)."""
    min_a, max_a, std_a = density.min(), density.max(), density.std()
    return float(min(max(threshold, min_a + std_a), max_a - std_a))


def extract_geometry(model, mcfg: ModelConfig, bound_min, bound_max,
                     resolution: int = 512, threshold: float = 25.0,
                     adaptive: bool = False, chunk: int = 64 ** 3,
                     use_kernel: bool = False
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Density grid -> marching cubes -> verts scaled into the bbox
    (reference extract_geometry, nerf_extract_mesh.py:576-593)."""
    u = extract_density_grid(model, mcfg, bound_min, bound_max, resolution,
                             chunk, use_kernel)
    iso = extract_iso_level(u, threshold) if adaptive else threshold
    verts, faces = marching_cubes(u, iso)
    bmin = np.asarray(bound_min, np.float32)
    bmax = np.asarray(bound_max, np.float32)
    verts = verts / (resolution - 1.0) * (bmax - bmin)[None, :] + bmin[None, :]
    return verts.astype(np.float32), faces


def filter_connected_components(
    verts: np.ndarray, faces: np.ndarray, min_len: int = 10000
) -> Tuple[np.ndarray, np.ndarray]:
    """Keep only the face components of at least ``min_len`` faces, faces
    connected through shared edges (trimesh ``face_adjacency`` semantics,
    reference nerf_extract_mesh.py:1094-1100); vertices re-indexed.
    Vectorized: numpy grouping and ``scipy.sparse.csgraph``."""
    if faces.shape[0] == 0:
        return verts, faces
    n_faces = faces.shape[0]
    # every face edge as a sorted vertex pair, scalar-encoded, -> edge ids
    e = np.concatenate(
        [faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]], axis=0)
    e = np.sort(e, axis=1)
    face_of = np.tile(np.arange(n_faces), 3)
    ekey = e[:, 0].astype(np.int64) * (verts.shape[0] + 1) + e[:, 1]
    _, edge_id = np.unique(ekey, return_inverse=True)
    # faces sharing an edge id are chained in the sorted incidence order (a
    # chain per edge connects them all, non-manifold edges included)
    order = np.argsort(edge_id, kind="stable")
    eid_s, face_s = edge_id[order], face_of[order]
    same = eid_s[1:] == eid_s[:-1]
    rows, cols = face_s[:-1][same], face_s[1:][same]

    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    adj = coo_matrix((np.ones(rows.shape[0], np.int8), (rows, cols)),
                     shape=(n_faces, n_faces))
    _, labels = connected_components(adj, directed=False)
    counts = np.bincount(labels)
    faces = faces[counts[labels] >= min_len]
    used = np.unique(faces)
    remap = np.full(verts.shape[0], -1, np.int64)
    remap[used] = np.arange(used.shape[0])
    return verts[used], remap[faces].astype(np.int32)


def export_ply(path: str, verts: np.ndarray, faces: np.ndarray) -> None:
    """Binary little-endian PLY: float xyz per vertex, a uchar-counted int
    list per face (replaces trimesh's export)."""
    verts = np.asarray(verts, np.float32)
    faces = np.asarray(faces, np.int32)
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {verts.shape[0]}\n"
        "property float x\nproperty float y\nproperty float z\n"
        f"element face {faces.shape[0]}\n"
        "property list uchar int vertex_indices\nend_header\n")
    rows = np.concatenate(
        [np.full((faces.shape[0], 1), 3, np.uint8),
         faces.astype("<i4").view(np.uint8).reshape(faces.shape[0], 12)],
        axis=1)
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(verts.astype("<f4").tobytes())
        f.write(rows.tobytes())


def load_ply(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """PLY reader for GT-mesh bboxes and round trips: binary little-endian
    and ASCII, vertex xyz (further vertex properties skipped) and polygon
    faces (the first three indices kept)."""
    with open(path, "rb") as f:
        data = f.read()
    end = data.index(b"end_header\n") + len(b"end_header\n")
    n_vert = n_face = vert_props = 0
    fmt = "binary_little_endian"
    in_vertex = False
    for line in data[:end].decode("ascii").splitlines():
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            in_vertex = parts[1] == "vertex"
            if parts[1] == "vertex":
                n_vert = int(parts[2])
            elif parts[1] == "face":
                n_face = int(parts[2])
        elif parts[0] == "property" and in_vertex and parts[1] != "list":
            vert_props += 1
    if fmt == "ascii":
        rows = data[end:].decode("ascii").split()
        verts = np.array(rows[:n_vert * vert_props], np.float32)
        verts = verts.reshape(n_vert, vert_props)[:, :3]
        rest = rows[n_vert * vert_props:]
        faces, i = [], 0
        for _ in range(n_face):
            c = int(rest[i])
            faces.append([int(v) for v in rest[i + 1:i + 1 + c]][:3])
            i += 1 + c
        return verts, np.asarray(faces, np.int32).reshape(-1, 3)
    if fmt != "binary_little_endian":
        raise ValueError(f"{path}: PLY format {fmt} is not read")
    body = data[end:]
    verts = np.frombuffer(body, "<f4", count=n_vert * vert_props).reshape(
        n_vert, vert_props)[:, :3].copy()
    off = n_vert * vert_props * 4
    if len(body) >= off + 13 * n_face:
        # triangles only (what export_ply writes): fixed 13-byte rows
        rec = np.frombuffer(body, np.uint8, count=13 * n_face,
                            offset=off).reshape(n_face, 13)
        if (rec[:, 0] == 3).all():
            return verts, rec[:, 1:].copy().view("<i4").astype(np.int32)
    faces = np.zeros((n_face, 3), np.int32)
    for i in range(n_face):
        c = body[off]
        faces[i] = np.frombuffer(body, "<i4", count=3, offset=off + 1)
        off += 1 + 4 * c
    return verts, faces
