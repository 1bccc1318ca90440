"""Marching cubes (port of ``plnerf/mesh/marching_cubes.py``, the
replacement for the reference's PyMCubes ``mcubes.marching_cubes(u,
threshold)``, nerf_extract_mesh.py:581).

``marching_cubes_native`` runs ``_marching_cubes.cpp`` through ctypes.
The source is compiled with g++ at first use into ``build/plnerf_torch/``
at the repository root (beside the CUDA kernels of ``kernels/build.py``),
under a file name that carries a hash of the source; the build writes a
temporary file and renames it, so a build running in parallel never loads
a half-written library.  ``marching_cubes_numpy`` is the plain version of
the same algorithm, a Python loop over the active cubes.

Both return ``(verts [V, 3] float32, faces [F, 3] int32)``: verts in
grid-index coordinates (the caller rescales them to the world bbox), each
shared by the faces around it.

A deliberate difference from the JAX package: ``marching_cubes`` is the
native path and raises, with g++'s output, when the library does not
build, where the JAX function drops to its numpy fallback.  The numpy
version runs only when it is called by name.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from typing import Optional, Tuple

import numpy as np

from ..kernels import build as kbuild

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "_marching_cubes.cpp")
BUILD_DIR = kbuild.BUILD_DIR
CXX = "g++"
CXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> str:
    with open(SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"libmarching_cubes-{digest}.so")


def build() -> str:
    """Compile ``_marching_cubes.cpp`` unless its library exists; returns
    the library path.  Raises ``RuntimeError`` with the compiler's output
    when the build fails or the compiler is missing."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        try:
            proc = subprocess.run([CXX] + CXX_FLAGS + [SRC, "-o", tmp],
                                  capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(f"marching cubes: cannot run {CXX!r} to "
                               f"build {SRC}: {e}") from e
        if proc.returncode != 0:
            raise RuntimeError(f"marching cubes: {CXX} failed for "
                               f"{SRC}:\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            lib.mc_run.restype = ctypes.c_int
            lib.mc_run.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_float,
                ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
                ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.POINTER(ctypes.c_int)),
                ctypes.POINTER(ctypes.c_int),
            ]
            lib.mc_free.restype = None
            lib.mc_free.argtypes = [ctypes.POINTER(ctypes.c_float),
                                    ctypes.POINTER(ctypes.c_int)]
            _lib = lib
        return _lib


def _check_grid(grid: np.ndarray) -> np.ndarray:
    g = np.ascontiguousarray(grid, np.float32)
    if g.ndim != 3 or min(g.shape) < 2:
        raise ValueError(f"marching cubes takes a 3-D grid of at least "
                         f"2 points per axis, got shape {g.shape}")
    if g.size >= 2 ** 31:
        raise ValueError(f"grid of {g.size} points: the native code indexes "
                         "with 32-bit ints")
    return g


def marching_cubes_native(grid: np.ndarray, iso: float
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """The C++ path; builds the library at first use and raises when it
    cannot."""
    g = _check_grid(grid)
    lib = _load()
    nx, ny, nz = g.shape
    pv = ctypes.POINTER(ctypes.c_float)()
    pf = ctypes.POINTER(ctypes.c_int)()
    nv = ctypes.c_int(0)
    nf = ctypes.c_int(0)
    rc = lib.mc_run(g.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                    nx, ny, nz, ctypes.c_float(iso), ctypes.byref(pv),
                    ctypes.byref(nv), ctypes.byref(pf), ctypes.byref(nf))
    if rc != 0:
        raise MemoryError("mc_run allocation failed")
    try:
        verts = (np.ctypeslib.as_array(pv, (nv.value, 3)).copy()
                 if nv.value else np.zeros((0, 3), np.float32))
        faces = (np.ctypeslib.as_array(pf, (nf.value, 3)).copy()
                 if nf.value else np.zeros((0, 3), np.int32))
    finally:
        lib.mc_free(pv, pf)
    return verts.astype(np.float32), faces.astype(np.int32)


# the entry point: the native path, with no fallback
marching_cubes = marching_cubes_native


def marching_cubes_numpy(grid: np.ndarray, iso: float
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """The plain version: the cube indices vectorized, then a Python loop
    over the active cubes (those the surface crosses), vertices shared per
    grid edge.  Slow on large grids; the reference the native path is held
    against."""
    from ._mc_tables import TRI_TABLE

    corner_ofs = np.array(
        [[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
         [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]], np.int64)
    edge_corner = np.array(
        [[0, 1], [1, 2], [2, 3], [3, 0], [4, 5], [5, 6], [6, 7], [7, 4],
         [0, 4], [1, 5], [2, 6], [3, 7]], np.int64)

    g = _check_grid(grid)
    inside = g > iso
    ci = np.zeros(tuple(s - 1 for s in g.shape), np.int32)
    for c, (dx, dy, dz) in enumerate(corner_ofs):
        ci |= (inside[dx: dx + ci.shape[0], dy: dy + ci.shape[1],
                      dz: dz + ci.shape[2]].astype(np.int32) << c)
    xs, ys, zs = np.nonzero((ci != 0) & (ci != 255))

    verts: list = []
    faces: list = []
    vert_ids: dict = {}

    def edge_vertex(x, y, z, e):
        a, b = edge_corner[e]
        ax, ay, az = corner_ofs[a]
        bx, by, bz = corner_ofs[b]
        key = (x + min(ax, bx), y + min(ay, by), z + min(az, bz),
               0 if ax != bx else (1 if ay != by else 2))
        if key in vert_ids:
            return vert_ids[key]
        va = g[x + ax, y + ay, z + az]
        vb = g[x + bx, y + by, z + bz]
        t = 0.5 if vb == va else np.clip((iso - va) / (vb - va), 0.0, 1.0)
        vert_ids[key] = len(verts)
        verts.append((x + ax + t * (bx - ax), y + ay + t * (by - ay),
                      z + az + t * (bz - az)))
        return vert_ids[key]

    for x, y, z in zip(xs, ys, zs):
        tri = TRI_TABLE[ci[x, y, z]]
        for t in range(0, 16, 3):
            if tri[t] == -1:
                break
            faces.append((edge_vertex(x, y, z, tri[t]),
                          edge_vertex(x, y, z, tri[t + 1]),
                          edge_vertex(x, y, z, tri[t + 2])))

    return (np.asarray(verts, np.float32).reshape(-1, 3),
            np.asarray(faces, np.int32).reshape(-1, 3))
